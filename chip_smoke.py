#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Runs from the root of a checkout and drives the port's main paths at the
flagship width (configs/pixel_diffusion_model_cifar10.yaml, random weights
from a seed), through their entry points: the class-conditional samplers
with classifier-free guidance (``ldm_tpu_torch.generate.main``: ancestral
DDPM, DDIM, DPM-Solver++(2M)) and the diffusion trainer
(``ldm_tpu_torch.train.run``); then serving, the protocol, consistency
distillation, the latent family, data parallelism, the reference's own
workflow with the checkpoint bridge, the model axis, the pipeline, the
real-data drill on the MNIST flagship, the optimizer's one pass and the
resolution axis at 64 and 128 px (phases 7b-7l).  Both run as they do
by default on a card: one sampler step and one train step captured into
CUDA graphs and replayed; the eager loops are timed beside them.  Phases, each printing its own lines; any
failure raises and exits nonzero:

1. device: a CUDA card or exit; its name and power limit; TF32 off.
2. build: nvcc builds the production sources of ldm_tpu_torch/csrc/ (not
   the probes'), one compiler per source, started together; each library's
   build seconds, ptxas registers, shared memory and spills per kernel;
   from cuobjdump's SASS, the tensor-core (HMMA, HGMMA) and atomic
   instructions of each linear-attention, ResNet-block and GroupNorm
   kernel: the bf16 kernels with a product must have the first, the fp32
   kernels none, and no kernel the second.
3. forward kernel vs plain: at the 8 attention sites of the 32px UNet at
   2B=20 and 2B=128, at the 64px and 128px sites at 2B=4, and at the two
   narrow sites of configs/smoke_synthetic.yaml ((256, 8) and (64, 16), the
   first zero-padded to 16 columns by the wrapper) at 2B=20, and the latent
   UNet's sites (16, 128) and (16, 64) at 2B=128 and 2B=256, and at the
   batches phase 7l runs: the 128px UNet's four sites ((16384, 64), (4096,
   128), (1024, 256), (256, 512)) at B=8 and 128, the 64px sites at B=64
   and 2B=128; fp32 (<= 1e-4)
   and bf16 (<= 3e-2 + one bf16 spacing of the output); then the edges at
   2B=20 and 21: N=16 at small and odd batches, the odd N that plan_fwd
   takes (96, 100, 384), true widths below the 16-column step (120, 56),
   and (1024, 64) and (16384, 64) at B=64; every case twice, bit for bit;
   each line names the path its plan took (persistent: teams walking work
   units; cluster: the item kept in shared memory; tiled: through global
   scratch) and the CTAs an item; timed at 2B=128 and 2B=256
   (the 8 sites and the latent UNet's (16, 64)) and at B=64 ((1024, 64),
   (16384, 64)) bf16, the kernel and the plain version alike by CUDA-graph
   replay (device time, no host in it), beside the bound from the shapes;
   (16384, 64) alone at B=8 and 128.
3b. the GroupNorm (+ SiLU) pass vs plain at every norm site of the pixel
   UNet, the latent UNet and the VAE (recorded from their forwards; 23 and
   11 calls a UNet forward) at 2B = 256, 128, 20 and B = 1, and the 64px
   UNet's two largest at B = 4 and 1: the norm within
   one bf16 spacing of the plain chain's (the spacing taken at no less than
   2^-6), the SiLU within one of F.silu of the kernel's own norm; reruns
   bit-identical, an item the same bits at another batch slot and size;
   timed at 2B=256 by CUDA-graph replay beside the bytes bound and the plain
   chain, with the pixel UNet's sampler step summed; then at every norm site
   of Stable Diffusion 2.1's U-Net (2B = 16, 96x96 latents) and of its
   decoder at 768 px (B = 8), each held against the plain chain and timed
   beside the bound and the chain, naming any shape where the pass is slower.
4. backward kernels vs plain: the 8 sites at B=64, the 64px sites at
   B=4 and B=64 (probe 39's train step), the 128px site (16384, 64) at B=2
   (the tiled path, 8 CTAs of 2,048 rows), the 128px UNet's four sites at
   B=8 and 128 (the ends of probe 43's sweep), the two narrow sites at B=8 and the latent sites at B=64, fp32 and bf16, each of the 8 grads within its stated tolerance, two
   launches bit-identical; timed at B=64 bf16 as the forward, and (16384,
   64) alone at B=2 (a correctness-check size), 8 and 128 bf16 beside its
   bound and the plain version.
5. full-width UNet: 20,350,915 parameters; kernel-path vs plain-path
   forward (fp32 <= 1e-3; the bf16 difference is printed) and loss
   gradients at B=8 (fp32: every grad within 1e-3 x its leaf's max; every
   to_qkv / to_out grad non-zero; the bf16 difference is printed); the same
   UNet's forward at 64px (the shape of configs/protocol_hard_64.yaml) at
   2B=4, kernel path vs plain path (fp32 <= 1e-3, bf16 finite).
6. the sampling slice: generate.main at T=400, CFG 3, B=10 (2B=20), bf16,
   as a replayed graph, from the flagship's seeded weights written where the
   trainer leaves its EMA weights; every kernel's count is set to 0 just before and
   read just after: the forward kernel must launch exactly 8 x (400 replayed
   steps + the 3 eager warm-up steps before the capture) times, the
   GroupNorm pass 23 x as many steps (one a GroupNorm module), the others
   not at all (a train step launches the GroupNorm pass never); uint8 (10, 32, 32, 3) images from a finite x0; then a DDIM-50
   and a DPM-Solver++-15 request at B=10 with the same count rule, and
   configs/smoke_synthetic.yaml (attention at C = 8 and C = 16) through
   generate.main, graphed against ``--eager``; fp32 10-step trajectories at
   B=2: ancestral (injected x_T, the injected noise through the graph's
   fixed buffer) graphed vs eager vs the plain path, DDIM eta=0 and
   DPM-Solver++ graphed vs eager (each <= 1e-3); ms/step of 20 sampler steps
   at B=64 and at B=10, graphed and eager (median of 5 runs each, every run
   printed), beside the device's time for one replay.
7. the training slice: train.run for 3 epochs of 9 steps at B=64, bf16, on
   the synthetic fallback data (3 eager warm-up steps, 24 replayed), with
   the T=400 sample grid at epoch 2; the backward kernels must launch
   exactly 8 x (train steps) times (all counts set to 0 before, read after,
   again around one replayed train step: 8 forward + 8 backward); finite
   losses, the last epoch's below the first's; checkpoint and metrics files;
   a --resume run restores the step and a capturable Adam's state and
   trains on through a new capture; a graphed and an eager fp32 trainer from
   the same state and the same injected t / eps / drop: the losses of 8
   steps (5 replayed) within 1e-3 and the to_qkv / to_out.0 weights moved
   alike; after the replays an eager eval_step on the kernel path equals the
   plain-path model loaded from the same state_dict (1e-3: the kernel weight
   copies are not stale); one epoch of configs/smoke_synthetic.yaml (the
   backward kernels at C = 8); ms/step of the train step at B=64 graphed and
   eager (median of 5 runs of 10 steps, every run printed) beside the
   device's time for one replay.  train.run takes the device-resident epoch
   (``training/scan_epochs.py``: the dataset on the card, the batch gathered
   inside the replayed step); one epoch through it gives losses and weights
   bit-identical to the per-batch loop fed the same permutation; host
   ms/step of both epoch paths (median of 5 epochs of 9 steps) beside the
   device's ms a replay of each.
7b. the serving slice: ``serving.builder.build_generation_service`` over the
   flagship's random weights written as a state_dict, B=64, CFG 3, bf16, the
   native slot queue (asserted), DDIM-50: a 10-image request alone and again
   under 16 concurrent clients, bit-identical, and equal bit for bit to
   ``sample_ddim`` at B=64 on the same x_T in the same slots; the same
   request through ``POST /generate`` (npy) on 127.0.0.1; 2,048 images from 8
   client threads (img/s, padded share, latency p50 / p95, the batcher's
   host ms a batch beside the device's, and the device's ms a served batch
   and busy share from CUDA events around each batch's sampler) and ten
   1-image requests one at a time (p50); ``stop()`` resolves every future
   it drains; the forward kernel launched 8 x (50 x batches + 3 warm-up
   steps) times, no other.  Then DPM-Solver++-15 saturated the same way.
   A repeated ``sample_ddim`` / ``sample_dpmpp`` call at B=64 makes no host
   sync (``torch.cuda.set_sync_debug_mode("error")``).
7c. the protocol slice: ``ldm_tpu_torch.main.main`` (the five-mix
   augmentation protocol) for both generator families at full width, bf16,
   CFG 3, ``--negative-control``: the flagship pixel DDPM and
   configs/protocol_flow_hard.yaml (rectified flow), each on 2,560 synthetic
   CIFAR-10-shaped images (1,152 generator-train images: 18 steps of 64),
   1 generator epoch, 2 classifier epochs of ResNet-18, 32 images a class,
   Phase C in chunks of 128 (2B=256) with the family's sampler (ancestral
   T=400; Heun-25).  Counts set to 0 before each run and read after: the
   forward kernel 8 a train step and 8 x 2 a validation batch in Phase A,
   8 (Heun: 16) a sampler step and warm-up step in Phase C, the backward
   kernel 8 a train step, none in the classifier's phases.  Printed: wall
   seconds by phase, launches by phase, Phase C img/s and the device's ms a
   sampler step, the F1s and FIDs (no quality assertion: one epoch on
   synthetic data).  Checks: Phase C's first chunk again from the same state
   and generator, bit-identical; exp2 retrained twice, the protocol's F1
   both times and weights and BatchNorm buffers bit-identical; the graphed
   classifier step against the eager one over 8 steps (fp32, 1e-3);
   host ms a classifier step graphed and eager beside the device's ms a
   replay (B=64, ResNet-18, bf16), under cuDNN's deterministic algorithms
   and under its defaults (where two runs under the defaults differ, the
   first parameter that differs is named); a 10-step Heun trajectory,
   kernel path against plain path and graphed against eager (fp32, 1e-3);
   the graphed flow train step against the eager one (phase 7's check with
   the flow's draws).
7d. consistency distillation at the flagship width: ``distill.main`` for 1
   epoch of 9 steps at B=64, bf16, from the seeded flagship weights as the
   teacher (3 eager steps, 6 replayed); counts set to 0 before and read
   after: the forward kernel 24 and the backward 8 a step (the teacher's
   2B CFG pass, the EMA target, the student), plus the 2-step sample grid's
   8 x (2 + 3 warm-up); one replayed step alone 24 / 8; host ms a step
   graphed and eager (median of 5 epochs) beside the device's ms a replay;
   ``generate.main --sampler consistency`` at 1, 2 and 4 steps, B=10: 8 x
   (steps + 3 warm-up) forward launches, the kernel seeing batches of 10
   only (no CFG pass); the consistency-2 service at B=64: a 10-image
   request alone, under 16 clients and through HTTP, bit-identical, and
   equal to ``sample_consistency`` on the same slot generators; saturated
   img/s; then a graphed and an eager fp32 distillation trainer fed the
   same batches and n / eps for 8 steps (losses within 1e-3), after which
   the EMA target on the kernel path equals the plain-path model loaded
   from the EMA's state_dict (1e-3) and the teacher kept its kernel weight
   copies and its output.
7e. the latent family at the configs' full width: ``train_autoencoder.run``
   (configs/autoencoder_hard.yaml) for 2 epochs of 9 steps at B=64, bf16
   (no kernel launches: the VAE has none of its own), ``autoencoder.pt``
   written; ``train_latent.run`` (configs/latent_diffusion_hard.yaml) from
   it, its ``ae_checkpoint`` naming the ``.msgpack`` of the same stem, for
   2 epochs: 2 forward and 2 backward launches a step and 2 x 2 a
   validation batch, ``latent_scaling.json`` written; one replayed step 2 /
   2; host ms a train step graphed and eager beside the device's; the T=1000
   ancestral CFG sample at B=10 through the trainer, 2 x (1000 + 3) forward
   launches graphed and 2 x 1000 eager; an fp32 T=1000 latent trajectory
   graphed vs eager on injected draws (1e-3); the latent sampler step's
   host ms graphed and eager at B=64; the VAE decode's device ms at B=64 and
   the decoder convolutions whose bf16 algorithm made an image depend on
   its batch slot (computed in fp32); ``type: latent`` served with DDIM-50 at
   B=64 (bit-identical alone, under load and through HTTP); then
   ``main.main`` on configs/protocol_hard_latent.yaml with
   ``--generator-config`` the latent config (its VAE the one trained
   above) and ``--negative-control`` at 2,560 images: wall seconds and
   launches by phase (exact), F1s and FIDs, Phase C's first chunk rerun
   bit for bit.
7f. data parallelism and FSDP (``ldm_tpu_torch/parallel/``): (a) over a NCCL
   group of this process alone, ``DiffusionTrainer(mesh=create_mesh())`` at
   the flagship width, graphed, with ``param_sharding`` replicated, fsdp
   (JAX's rule shards nothing at N = 1) and fsdp under the placements N = 2
   would give (FSDP2's DTensors, all-gathers and reduce-scatter on the
   card), against the one-process trainer from the same weights, batches
   and draws: 8 fp32 steps (5 replayed, cuDNN's deterministic algorithms),
   losses and attention weights within 1e-6, 8 + 8 launches a replayed step;
   host ms a step graphed and eager and the device's ms a replay at B=64
   bf16 beside the one-process step's; ``train.main([cfg, "--mesh"])`` for
   2 epochs of 9 steps (one metrics record an epoch, the checkpoints);
   (b) two processes on the one card over gloo (``--mesh-worker``; eager by
   design), DP at global B=64 for 6 fp32 steps against one process on the
   same global batches and draws (losses rtol 1e-5, parameters atol 5e-3),
   and ResNet-18's BatchNorm statistics after 4 steps at lr 0 (1e-6); the
   gloo step's host ms; (c) the DDIM-50 service at B=64 over two replicas on
   cuda:0 against a one-device service at the replicas' batch, bit for bit
   alone and under load (the service's contract is per device batch), the
   launches exact, and how far it lands from the one-device service at B=64
   (printed: cuDNN picks a conv's bf16 algorithm by batch size).
7g. the reference's own workflow at the flagship width, bf16, graphed: (a)
   ``train.main([cfg, "--profile", DIR])`` for 2 epochs of 9 steps at B=64 on
   the synthetic fallback: the backward kernel 8 a step, the Chrome trace
   holding the card's events, its 5 largest printed; (b) ``generate.main``
   with DDIM-50, ``--per-class 32`` (B=320) and no ``--weights``, from (a)'s
   ``diffusion_model_ema.pt``: the forward kernel 8 x (steps + warm-up), 320
   PNGs under ``<results>/<class>/`` that ``load_image_folder`` reads back
   bit for bit; the default request equals ``--weights
   diffusion_model_ema.pt``, ``--no-ema`` equals ``--weights
   diffusion_model.pt``, a run directory without weights raises; (c)
   ``train_classifier.main([cfg2, "--pretrain-dir", tree])`` (ResNet-18,
   B=64, 2 epochs): 320 // 64 = 5 pretrain steps, no attention launch, the
   F1 line, wall seconds of pretrain, train and test; (d) the bridge: the
   run's EMA exported and imported into a fresh run directory gives the
   DDIM-50 request at B=10 bit for bit, the classifier exported and imported
   the same test F1, phase 7e's VAE the same tensors; the phase's seconds by
   stage, within 60.
7h. the mesh's model axis (``parallel/tp.py``, ``parallel/sp_explicit.py``)
   at the flagship width, fp32: (a) two processes on the one card over gloo
   (``--axis-worker``; eager by design) as a (data=1, model=2) mesh, for
   ``param_sharding`` tp and fsdp_tp and ``activation_sharding`` spatial, 6
   steps at global B=64 against one process on the same batches and draws
   (the model axis's plain per-head attention; losses rtol 1e-5, parameters
   atol 5e-3), no attention kernel launched, each process's parameter bytes
   against the rule's arithmetic, host ms a step beside phase 7f's gloo DP
   step; (b) the DDIM-50 request at B=10 from the same EMA weights and x_T
   under tp and spatial against one process (1e-3); (c) tp at model = 1
   over a NCCL group of this process alone, graphed: bit for bit the
   one-process step over 8 steps, 8 + 8 launches a replayed step; (d) the
   phase within 120 s.
7i. pipeline parallelism (``parallel/pp.py``) at the flagship width: (a)
   one process, bf16, the kernel path, 2B=128: ``decode(*encode(...))`` is
   ``forward`` bit for bit, ``decode`` on the unpacked payload is ``decode``
   on the packed tensors bit for bit, the staged pass launches the forward
   kernel 8 times; (b) two processes on the one card over gloo
   (``--pp-worker``; eager by design) as a (data=1, model=2) pipeline, fp32,
   each holding its stage (62,785,536 and 18,618,124 parameter bytes): 6
   steps of the trainer's loss and Adam at global B=64 with M = 2 and M = 4
   microbatches against one process running the whole UNet through the same
   recipe on the same batches and draws, the kernels in both (losses and
   gradient norms rtol 1e-5, parameters gathered atol 5e-3), 4 M forward
   and 4 M backward launches a step on each process, a payload transfer's
   bytes and host ms a step beside phases 7f's and 7h's gloo steps; (c) the
   DDIM-50 request at B=10 (M = 2) through ``make_pp_apply`` from the same
   weights and x_T within 1e-3 of one process, 4 M forward launches a step;
   (d) the phase within 60 s.
7j. the real-data drill: raw MNIST files in the full IDX format, made from
   a seed under a temporary ``data_path`` (2,560 training and 512 test
   28x28 images; the test labels gzipped), and
   configs/pixel_diffusion_model_mnist.yaml at full width (64 channels,
   1/2/4/8, one input channel, T=400, CFG 3, bf16) with the run directory,
   1 epoch and that ``data_path`` written beside them; ``main.main`` with
   ``--strict-data --wandb``, 32 images a class by DDIM-50 and 2 classifier
   epochs, a recording ``wandb`` module in ``sys.modules``: the UNet's
   parameters printed; the datasets named MNIST with the files' counts (half
   the training images in the generator's half, 512 test images, 32x32x1
   after the resize); exp1-exp5 and finite FIDs; one ``wandb.init`` with the
   config's project (offline unless ``WANDB_MODE`` says otherwise) and Phase
   A's train losses at their steps, as ``metrics.jsonl`` has them; the
   attention launches by phase exactly (``protocol_launches``: Phase A 8
   forward + 8 backward a train step and 16 a validation batch, Phase C 8 x
   (chunks x 50 + warm-up), the classifier's phases none); wall seconds by
   phase and Phase C's img/s; then the files removed and the same argv
   raises ``FileNotFoundError`` with no launch and no device memory taken;
   the phase within its budget.
7k. the optimizer's one pass (``ops/fused_adam_ema.py``, the port of the
   JAX package's ``fused_apply_gradients``: Adam and the EMA of every leaf
   in one launch): its edges (more leaves than a launch takes, leaves of 1
   to 9,000 elements, misaligned ones, ones without a gradient) bit for bit
   against the plain version; at the flagship width, 200 leaves, 20,350,915
   parameters: (a) the kernel against its plain version over 3 chained steps from the
   gradients of real train steps at B=64, with and without the EMA, p, m,
   v and ema within 1e-6; a rerun bit-identical, and bit-identical to the
   trainer's own 3 updates; (b) a trainer replaying its captured step
   against an eager one from the same weights, batches and draws (cuDNN
   deterministic; 3 eager and 3 replayed steps): p, m, v, ema, Adam's step
   counts and the step counter bit for bit; (c) by CUDA-graph replay the
   kernel (with and without the EMA), its bound (36 and 28 bytes a
   parameter at 3.35 TB/s), the plain version, and two yardsticks on the
   same tensors that the port never calls: torch's capturable foreach Adam
   with a per-leaf EMA (the update before this kernel) and
   ``torch.optim.Adam(fused=True)`` with ``torch._foreach_lerp_``; (d) the
   train step's device ms a replay with this pass and with the foreach
   update, two trainers read in turns.  Every train step of every phase
   launches the kernel once (the counts of phases 7-7j and 12 hold it).
7l. the resolution axis (``perf/probe43_128px_device.py``,
   ``probe39_res64.py``, ``probe39b_res64_resume.py``,
   ``probe41_sp_resolution.py``, the ports of the JAX probes) at the
   flagship width, bf16, seed 0, the counts set to 0 before each and read
   after: (a) probe 43's sweep, the 128 px train step (T=1000, the replayed
   graph with the one-pass update) at B = 8, 16, 32, 64, 128 until one does
   not fit, then that B with ``torch.utils.checkpoint`` around the UNet's
   forward: every row printed (peak allocated and reserved bytes, cold and
   warm step, the device's ms a replay, loss, launches), B = 8-64 fitting
   without the recompute, finite losses, exactly 8 forward + 8 backward
   attention launches and one Adam + EMA pass a step (16 forward with the
   recompute); the recompute against the plain step at B=8 under cuDNN's
   deterministic algorithms, 5 steps (the last replayed): losses and every
   gradient within 1e-3 x the leaf's max, whether bit for bit printed; (b)
   probe 39 at 64 px on configs/protocol_hard_64.yaml cut to 2,560 images, 1
   diffusion and 1 classifier epoch, 128 images a sampler: launches by phase
   exact (Phase A 8 + 8 a train step and 16 a validation batch, the
   classifier none, Phase C 8 x (steps x batches + 3 warm-up)), the FIDs
   finite and printed, img/s of both samplers; (c) probe 39b on (b)'s run
   directory: Phase C's DDPM-400 and DDIM-50 images (b)'s bit for bit; (d)
   probe 41 over two gloo processes on cuda:0 at 32, 64 and 128 px
   (dp2_B2, sp2_B2, sp2_B1): each process's peak bytes, the step's seconds
   and the ratios printed, 8 + 8 attention launches a DP step and none an
   SP step, and at 64 px in fp32 the dp2_B2 and sp2_B2 gradients within
   rtol 2e-4 / atol 1e-6 (the plain attention on both sides).
8. the fused ResNet-block kernel (``ops/resnet_block.py``) vs plain: at
   the 11 ResNet sites of the 32px flagship UNet at 2B=20 and 2B=128, at
   probe 13's four sites at 2B=256, at the 64px (4096, 64->64) site at
   2B=4, at the 2x2 site at 2B=2 and the 4x4 site at 2B=3 (fewer pixels
   than one tile, an odd count) and at (8x8, 40->24) at 2B=5 (a C_out that
   is no multiple of the column tile); fp32 (<= 1e-4 x max|plain|) and bf16
   (<= 2e-2 x max|plain|); two launches bit-identical; each line names the
   plan it took (tiles, CTAs sharing a tile in conv1 / conv2, CTAs, shared
   memory); both timed at 2B=128 and 2B=20 bf16 by CUDA-graph replay,
   summed over the 11 sites, beside the block's products alone as cuDNN
   convolutions (a yardstick the port never calls).  Then ``ResNetBlockFn``
   at B=8 on a decoder site: its input and weight gradients against plain
   autograd, and the kernel launched.
9. the probes' two libraries (resnet_block_probe.cu,
   linear_attention_fwd_probe.cu) built and read as in phase 2; then the
   probes' entry points, each one's launches counted from 0:
   ``perf.probe13.main`` (the kernel launched at each of its sites),
   ``perf.probe13b.main`` (every mode vs its plain version; ``full`` bit
   for bit the production kernel) and ``perf.probe7.main`` (stages 1-5 vs
   plain, stage 6 bit for bit the production forward kernel).
10. with ``--parent DIR`` (another commit's tree, unpacked): that tree's
   linear-attention and ResNet-block kernels and this one's timed in turns
   (``perf.compare_parent``); skipped, and said so, without it.
11. one JSON line of per-kernel results (each with its launches on the main
   paths, its time, the plain version's and its bound) and the three
   headline paths' host ms/step graphed and eager beside the device's ms a
   replay.
12. the port's bench (``ldm_tpu_torch.bench``) in quick mode, in this
   process on cuda:0: its one JSON line printed, no ``errors`` in it; its
   ``value`` (img/s, B=64, T=1000) within 10% of 64 / (1000 x phase 6's
   device ms a B=64 replay) and ``train_steps_per_sec`` within 10% of 1000 /
   phase 7's graphed host ms a step; ``mfu`` the FLOP count (counted again
   here, over the plain path) at that rate over 989 TFLOP/s to 1e-6, it and
   ``train_mfu`` in (0, 1); a timed sampler run launched the forward kernel
   exactly 8 x 1000 times and a timed train step 8 + 8; the phase within
   60 s.  Then the script's wall time, the card's line, and last
   ``{"ok": true, "device": {...}}``.

No CPU fallback: without a card it exits nonzero before printing a result.
"""

from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import dataclasses
import glob
import gzip
import io
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ldm_tpu_torch import (
    bench,
    distill,
    export_torch_checkpoint,
    generate,
    import_torch_checkpoint,
    main as protocol_main,
    train,
    train_autoencoder,
    train_classifier,
    train_latent,
)
from ldm_tpu_torch.data.transforms import reverse_transform, scale_to_minus_one_one
from ldm_tpu_torch.data.datasets import synthetic_dataset
from ldm_tpu_torch.data.loader import DataLoader, create_dataloaders
from ldm_tpu_torch.diffusion.consistency import (
    consistency_fn,
    sample_consistency,
    sampling_timesteps,
)
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.experiments import augmentation as aug
from ldm_tpu_torch.factory import build_classifier, build_diffusion, build_model, load_config
from ldm_tpu_torch.models import unet as unet_module
from ldm_tpu_torch.ops import build, launch_counts
from ldm_tpu_torch.ops import fused_adam_ema as fa
from ldm_tpu_torch.ops import group_norm as gn
from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.ops import resnet_block as rb
from ldm_tpu_torch.perf import compare_parent, flops, probe7, probe13, probe13b
from ldm_tpu_torch.perf import probe39_res64 as p39
from ldm_tpu_torch.perf import probe39b_res64_resume as p39b
from ldm_tpu_torch.perf import probe41_sp_resolution as p41
from ldm_tpu_torch.perf import probe43_128px_device as p43
from ldm_tpu_torch.perf.common import card, cuda_graph_ms
from ldm_tpu_torch.serving import GenerationHTTPServer
from ldm_tpu_torch.serving.builder import build_generation_service, checkpoint_path, load_sampler
from ldm_tpu_torch.serving.service import slot_x_init
from ldm_tpu_torch.training.consistency_trainer import ConsistencyDistillTrainer
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.latent_trainer import build_ldm, load_latent_scaling
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer
from ldm_tpu_torch.training.state import ema_decay_tensor, step_generator
from ldm_tpu_torch.utils import launches as registry
from ldm_tpu_torch.utils.graphs import WARMUP_STEPS
from ldm_tpu_torch.utils.images import load_image_folder
from ldm_tpu_torch.utils.logging import global_norm

FLAGSHIP = "configs/pixel_diffusion_model_cifar10.yaml"
SMOKE = "configs/smoke_synthetic.yaml"  # channels 8, multipliers [1, 2], 16px, T=8
N_PARAMS = 20_350_915
# (site, N, C) of the 8 linear-attention blocks of the 32px flagship UNet
SITES = [("enc0", 1024, 64), ("enc1", 256, 128), ("enc2", 64, 256),
         ("enc3", 16, 512), ("dec0", 16, 256), ("dec1", 64, 128),
         ("dec2", 256, 64), ("dec3", 1024, 64)]
# the 64px UNet's sites and the largest 128px one, checked at 2B=4
LARGE_SITES = [("64px-l0", 4096, 64), ("64px-l1", 1024, 128), ("64px-l2", 256, 256),
               ("64px-l3", 64, 512), ("128px-l0", 16384, 64)]
BWD_128PX_B = 2  # the backward at the 128px site at a correctness-check size
# the batches phase 7l runs these sites at, checked and timed here too:
# probe 43's 128px step and its recompute at B = 8 ... 128 (the forward and
# the backward at B; the backward's split-K dWqkv and its scratch grow with
# B*N), probe 39's 64px train step at B=64 and its samplers at 2B=128
PATH_128PX_B = (8, 128)
# the 128px UNet's four attention sites (l0 is LARGE_SITES' last)
SITES_128PX = [LARGE_SITES[4], ("128px-l1", 4096, 128), ("128px-l2", 1024, 256),
               ("128px-l3", 256, 512)]
PATH_64PX_B = {"fwd": (64, 128), "bwd": (64,)}
# the attention sites of configs/smoke_synthetic.yaml: narrower than the
# kernels' 16-column step (the wrapper zero-pads the first) and at it
NARROW_SITES = [("smoke-l0", 256, 8), ("smoke-l1", 64, 16)]
# GroupNorm calls a forward (models/unet.py::group_norm_calls; phase 3b
# records them from the forwards): the flagship UNet's (at 32 and 64 px), a
# latent UNet's, the VAE's encoder's and decoder's.  Outside autograd in bf16
# each is one launch of the GroupNorm pass; a train step's own forward none
GN_PIXEL, GN_LATENT, GN_VAE_ENC, GN_VAE_DEC = 23, 11, 22, 30
# the latent UNet's sites: configs/latent_diffusion_hard.yaml's 4x4 latents
# at its 128 channels (both blocks), and the same grid at 64 channels
LATENT_SITES = [("latent-c128", 16, 128), ("latent-c64", 16, 64)]
# the forward's edges, at 2B=20 and an odd batch: N that splits unevenly
# into tiles (96, 100 rows a CTA; 384: 4 CTAs of 96) and true widths below
# the kernels' 16-column step on the persistent path
EDGE_SITES = [("odd-96", 96, 64), ("odd-100", 100, 64), ("odd-384", 384, 64),
              ("ctrue-120", 64, 120), ("ctrue-56", 1024, 56)]
EDGE_B = (20, 21)
# the shapes the forward is timed at beside 2B=128: the samplers' 2B=256
# (the 8 sites and the latent UNet's), and B=64 at (1024, 64) and (16384, 64)
TIME_256 = SITES + [LATENT_SITES[1]]
TIME_B64 = [SITES[0], LARGE_SITES[4]]
# |kernel - plain| <= atol + rtol * |plain|.  fp32: summation order only.
# bf16: 3e-2 as tests/test_linear_attention_op.py allows, plus one bf16
# spacing of the output (2^-7 |y|): y itself is bf16, spaced 2^-5 = 3.1e-2
# in [4, 8), so a sum that rounds to the neighbouring value is one spacing off
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 2.0**-7)}
UNET_FP32_TOL = 1e-3
# backward, per grad: |kernel - plain| <= tol * max|plain|.  fp32: the sums
# run in another order (weight grads over up to 65,536 rows at B=64,
# N=1024); the JAX suite holds its backward kernel to 2e-5 of the same
# scale.  bf16: both round every intermediate to bf16 at the same points,
# but an fp32 sum in another order can round an intermediate (q, k, v, do,
# dq, dk, dv, h) to the neighbouring bf16 value, 2^-8 of it, and dx is
# itself bf16: 2e-2 is five bf16 spacings at the largest entry.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRADS = ("dx", "dwqkv", "dwout", "dbout", "dg1s", "dg1b", "dg2s", "dg2b")
TRAIN_B = 64
# the synthetic fallback's train split is (1 - val_split) of it: 9 steps of 64
SYNTHETIC_SIZE = 640
T_STEPS = 400
DEV = torch.device("cuda")
# the H100's published peaks (SXM, dense, at its full 700 W): the bounds' rates
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
# (site, side, C_in, C_out) of the 11 ResNet blocks of the 32px flagship UNet;
# the head block has no time MLP (zero time rows)
RB_SITES = probe13.UNET_SITES
# fewer pixels than one 128-row tile (2B=2 at 2x2: 8; 2B=3 at 4x4: 48, an odd
# batch) and a C_out that is no multiple of the 64-column tile
RB_EDGE_CASES = [(2, RB_SITES[4]), (3, RB_SITES[3]), (5, ("ragged", 8, 40, 24))]
# |kernel - plain| <= tol x max|plain|.  fp32: summation order only, over up
# to 9 x 768 products.  bf16: the kernel rounds at the TPU kernel's points
# (SiLU in fp32, conv2 + bias + shortcut in fp32), the plain version at the
# XLA path's (SiLU in bf16, each conv output in bf16), a few bf16 spacings.
RB_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the serving phase: the service's one batch size, and the request held
# alone, under load, through HTTP and against sample_ddim
SERVE_B = 64
REF_CLASSES, REF_SEED = list(range(10)), 1234
# the protocol phase: both generator families, their overrides of the
# configs (written to a temporary config), and the main entry point's flags
FLOW = "configs/protocol_flow_hard.yaml"
PROTOCOL = {"pixel": FLAGSHIP, "flow": FLOW}
PROTOCOL_SIZE, PROTOCOL_PER_CLASS, PROTOCOL_CLF_EPOCHS, SAMPLE_B = 2560, 32, 2, 128
PROTOCOL_EXPS = [name for name, _, _ in aug.EXPERIMENTS] + ["exp2_broken"]
# the consistency and latent phases: the configs at their full width
AE_CONFIG = "configs/autoencoder_hard.yaml"
LATENT_CONFIG = "configs/latent_diffusion_hard.yaml"
PROTOCOL_LATENT = "configs/protocol_hard_latent.yaml"
CONSISTENCY_STEPS = (1, 2, 4)
DISTILL_FWD, DISTILL_BWD = 24, 8  # a distill step: teacher 2B, EMA target, student; backward


# the launches counted (utils/launches.py), by the kernel's name in the
# result: every hand-written kernel's and the two probes'
COUNTED = (*launch_counts(), probe13b.LIB.name, probe7.LIB.name)
# the kernels neither main path runs (the ResNet block is wired into no UNet)
OFF_PATH = ("resnet_block_fwd", probe13b.LIB.name, probe7.LIB.name)


def zero_counts() -> None:
    registry.restore({})


def check_persistent(launches: int, b: int, sites, what: str) -> dict:
    """The forward's launches on the persistent path since the last
    :func:`zero_counts`, after ``launches`` bf16 forward launches of a UNet
    whose attention sites are ``sites``, each at batch ``b``: as many as the
    plan sends down the persistent path, those sites a step.  Names the
    sites that keep the cluster or tiled path."""
    plans = [(site, la.plan_fwd(n, c, torch.bfloat16, b)) for site, n, c in sites]
    kept = [f"{site} {plan.path}" for site, plan in plans if plan.path != "persistent"]
    want = launches // len(sites) * (len(sites) - len(kept))
    got = registry.read(la.PERSISTENT)
    print(f"{what}: {got} of {launches} forward launches on the persistent path (want "
          f"{want}: {len(sites) - len(kept)} of {len(sites)} a step; {', '.join(kept) or 'none'} "
          f"on another path at batch {b})")
    if launches % len(sites) or got != want:
        raise AssertionError(f"{what}: {got} persistent of {launches} launches, want {want}")
    return {"persistent": got, "launches": launches, "other_path": kept}


def read_counts() -> dict:
    return {name: registry.read(name) for name in COUNTED}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def host_ms(run, steps: int, runs: int = 5) -> list:
    """Host-clock ms a step of ``run()`` (``steps`` steps), from a device
    sync to a device sync, ``runs`` times.  The host's clock varies from run
    to run on a shared machine: callers print every run and the median."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    return out


def path_line(name: str, graphed: list, eager: list, device_ms: float, tag: str) -> dict:
    """One headline path: host ms/step graphed and eager (every run, the
    medians) beside the device's ms for one replay; the graphed median must
    be below the eager one."""
    g, e = float(np.median(graphed)), float(np.median(eager))
    print(f"{name}: host {g:.3f} ms/step as a replayed graph (runs "
          f"{' '.join(f'{r:.3f}' for r in graphed)}), {e:.3f} ms/step eager (runs "
          f"{' '.join(f'{r:.3f}' for r in eager)}), device {device_ms:.3f} ms a replay; host / "
          f"device {g / device_ms:.3f} graphed, {e / device_ms:.3f} eager [{tag}]")
    if not g < e:
        raise AssertionError(f"{name}: graphed {g} ms/step is not below eager {e}")
    return {"graphed_ms": g, "eager_ms": e, "device_ms": device_ms,
            "graphed_runs": graphed, "eager_runs": eager}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over its memory rate,
    or its operations over its bf16 tensor-core rate, whichever is longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bound_bytes": nbytes, "bound_flops": flops}


def add_bounds(*bounds: dict) -> dict:
    """The bound of several launches in a row: times, bytes and operations add."""
    nbytes = sum(b["bound_bytes"] for b in bounds)
    flops = sum(b["bound_flops"] for b in bounds)
    ms = sum(b["bound_ms"] for b in bounds)
    by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_BF16 else "operations"
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": nbytes, "bound_flops": flops}


def la_bound(b: int, n: int, c: int, backward: bool) -> dict:
    """The linear-attention block's bound at (B, N, C) in bf16.  Bytes: x in
    and y out (backward: x and dy in, dx out) in bf16, the fp32 parameters in
    (backward: their grads out too).  Operations: the products alone, 2 per
    multiply-add: h @ Wqkv, the four 32x32 blocks of k^T v, ctx @ Wout and
    q @ ctx_w; backward: those again, then do @ cw^T, qn^T do, dcw @ Wout^T,
    ctx^T dcw, v @ dctx^T, kn @ dctx, d[qkv] @ Wqkv^T and h^T d[qkv]."""
    params = 4 * (c * 384 + 128 * c + 5 * c)
    small = 2 * 128 * 32 * c  # a (128, 32) block product with a (32, C) weight, an item
    fwd = 2 * n * c * 384 + 2 * n * 128 * 32 + small + 2 * n * 128 * c
    if not backward:
        return bound(2 * b * n * c * 2 + params, b * fwd)
    bwd = fwd + 2 * (2 * n * 128 * c) + 2 * small + 2 * (2 * n * 128 * 32) + 2 * (2 * n * c * 384)
    return bound(3 * b * n * c * 2 + 2 * params, b * bwd)


def rb_bound(b: int, side: int, cin: int, cout: int) -> dict:
    """The ResNet block's bound in bf16: x in, y out, the fp32 weights in;
    two 3x3 convolutions and the 1x1 shortcut where C_in != C_out."""
    px = b * side * side
    weights = 4 * (9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0))
    flops = 2 * px * (9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0))
    return bound(px * (cin + cout) * 2 + weights, flops)


def sass_counts(lib: str) -> dict:
    """Per kernel of a built library, from cuobjdump's SASS: how many
    tensor-core (HMMA, HGMMA) and atomic (ATOM, ATOMS, ATOMG, RED)
    instructions."""
    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        ops = [ln.split("*/")[1].split()[0:2] for ln in body.splitlines()
               if ln.lstrip().startswith("/*") and "*/" in ln and len(ln.split("*/")) > 2]
        flat = [w for op in ops for w in op]
        counts[name.strip()] = {
            "hmma": sum(w.startswith(("HMMA", "HGMMA")) for w in flat),
            "atomics": sum(w.split(".")[0] in ("ATOM", "ATOMS", "ATOMG", "RED") for w in flat)}
    return counts


def print_build(built: dict) -> None:
    """Each library's build seconds and what ptxas said of its kernels."""
    for name, (lib, log, seconds) in built.items():
        print(f"built {lib} from {name} in {seconds:.1f} s with nvcc "
              f"{' '.join(build.NVCC_FLAGS)}")
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas: {line.strip().split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")


def check_sass(built: dict) -> None:
    """Phases 2 and 9, over the libraries ``build.build`` returned: every
    bf16 kernel with a product has tensor-core instructions, no fp32 kernel
    has, no kernel has an atomic (the Adam pass's library is not read)."""
    for name, (lib, _, _) in built.items():
        if name == "fused_adam_ema.cu":
            continue
        for kernel_name, n in sass_counts(str(lib)).items():
            bf16 = "bfloat16" in kernel_name
            # the kernels with products: the whole attention forward (STAGE 6;
            # the stage-1 cut has none), the backward's item and dWqkv kernels,
            # the ResNet convs of the modes center (2) and full (3)
            product = any(s in kernel_name for s in ("bfloat16Li6E", "bwd_item", "bwd_wqkv"))
            product |= "resnet_conv_kernel" in kernel_name and any(
                s in kernel_name for s in ("Li2E", "Li3E"))
            print(f"  sass {name}: {kernel_name[-70:]}: {n['hmma']} HMMA / HGMMA (tensor-core) "
                  f"instructions, {n['atomics']} atomics")
            if n["atomics"] or (bf16 and product and not n["hmma"]) or (not bf16 and n["hmma"]):
                raise AssertionError(f"{kernel_name}: {n}")


def site_inputs(b: int, n: int, c: int, dtype: torch.dtype, seed: int):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    x = r(b, n, c).to(DEV, dtype)
    params = [r(c, 384) / c**0.5, r(128, c) / 128**0.5, 0.1 * r(c),
              1 + 0.1 * r(c), 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c)]
    return x, [p.to(DEV) for p in params]


def check_kernel(tag: str) -> dict:
    """Phase 3: kernel vs plain at every site; timings at 2B=128 bf16."""
    kw = dict(heads=4, dim_head=32)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = {}
    cases = [(b, site) for b in (20, 128, 2 * SAMPLE_B) for site in SITES]
    cases += [(4, site) for site in LARGE_SITES] + [(20, site) for site in NARROW_SITES]
    cases += [(b, site) for b in (128, 2 * SAMPLE_B) for site in LATENT_SITES]
    cases += [(b, site) for b in PATH_128PX_B for site in SITES_128PX]
    cases += [(b, site) for b in PATH_64PX_B["fwd"] for site in LARGE_SITES[:4]]
    cases += [(b, site) for b in EDGE_B for site in EDGE_SITES + LATENT_SITES + SITES[3:5]]
    cases += [(TRAIN_B, site) for site in TIME_B64]
    for dtype in (torch.float32, torch.bfloat16):
        for b, (site, n, c) in cases:
            x, p = site_inputs(b, n, c, dtype, seed=b + n + c)
            with torch.inference_mode():
                got = la.linear_attention_block(x, *p, compute_dtype=dtype, **kw)
                again = la.linear_attention_block(x, *p, compute_dtype=dtype, **kw)
                want = la.linear_attention_block_torch(x, *p, compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            atol, rtol = TOL[dtype]
            excess = (diff - atol - rtol * want.float().abs()).max().item()
            plan = la.plan_fwd(n, la.pad_width(c), dtype, b)
            paths.setdefault(plan.path, set()).add((n, c, str(dtype)[6:], plan.cs))
            unit = f", {plan.teams} units an SM" if plan.path == "persistent" else ""
            print(f"kernel vs plain {site} (N={n}, C={c}) 2B={b} "
                  f"{str(dtype)[6:]} [{plan.path} path, {plan.cs} CTAs an item{unit}, "
                  f"{plan.smem_bytes} B shared]: max_abs_err {err:.3e} "
                  f"(tol {atol:g} + {rtol:g}|y|, excess {excess:.3e}; bit-identical rerun)")
            if not (torch.isfinite(got).all() and excess <= 0):
                raise AssertionError(f"{site} 2B={b} {dtype}: err {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"{site} 2B={b} {dtype}: not deterministic")
            worst[dtype] = max(worst[dtype], err)

    for path, shapes in sorted(paths.items()):
        print(f"forward {path} path took (N, C, type, CTAs an item): {sorted(shapes)}")
    if set(paths) != {"persistent", "cluster", "tiled"}:
        raise AssertionError(f"the shapes took only the paths {sorted(paths)}")

    ms = plain_ms = 0.0
    bounds = []
    for i, (site, n, c) in enumerate(SITES):
        k, t, bd = time_fwd_site(site, 128, n, c, i, tag)
        bounds.append(bd)
        ms, plain_ms = ms + k, plain_ms + t
    total = add_bounds(*bounds)
    print(f"time all 8 sites 2B=128 bf16: kernel {ms:.4f} ms, bound {total['bound_ms']:.4f} ms, "
          f"plain {plain_ms:.4f} ms [{tag}]")
    at256 = [time_fwd_site(site, 2 * SAMPLE_B, n, c, i, tag) for i, (site, n, c) in
             enumerate(TIME_256)]
    ms256 = sum(k for k, _, _ in at256[:8])
    bound256 = add_bounds(*(bd for _, _, bd in at256[:8]))
    print(f"time all 8 sites 2B=256 bf16 (a pixel sampler step): kernel {ms256:.4f} ms, bound "
          f"{bound256['bound_ms']:.4f} ms, kernel/bound {ms256 / bound256['bound_ms']:.1f} [{tag}]")
    at64 = {site: time_fwd_site(site, TRAIN_B, n, c, i, tag)[0]
            for i, (site, n, c) in enumerate(TIME_B64)}
    return {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
            "ms": ms, "plain_ms": plain_ms, **total, "ms_2b256": ms256,
            "bound_ms_2b256": bound256["bound_ms"], "latent_2b256_ms": at256[8][0],
            "b64_ms": at64,
            "site_128px": {f"b{b}": time_128px_site(b, False, tag) for b in PATH_128PX_B}}


def time_fwd_site(site: str, b: int, n: int, c: int, seed: int, tag: str):
    """The forward kernel and the plain version at (B, N, C) bf16 by CUDA-graph
    replay, beside the bound; returns (kernel ms, plain ms, bound)."""
    x, p = site_inputs(b, n, c, torch.bfloat16, seed=seed)
    kw = dict(heads=4, dim_head=32, compute_dtype=torch.bfloat16)
    iters = 20 if b * n <= 256 * 1024 else 5
    with torch.inference_mode():
        k = cuda_graph_ms(lambda: la.linear_attention_block(x, *p, **kw), iters=iters)
        t = cuda_graph_ms(lambda: la.linear_attention_block_torch(x, *p, **kw), iters=iters)
    bd = la_bound(b, n, c, backward=False)
    plan = la.plan_fwd(n, c, torch.bfloat16, b)
    print(f"time {site} (N={n}, C={c}) 2B={b} bf16 [{plan.path} path]: kernel {k:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}, kernel/bound "
          f"{k / bd['bound_ms']:.1f}, plain {t:.4f} ms [{tag}]")
    return k, t, bd


def time_128px_site(b: int, backward: bool, tag: str) -> dict:
    """The forward or the backward at the 128px site (16384, 64), B=b, bf16,
    by CUDA-graph replay beside its bound and the plain version."""
    site, n, c = LARGE_SITES[4]
    x, p = site_inputs(b, n, c, torch.bfloat16, seed=n + b)
    kw = dict(heads=4, dim_head=32, compute_dtype=torch.bfloat16)
    if backward:
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(c)).to(DEV, x.dtype)
        k = cuda_graph_ms(lambda: la.linear_attention_block_bwd(x, dy, *p, **kw), iters=10)
        t = cuda_graph_ms(lambda: la.linear_attention_block_bwd_torch(x, dy, *p, **kw),
                          iters=10)
    else:
        with torch.inference_mode():
            k = cuda_graph_ms(lambda: la.linear_attention_block(x, *p, **kw), iters=10)
            t = cuda_graph_ms(lambda: la.linear_attention_block_torch(x, *p, **kw), iters=10)
    bd = la_bound(b, n, c, backward=backward)
    size = ("a correctness-check size, not one the path runs" if b == BWD_128PX_B
            else "a batch of phase 7l's 128px step")
    print(f"time {'bwd' if backward else 'fwd'} {site} (N={n}, C={c}) B={b} bf16 ({size}): "
          f"kernel{'s' if backward else ''} {k:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']}, kernel/bound {k / bd['bound_ms']:.1f}, plain {t:.4f} ms, "
          f"plain/kernel {t / k:.2f} [{tag}]")
    return {"b": b, "n": n, "c": c, "ms": k, "plain_ms": t, **bd}


def check_bwd_kernel(tag: str) -> dict:
    """Phase 4: backward kernels vs plain at the 8 sites (B=64), the 64px
    sites (B=4) and the 128px site (B=2: the tiled path over 8 CTAs of
    2,048 rows); timings at B=64 bf16, and the 128px site's at B=2 bf16."""
    kw = dict(heads=4, dim_head=32)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = {}
    cases = [(TRAIN_B, site) for site in SITES] + [(4, site) for site in LARGE_SITES[:4]]
    cases += [(BWD_128PX_B, LARGE_SITES[4])]
    cases += [(b, site) for b in PATH_128PX_B for site in SITES_128PX]
    cases += [(b, site) for b in PATH_64PX_B["bwd"] for site in LARGE_SITES[:4]]
    cases += [(8, site) for site in NARROW_SITES] + [(TRAIN_B, site) for site in LATENT_SITES]
    for dtype in (torch.float32, torch.bfloat16):
        for b, (site, n, c) in cases:
            x, p = site_inputs(b, n, c, dtype, seed=b + n + c)
            dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(n + c)).to(DEV, dtype)
            kw_d = dict(kw, compute_dtype=dtype)
            got = la.linear_attention_block_bwd(x, dy, *p, **kw_d)
            again = la.linear_attention_block_bwd(x, dy, *p, **kw_d)
            want = la.linear_attention_block_bwd_torch(x, dy, *p, **kw_d)
            torch.cuda.synchronize()
            errs, rels = [], []
            for name, g, a, w in zip(GRADS, got, again, want):
                err = (g.float() - w.float()).abs().max().item()
                scale = w.float().abs().max().item()
                rels.append(err / scale)
                errs.append(f"{name} {err:.3e}/{scale:.3e}")
                if not torch.isfinite(g).all() or err > BWD_TOL[dtype] * scale:
                    raise AssertionError(f"bwd {site} B={b} {dtype} {name}: err {err}, "
                                         f"max|plain| {scale}")
                if not torch.equal(g, a):
                    raise AssertionError(f"bwd {site} B={b} {dtype} {name}: not deterministic")
            plan = la.plan_bwd(n, la.pad_width(c), dtype)
            paths.setdefault(plan.path, set()).add((n, c, str(dtype)[6:], plan.cs))
            print(f"bwd kernel vs plain {site} (N={n}, C={c}) B={b} {str(dtype)[6:]} "
                  f"[{plan.path} path, {plan.cs} CTAs an item, {plan.smem_bytes} B shared]: "
                  f"max_abs_err/max|plain| {'; '.join(errs)} (tol {BWD_TOL[dtype]:g} x "
                  f"max|plain|, worst ratio {max(rels):.2e}; bit-identical rerun)")
            worst[dtype] = max(worst[dtype], max(rels))

    for path, shapes in sorted(paths.items()):
        print(f"backward {path} path took (N, C, type, CTAs an item): {sorted(shapes)}")
    if set(paths) != {"cluster", "tiled"}:
        raise AssertionError(f"the shapes took only the paths {sorted(paths)}")

    ms = plain_ms = 0.0
    bounds = []
    for i, (site, n, c) in enumerate(SITES):
        x, p = site_inputs(TRAIN_B, n, c, torch.bfloat16, seed=i)
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(i)).to(DEV, x.dtype)
        kw_b = dict(kw, compute_dtype=torch.bfloat16)
        k = cuda_graph_ms(lambda: la.linear_attention_block_bwd(x, dy, *p, **kw_b), iters=10)
        t = cuda_graph_ms(lambda: la.linear_attention_block_bwd_torch(x, dy, *p, **kw_b),
                          iters=10)
        bd = la_bound(TRAIN_B, n, c, backward=True)
        bounds.append(bd)
        ms, plain_ms = ms + k, plain_ms + t
        print(f"time bwd {site} (N={n}, C={c}) B={TRAIN_B} bf16: kernels {k:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, kernels/bound "
              f"{k / bd['bound_ms']:.1f}, plain {t:.4f} ms [{tag}]")
    total = add_bounds(*bounds)
    print(f"time bwd all 8 sites B={TRAIN_B} bf16: kernels {ms:.4f} ms, bound "
          f"{total['bound_ms']:.4f} ms, plain {plain_ms:.4f} ms [{tag}]")
    return {"max_rel_err": worst[torch.bfloat16], "max_rel_err_fp32": worst[torch.float32],
            "ms": ms, "plain_ms": plain_ms, **total,
            "site_128px": {f"b{b}": time_128px_site(b, True, tag)
                           for b in (BWD_128PX_B, *PATH_128PX_B)}}


# the three models whose norms take the GroupNorm pass, at the benchmark's
# widths (benchmark/configs/cifar10-*.json): the pixel UNet, the latent UNet
# over 4x4x8 latents, and the VAE (its encoder and decoder)
GN_MODELS = {
    "pixel": dict(in_channels=3, out_channels=3, channels=64, channel_multipliers=(1, 2, 4, 8),
                  num_classes=10),
    "latent": dict(in_channels=8, out_channels=8, channels=64, channel_multipliers=(1,),
                   num_classes=10),
}
GN_VAE = dict(in_channels=3, out_channels=3, channels=64, channel_multipliers=(1, 2, 4, 8),
              n_resnet_blocks=2, z_channels=8)
GN_BATCHES = (2 * SAMPLE_B, SAMPLE_B, 20, 1)  # the samplers' 2B, a request's, one image
# the 64px UNet's largest norms (probe 39's samplers), checked at a few items:
# more chunks a thread than registers hold, so the kernel reads some again
GN_64PX = [(4096, 64, 8, 1e-5, True), (4096, 128, 8, 1e-5, True)]
# a value whose magnitude is below 2^-6 can come out of the fp32 affine
# a x + b with another exponent in either version (its rounding is a few
# 2^-24 of |a x| + |b|): one spacing is taken at no less than 2^-6 there
GN_SPACING_FLOOR = 2.0 ** -6


def norm_sites(model, run) -> collections.Counter:
    """(H*W, C, G, eps, silu) of every GroupNorm call ``run()`` makes in
    ``model``, with how often; ``run`` calls the model once."""
    seen = collections.Counter()
    norms = [m for m in model.modules() if isinstance(m, unet_module.GroupNorm)]
    for m in norms:
        def norm(x, silu, m=m, inner=m._norm):
            seen[(x.shape[2] * x.shape[3], x.shape[1], m.num_groups, m.eps, silu)] += 1
            return inner(x, silu)
        m._norm = norm
    try:
        with torch.inference_mode():
            run()
    finally:
        for m in norms:
            del m._norm
    return seen


def bf16_spacings(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 spacings at the larger of |a|, |b| (and GN_SPACING_FLOOR)."""
    mag = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(GN_SPACING_FLOOR)
    _, exp = torch.frexp(mag)
    return (a.float() - b.float()).abs() / torch.ldexp(torch.ones_like(mag), exp - 8)


def gn_inputs(b: int, hw: int, c: int, seed: int):
    """x (B, C, H, W) bf16 channels_last, and the norm's fp32 weight and bias."""
    g = torch.Generator().manual_seed(seed)
    side = math.isqrt(hw)
    x = torch.randn(b, side, side, c, generator=g) * 2 + 0.3 * torch.randn(c, generator=g)
    weight = 1 + 0.3 * torch.randn(c, generator=g)
    bias = 0.3 * torch.randn(c, generator=g)
    return x.to(DEV, torch.bfloat16).permute(0, 3, 1, 2), weight.to(DEV), bias.to(DEV)


def gn_sites() -> dict:
    """The norm sites of the three models, recorded from a forward of each on
    the card: {model: Counter of (H*W, C, G, eps, silu)}; each UNet's count
    is its ``group_norm_calls``."""
    from ldm_tpu_torch.models import autoencoder as ae_module

    sites = {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        for name, kw in GN_MODELS.items():
            model = unet_module.UNet(**kw, dtype=torch.bfloat16, device=DEV).eval()
            side = 32 if name == "pixel" else 4
            x = torch.zeros(1, side, side, kw["in_channels"], device=DEV)
            t = torch.zeros(1, dtype=torch.long, device=DEV)
            sites[name] = norm_sites(model, lambda: model(x, t, t + 1))
            if sum(sites[name].values()) != unet_module.group_norm_calls(model):
                raise AssertionError(f"{name}: {sites[name]} against "
                                     f"{unet_module.group_norm_calls(model)} modules")
        vae = ae_module.Autoencoder(**GN_VAE, dtype=torch.bfloat16, device=DEV).eval()
        sites["vae"] = norm_sites(vae, lambda: vae(torch.zeros(1, 32, 32, 3, device=DEV),
                                                   torch.zeros(1, 4, 4, 8, device=DEV)))
        halves = (unet_module.group_norm_calls(vae.encoder),
                  unet_module.group_norm_calls(vae.decoder))
    if ((sum(sites["pixel"].values()), sum(sites["latent"].values()), *halves)
            != (GN_PIXEL, GN_LATENT, GN_VAE_ENC, GN_VAE_DEC)
            or sum(sites["vae"].values()) != sum(halves)):
        raise AssertionError(f"norm calls a forward: {sites}, the VAE's halves {halves}")
    return sites


def check_group_norm(tag: str) -> dict:
    """Phase 3b: the GroupNorm (+ SiLU) pass against its plain version at
    every norm site of the pixel UNet, the latent UNet and the VAE (recorded
    from their forwards), at 2B = 256, 128, 20 and B = 1: the norm within one
    bf16 spacing of the plain chain's, the SiLU within one of ``F.silu`` of
    the kernel's own norm (the plain SiLU of the same bf16 values); reruns
    bit-identical, an item the same bits at another slot and batch size.
    Times by CUDA-graph replay at 2B=256 beside the bytes bound and the plain
    chain, and the pixel UNet's whole step."""
    t0 = time.perf_counter()
    sites = gn_sites()
    print("norm calls a forward: " + "; ".join(f"{k} {sum(v.values())} at {len(v)} shapes"
                                                for k, v in sites.items()))
    shapes = sorted({s for v in sites.values() for s in v})
    worst = {"norm": 0.0, "silu": 0.0, "silu_vs_plain": 0.0}
    off = {"norm": 0, "silu_vs_plain": 0}
    for (hw, c, groups, eps, silu), batches in ([(s, GN_BATCHES) for s in shapes]
                                                 + [(s, (4, 1)) for s in GN_64PX]):
        plan = gn.plan_group_norm(hw, c, groups)
        for b in batches:
            x, w, bias = gn_inputs(b, hw, c, seed=hw + c + groups + b)
            norm_k = gn.group_norm_silu(x, w, bias, groups, eps, False)
            norm_p = gn.group_norm_silu_torch(x, w, bias, groups, eps, False)
            silu_k = gn.group_norm_silu(x, w, bias, groups, eps, True)
            again = gn.group_norm_silu(x, w, bias, groups, eps, True)
            torch.cuda.synchronize()
            if not (norm_k.is_contiguous(memory_format=torch.channels_last)
                    and norm_k.dtype == torch.bfloat16 and bool(torch.isfinite(norm_k).all())):
                raise AssertionError(f"GroupNorm kernel output at {hw, c, groups} B={b}: "
                                     f"{norm_k.dtype} {norm_k.stride()}")
            d_norm = bf16_spacings(norm_k, norm_p)
            d_silu = bf16_spacings(silu_k, F.silu(norm_k))
            d_plain = bf16_spacings(silu_k, F.silu(norm_p))
            worst["norm"] = max(worst["norm"], d_norm.max().item())
            worst["silu"] = max(worst["silu"], d_silu.max().item())
            worst["silu_vs_plain"] = max(worst["silu_vs_plain"], d_plain.max().item())
            off["norm"] += int((d_norm > 0).sum())
            off["silu_vs_plain"] += int((d_plain > 0).sum())
            if d_norm.max() > 1 or d_silu.max() > 1:
                raise AssertionError(f"GroupNorm kernel at {hw, c, groups, eps} B={b}: "
                                     f"{d_norm.max().item()} spacings from the plain norm, "
                                     f"{d_silu.max().item()} from F.silu of its own")
            if not torch.equal(silu_k, again):
                raise AssertionError(f"GroupNorm kernel at {hw, c, groups} B={b}: a rerun "
                                     f"differs")
            if b > 20:  # the same items at other slots, in a batch of 20 and alone
                few = gn.group_norm_silu(x.roll(7, 0)[:20].contiguous(
                    memory_format=torch.channels_last), w, bias, groups, eps, True)
                one = gn.group_norm_silu(x[3:4], w, bias, groups, eps, True)
                if not (torch.equal(few, silu_k.roll(7, 0)[:20])
                        and torch.equal(one, silu_k[3:4])):
                    raise AssertionError(f"GroupNorm kernel at {hw, c, groups} B={b}: an "
                                         f"item's output depends on its slot or batch")
        print(f"group_norm_silu vs plain (H*W={hw}, C={c}, G={groups}, eps={eps:g}, "
              f"{'with' if silu else 'no'} SiLU after it in the models) at B "
              f"{batches}: plan {plan._asdict()}; bit-identical rerun"
              f"{', at another slot and batch size' if max(batches) > 20 else ''}")
    print(f"group_norm_silu: the norm at most {worst['norm']:.3f} bf16 spacings from the plain "
          f"chain's ({off['norm']} elements not equal), the SiLU at most {worst['silu']:.3f} "
          f"from F.silu of the kernel's norm; from the plain chain's SiLU at most "
          f"{worst['silu_vs_plain']:.3f} ({off['silu_vs_plain']} elements not equal); spacings "
          f"taken at no less than {GN_SPACING_FLOOR:g}")

    # times at 2B=256, and the pixel UNet's sampler step (each site x its calls)
    b = 2 * SAMPLE_B
    rows, step_ms, step_plain, bounds = [], 0.0, 0.0, []
    pixel = sites["pixel"]
    for hw, c, groups, eps, silu in shapes:
        x, w, bias = gn_inputs(b, hw, c, seed=hw + c)
        ms = cuda_graph_ms(lambda: gn.group_norm_silu(x, w, bias, groups, eps, silu))
        plain = cuda_graph_ms(lambda: gn.group_norm_silu_torch(x, w, bias, groups, eps, silu))
        bd = bound(4 * b * hw * c + 8 * c, 0.0)
        n = pixel.get((hw, c, groups, eps, silu), 0)
        step_ms, step_plain, bounds = step_ms + n * ms, step_plain + n * plain, bounds + [bd] * n
        rows.append({"hw": hw, "c": c, "groups": groups, "eps": eps, "silu": silu, "ms": ms,
                     "plain_ms": plain, "bound_ms": bd["bound_ms"], "pixel_calls": n})
        print(f"time group_norm_silu (H*W={hw}, C={c}, G={groups}, silu={silu}) 2B={b}: "
              f"kernel {ms:.4f} ms, bound {bd['bound_ms']:.4f} ms (4 B an element at 3.35 "
              f"TB/s), kernel/bound {ms / bd['bound_ms']:.2f}, plain chain {plain:.4f} ms "
              f"[{tag}]")
    total = add_bounds(*bounds)
    print(f"time group_norm_silu, the pixel UNet's {sum(pixel.values())} norms of a sampler "
          f"step at 2B={b}: kernel {step_ms:.4f} ms, bound {total['bound_ms']:.4f} ms, plain "
          f"chain {step_plain:.4f} ms [{tag}]; phase {time.perf_counter() - t0:.1f} s")
    return {"ms": step_ms, "plain_ms": step_plain, **total, "rows": rows,
            "max_spacings": worst, "calls": {k: sum(v.values()) for k, v in sites.items()}}


SD_CONFIG = "configs/sd21_v_768.yaml"
SD_BATCHES = {"unet": 16, "decoder": 8}  # the text-to-image cell's 2B and its decode's B


def gn_sd_sites() -> dict:
    """The norm sites of Stable Diffusion 2.1's U-Net at its 96x96 latents
    and of its VAE's decoder at 768 px, recorded from a forward of each on
    the card at published widths."""
    from ldm_tpu_torch.models import autoencoder as ae_module

    config = load_config(SD_CONFIG)
    p, ap = config.model.params, config.autoencoder.params
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(config, device=DEV).eval()
        x = torch.zeros(1, 96, 96, p["in_channels"], device=DEV)
        ctx = torch.zeros(1, 77, p["context_dim"], device=DEV)
        t = torch.zeros(1, dtype=torch.long, device=DEV)
        sites = {"unet": norm_sites(model, lambda: model(x, t, ctx))}
        del model
        vae = ae_module.Autoencoder(**ap, dtype=torch.bfloat16, device=DEV).eval()
        z = torch.zeros(1, 96, 96, ap["z_channels"], device=DEV)
        sites["decoder"] = norm_sites(vae, lambda: vae.decode(z))
        del vae
    torch.cuda.empty_cache()
    return sites


def check_group_norm_sd(tag: str) -> dict:
    """Phase 3b at Stable Diffusion's shapes: at every norm site of its U-Net
    (2B = 16) and of its decoder at 768 px (B = 8), the pass against the
    plain chain (the norm within one bf16 spacing, the SiLU within one of
    ``F.silu`` of its own norm) and both timed by CUDA-graph replay beside
    the bytes bound; a shape where the pass is slower than the chain is
    named.  The sums are a sampler step's and a decode's norms."""
    t0 = time.perf_counter()
    sites = gn_sd_sites()
    out = {}
    for model, seen in sites.items():
        b = SD_BATCHES[model]
        ms_sum = plain_sum = bound_sum = 0.0
        loses = []
        for (hw, c, groups, eps, silu), n in sorted(seen.items()):
            plan = gn.plan_group_norm(hw, c, groups)
            x, w, bias = gn_inputs(b, hw, c, seed=hw + c + groups)
            got = gn.group_norm_silu(x, w, bias, groups, eps, silu)
            norm_k = gn.group_norm_silu(x, w, bias, groups, eps, False)
            norm_p = gn.group_norm_silu_torch(x, w, bias, groups, eps, False)
            d_norm = bf16_spacings(norm_k, norm_p).max().item()
            d_silu = bf16_spacings(got, F.silu(norm_k)).max().item() if silu else 0.0
            del got, norm_k, norm_p
            if d_norm > 1 or d_silu > 1:
                raise AssertionError(f"GroupNorm kernel at {hw, c, groups, eps} B={b}: {d_norm} "
                                     f"spacings from the plain norm, {d_silu} from F.silu")
            iters = 5 if b * hw * c > 1 << 26 else 20
            ms = cuda_graph_ms(lambda: gn.group_norm_silu(x, w, bias, groups, eps, silu),
                               iters=iters)
            plain = cuda_graph_ms(
                lambda: gn.group_norm_silu_torch(x, w, bias, groups, eps, silu), iters=iters)
            bd = bound(4 * b * hw * c + 8 * c, 0.0)["bound_ms"]
            ms_sum, plain_sum, bound_sum = ms_sum + n * ms, plain_sum + n * plain, \
                bound_sum + n * bd
            if ms > plain:
                loses.append((hw, c, groups))
            print(f"time group_norm_silu SD {model} (H*W={hw}, C={c}, G={groups}, eps={eps:g}, "
                  f"silu={silu}, {n} a forward) B={b}: kernel {ms:.4f} ms, bound {bd:.4f} ms, "
                  f"kernel/bound {ms / bd:.2f}, plain chain {plain:.4f} ms"
                  f"{' (the pass loses)' if ms > plain else ''}; plan {plan._asdict()}; "
                  f"{d_norm:.3f} / {d_silu:.3f} spacings [{tag}]")
            del x, w, bias
            torch.cuda.empty_cache()
        print(f"time group_norm_silu SD {model}, its {sum(seen.values())} norms at B={b}: "
              f"kernel {ms_sum:.4f} ms, bound {bound_sum:.4f} ms, plain chain {plain_sum:.4f} ms; "
              f"the pass loses at {loses or 'no shape'} [{tag}]")
        out[model] = {"ms": ms_sum, "plain_ms": plain_sum, "bound_ms": bound_sum,
                      "loses": loses, "calls": sum(seen.values())}
    print(f"phase 3b SD {time.perf_counter() - t0:.1f} s")
    return out


def check_unet_grads(config) -> None:
    """Phase 5, gradients: the loss gradient of every parameter, kernel path
    (LinearAttentionBlockFn) vs plain path (torch autograd), B=8."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 32, 32, 3, generator=g).to(DEV)
    eps = torch.randn(8, 32, 32, 3, generator=g).to(DEV)
    t = torch.randint(0, T_STEPS, (8,), generator=g).to(DEV)
    y = torch.arange(8).to(DEV)
    for use_amp in (False, True):
        m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=use_amp), seed=5)
        before = registry.read(la.BWD_LIB.name)
        for m in (m_kernel, m_plain):
            m.train().zero_grad(set_to_none=True)
            torch.mean((eps - m(x, t, y)) ** 2).backward()
        torch.cuda.synchronize()
        if registry.read(la.BWD_LIB.name) - before != 8:
            raise AssertionError("the kernel-path backward did not launch the kernels 8 times")
        worst, dead = 0.0, []
        plain = dict(m_plain.named_parameters())
        for name, p in m_kernel.named_parameters():
            w = plain[name].grad
            rel = ((p.grad - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            if ("to_qkv" in name or "to_out.0" in name) and not p.grad.abs().max() > 0:
                dead.append(name)
            if not use_amp and rel > UNET_FP32_TOL:
                raise AssertionError(f"fp32 grad {name}: {rel} x max|grad| > {UNET_FP32_TOL}")
        if dead:
            raise AssertionError(f"zero gradient on {dead}")
        dt = "bf16" if use_amp else "fp32"
        print(f"full-width UNet loss gradients B=8 {dt}: kernel path vs plain path, worst "
              f"max_abs_err / max|grad| over the parameters {worst:.3e}; every to_qkv and "
              f"to_out weight has a non-zero gradient")


def check_graphed_training(config) -> None:
    """Phase 7, the graphed step against the eager one: two fp32 trainers
    from the same weights, the same batches and injected t / eps / drop; 8
    steps (3 eager warm-up steps, 5 replayed).  Before the replays an eager
    eval_step and a sample from the EMA weights fill both models' caches of
    kernel weight copies; after them the same calls must agree with the
    plain-path models loaded from the state_dict (the copies were remade)."""
    with tempfile.TemporaryDirectory() as workdir:
        _check_graphed_training(dataclasses.replace(config, use_amp=False, workdir=workdir))


def _check_graphed_training(cfg) -> None:
    def trainer(graphs, **overrides):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(11)
            model = build_model(cfg, DEV, **overrides)
        return DiffusionTrainer(cfg, model, build_diffusion(cfg, DEV), None, None,
                                list(range(10)), device=DEV, graphs=graphs)

    graphed, eager = trainer(None), trainer(False)
    flow = isinstance(graphed.diffusion, RectifiedFlow)
    start = {k: v.clone() for k, v in graphed.model.state_dict().items()}
    g = torch.Generator().manual_seed(12)

    def batch():
        return {"image": torch.rand(TRAIN_B, 32, 32, 3, generator=g) * 2 - 1,
                "label": torch.randint(0, 10, (TRAIN_B,), generator=g)}

    held_out = batch()
    grid = [1, 5, 9]
    worst = 0.0
    for step in range(8):
        if step == WARMUP_STEPS:  # the last eager calls before the replays
            graphed.eval_step(held_out, 0)
            graphed.sample(grid, cfg_scale=3.0, method="dpmpp", ddim_steps=5)
        b = batch()
        draws = dict(t=(torch.rand(TRAIN_B, generator=g) if flow else
                        torch.randint(0, T_STEPS, (TRAIN_B,), generator=g)),
                     eps=torch.randn(TRAIN_B, 32, 32, 3, generator=g),
                     drop=torch.tensor(step % 3 == 0))
        la_, lb = graphed.train_step(b, **draws), eager.train_step(b, **draws)
        rel = abs(la_["loss"].item() - lb["loss"].item()) / lb["loss"].item()
        worst = max(worst, rel)
        print(f"  fp32 step {step}: loss graphed {la_['loss'].item():.6f} eager "
              f"{lb['loss'].item():.6f}, grad norm {la_['grad_norm'].item():.4f} / "
              f"{lb['grad_norm'].item():.4f}")
        if rel > UNET_FP32_TOL:
            raise AssertionError(f"step {step}: graphed loss off the eager one by {rel}")
    if graphed.step_counts != {"graphed": 8 - WARMUP_STEPS, "eager": WARMUP_STEPS}:
        raise AssertionError(f"step counts {graphed.step_counts}")
    if graphed.state.step != 8 or int(graphed.state.step_t) != 8:
        raise AssertionError("the graphed trainer's step counters are off")
    moved = 0.0
    others = dict(eager.model.named_parameters())
    for name, p in graphed.model.named_parameters():
        if "to_qkv" in name or "to_out.0.weight" in name:
            da, db = p.detach() - start[name], others[name].detach() - start[name]
            scale = db.abs().max().item()
            moved = max(moved, (da - db).abs().max().item() / scale)
            if not scale > 0 or (da - db).abs().max().item() > UNET_FP32_TOL * scale:
                raise AssertionError(f"{name}: moved {da.abs().max().item()} graphed, {scale} "
                                     f"eager")
    print(f"graphed vs eager fp32 {type(graphed.diffusion).__name__} trainer, 8 steps "
          f"({8 - WARMUP_STEPS} replayed): worst loss "
          f"difference {worst:.2e} of the loss; every to_qkv / to_out.0 weight moved, the "
          f"same way within {moved:.2e} of its largest move")

    plain = trainer(False, attention_impl="torch")
    plain.state.load_state_dict(graphed.state.state_dict())
    got, want = graphed.eval_step(held_out, 0).item(), plain.eval_step(held_out, 0).item()
    images = graphed.sample(grid, cfg_scale=3.0, method="dpmpp", ddim_steps=5)
    images_plain = plain.sample(grid, cfg_scale=3.0, method="dpmpp", ddim_steps=5)
    off = np.abs(images.astype(np.int32) - images_plain.astype(np.int32)).max()
    print(f"after the replays: eager eval_step on the kernel path {got:.6f}, plain-path model "
          f"from the same state_dict {want:.6f}; EMA sample grid (DPM-Solver++, 5 steps) "
          f"within {off} of 255 of the plain path's")
    if abs(got - want) > UNET_FP32_TOL * want or off > 1:
        raise AssertionError("the kernel weight copies are stale after replayed steps")


def check_smoke_config(tag: str) -> None:
    """configs/smoke_synthetic.yaml on the card (attention at C = 8, which the
    wrapper pads to the kernels' 16 columns, and at C = 16): requests through
    generate.main graphed and eager, the kernel path against the plain path,
    and one epoch of training."""
    cfg = load_config(SMOKE)
    t_steps, blocks = cfg.diffusion.n_steps, 4
    out = {}
    for how, extra, steps in (("graphed", [], t_steps + WARMUP_STEPS), ("eager", ["--eager"],
                                                                         t_steps)):
        with tempfile.TemporaryDirectory() as d:
            path = seeded_run(d, SMOKE)
            zero_counts()
            out[how] = generate.main([path, "--device", "cuda", "--out",
                                      os.path.join(d, "x.npy"), *extra])
            counts = read_counts()
        if counts != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": blocks * steps}:
            raise AssertionError(f"the {how} smoke request launched {counts}")
    err = np.abs(out["graphed"].x0 - out["eager"].x0).max()
    m_kernel, m_plain = seeded_pair(cfg, seed=cfg.seed)
    diffusion = build_diffusion(cfg, DEV)
    classes = torch.arange(10, device=DEV)
    x0 = [diffusion.sample(m, classes, (16, 16, 1), cfg_scale=3.0, null_label=m.null_label,
                           generator=torch.Generator(device=DEV).manual_seed(0))
          for m in (m_kernel, m_plain)]
    err_plain = (x0[0] - x0[1]).abs().max().item()
    print(f"{SMOKE} (attention at C=8, C=16) T={t_steps} B=10 fp32: images "
          f"{out['graphed'].images.shape}; graphed vs eager max_abs_err {err:.3e}; kernel path "
          f"vs plain path max_abs_err {err_plain:.3e}; forward launches {blocks} x "
          f"({t_steps} + {WARMUP_STEPS} warm-up) graphed, {blocks} x {t_steps} eager [{tag}]")
    if (out["graphed"].images.shape != (10, 16, 16, 1) or not np.isfinite(out["graphed"].x0).all()
            or err > UNET_FP32_TOL or err_plain > UNET_FP32_TOL):
        raise AssertionError(f"smoke config: errs {err}, {err_plain}")
    with tempfile.TemporaryDirectory() as workdir:
        # debugging cuts the data to two batches: too few to reach the capture
        cfg = dataclasses.replace(cfg, workdir=workdir, epochs=1, debugging=False,
                                  data=dataclasses.replace(cfg.data, synthetic_size=160))
        zero_counts()
        res = train.run(cfg, DEV)
        counts = read_counts()
    steps = res.trainer.state.step
    print(f"{SMOKE} trained 1 epoch of {steps} steps at B=8: train loss "
          f"{res.history['train_loss']}, steps {res.trainer.step_counts}, backward launches "
          f"{counts['linear_attention_bwd']} (want {blocks * steps})")
    if (steps != 16 or counts["linear_attention_bwd"] != blocks * steps
            or counts["fused_adam_ema"] != steps
            or res.trainer.step_counts != {"graphed": 16 - WARMUP_STEPS, "eager": WARMUP_STEPS}
            or not np.isfinite(res.history["train_loss"]).all()):
        raise AssertionError(f"smoke training: {steps} steps, {counts}")


def check_training(config, tag: str) -> dict:
    """Phase 7: the training slice through train.run, then a resume and the
    train step's time, graphed and eager."""
    with tempfile.TemporaryDirectory() as workdir:
        cfg = dataclasses.replace(
            config, workdir=workdir, epochs=3,
            data=dataclasses.replace(config.data, synthetic_size=SYNTHETIC_SIZE))
        zero_counts()
        res = train.run(cfg, DEV)
        run_counts = read_counts()
        fwd_launches = run_counts["linear_attention_fwd"]
        bwd_launches = run_counts["linear_attention_bwd"]
        steps = res.trainer.state.step
        hist = res.history
        print(f"training run: {steps} steps in 3 epochs at B={TRAIN_B} bf16; train loss by "
              f"epoch {hist['train_loss']}, val loss {hist['val_loss']}; kernel launches: "
              f"backward {bwd_launches} (want {8 * steps}), forward {fwd_launches}; "
              f"all counts {run_counts}")
        step_counts = res.trainer.step_counts
        print(f"train steps replayed as a CUDA graph / eager: {step_counts}")
        scan = res.trainer.epoch_scan
        if scan is None or res.trainer.scan_graph is None or res.trainer.train_graph is not None:
            raise AssertionError("train.run did not take the device-resident epoch's graph")
        print(f"train.run took the device-resident epoch: {scan.n} images of "
              f"{scan.image_shape} uint8 on the card, {scan.n_batches} steps an epoch, the "
              f"batch gathered inside the replayed step")
        if (steps != 27 or bwd_launches != 8 * steps or run_counts["fused_adam_ema"] != steps
                or any(run_counts[k] for k in OFF_PATH)):
            raise AssertionError(f"{steps} steps, launches {run_counts}")
        if step_counts != {"graphed": 27 - WARMUP_STEPS, "eager": WARMUP_STEPS}:
            raise AssertionError(f"step counts {step_counts}")
        losses = hist["train_loss"] + hist["val_loss"]
        if not np.isfinite(losses).all() or not hist["train_loss"][-1] < hist["train_loss"][0]:
            raise AssertionError(f"losses {hist}")
        run_dir = cfg.dirpath
        files = ["metrics.jsonl", "summary.json", "results/sample_step2.npy",
                 "checkpoints/state.pt", "checkpoints/best_state.pt",
                 "checkpoints/diffusion_model.pt", "checkpoints/diffusion_model_ema.pt"]
        missing = [f for f in files if not os.path.isfile(os.path.join(run_dir, f))]
        if missing:
            raise AssertionError(f"missing run files {missing}")
        grid = np.load(os.path.join(run_dir, "results/sample_step2.npy"))
        print(f"run files present; sample grid {grid.shape} {grid.dtype}")
        again = train.run(dataclasses.replace(cfg, epochs=0), DEV, resume=True)
        if again.resumed_from != steps:
            raise AssertionError(f"resume restored step {again.resumed_from}, want {steps}")
        # the restored optimizer is capturable: its step counts on the device,
        # its moments the saved ones; training goes on through a new capture
        trainer, resumed = res.trainer, again.trainer
        opt, opt0 = resumed.state.optimizer, trainer.state.optimizer
        first, first0 = resumed.state.params()[0], trainer.state.params()[0]
        adam_step = opt.state[first]["step"]
        restored = int(adam_step.item())
        if not (all(g_["capturable"] for g_ in opt.param_groups) and adam_step.is_cuda
                and restored == steps and int(resumed.state.step_t) == steps
                and torch.equal(opt.state[first]["exp_avg_sq"], opt0.state[first0]["exp_avg_sq"])):
            raise AssertionError("the resumed optimizer's state is not the saved one")
        gen = torch.Generator().manual_seed(6)
        batch = {"image": torch.rand(TRAIN_B, 32, 32, 3, generator=gen) * 2 - 1,
                 "label": torch.randint(0, 10, (TRAIN_B,), generator=gen)}
        pairs = [(resumed.train_step(batch)["loss"].item(), trainer.train_step(batch)["loss"].item())
                 for _ in range(WARMUP_STEPS + 2)]
        print(f"--resume restored step {again.resumed_from} and a capturable Adam (its step "
              f"count {restored} on {adam_step.device}); {len(pairs)} more steps, "
              f"resumed (3 eager, then a new capture) / original (replayed) losses: "
              f"{' '.join(f'{a:.5f}/{b:.5f}' for a, b in pairs)}")
        if resumed.state.step != steps + len(pairs) or resumed.step_counts["graphed"] != 2 or any(
                not np.isfinite(a) or abs(a - b) > 1e-2 * b for a, b in pairs):
            raise AssertionError(f"the resumed run left the original's path: {pairs}")
        del again, resumed, opt

        zero_counts()
        trainer.train_step(batch)
        per_step = read_counts()
        print(f"one replayed train step launches: {per_step}")
        # the step's forward is in autograd: no GroupNorm pass
        if per_step != dict.fromkeys(OFF_PATH, 0) | {"linear_attention_fwd": 8,
                                                     "linear_attention_bwd": 8,
                                                     "fused_adam_ema": 1,
                                                     "group_norm_silu": 0}:
            raise AssertionError(f"a train step launched the kernels {per_step} times")
        persistent = check_persistent(8, TRAIN_B, SITES, f"a replayed train step B={TRAIN_B}")

        def ten_steps():
            for _ in range(10):
                trainer.train_step(batch)

        graphed = host_ms(ten_steps, 10)
        device_ms = trainer.train_graph.device_ms(10)
        trainer.graphs = False  # the same trainer's eager step
        ten_steps()
        eager = host_ms(ten_steps, 10)
        trainer.graphs = True
        trainer.train_step(batch)  # back on the graph: .grad is the graph's again
        if not all(p.grad is g_ for p, g_ in zip(trainer.state.params(), trainer.train_graph.grads)):
            raise AssertionError("after eager steps a replay did not restore the graph's grads")
        path = path_line(f"train step B={TRAIN_B} bf16", graphed, eager, device_ms, tag)
        epochs = time_epoch_paths(trainer, cfg.seed, tag)
    return {"run_counts": run_counts, "step_ms": path["graphed_ms"], "per_step": per_step,
            "path": path, "epochs": epochs, "persistent": persistent}


def time_epoch_paths(trainer, seed: int, tag: str) -> dict:
    """Phase 7: host ms/step of the two epoch paths, graphed (median of 5
    epochs): the device-resident epoch and the per-batch loop over the
    loader (its gather and the batch's upload in every step), beside the
    device's ms a replay of each step, the two read one after the other."""
    scan = trainer.epoch_scan

    def scan_epoch():
        scan.start_epoch(seed, trainer.state.step // scan.n_batches)
        for _ in range(scan.n_batches):
            trainer.scan_step(scan)

    def loop_epoch():
        for b in trainer.train_loader:
            trainer.train_step(b)

    if len(trainer.train_loader) != scan.n_batches:
        raise AssertionError("the two epoch paths take different step counts")
    runs = {"scan": host_ms(scan_epoch, scan.n_batches), "loop": host_ms(loop_epoch, scan.n_batches)}
    device = {"scan": trainer.scan_graph.device_ms(10), "loop": trainer.train_graph.device_ms(10)}
    med = {k: float(np.median(v)) for k, v in runs.items()}
    print(f"epoch paths B={TRAIN_B} bf16, host ms/step (median of 5 epochs of {scan.n_batches} "
          f"steps): device-resident {med['scan']:.3f} (runs "
          f"{' '.join(f'{r:.3f}' for r in runs['scan'])}), per-batch loop {med['loop']:.3f} (runs "
          f"{' '.join(f'{r:.3f}' for r in runs['loop'])}); device {device['scan']:.3f} / "
          f"{device['loop']:.3f} ms a replay; host / device {med['scan'] / device['scan']:.3f} / "
          f"{med['loop'] / device['loop']:.3f} [{tag}]")
    return {"scan_ms": med["scan"], "loop_ms": med["loop"], "scan_device_ms": device["scan"],
            "loop_device_ms": device["loop"], "scan_runs": runs["scan"], "loop_runs": runs["loop"]}


class ScanOrder:
    """The per-batch loop's batches in a device-resident epoch's order,
    gathered and scaled on the host as the loader does."""

    def __init__(self, scan, dataset, seed: int, state):
        self.scan, self.dataset, self.seed, self.state = scan, dataset, seed, state

    def __iter__(self):
        for row in self.scan.permutation(self.seed, self.state.step // self.scan.n_batches):
            yield {"image": scale_to_minus_one_one(self.dataset.images[row]),
                   "label": self.dataset.labels[row]}


def differing_weights(a, b) -> list:
    """The names of the model and EMA tensors in which two trainers differ."""
    out = []
    for part in ("model", "ema"):
        other = getattr(b.state, part).state_dict()
        out += [f"{part}.{k}" for k, v in getattr(a.state, part).state_dict().items()
                if not torch.equal(v, other[k])]
    return out


def check_epoch_paths(config) -> dict:
    """Phase 7: one epoch (3 eager warm-up steps, 6 replayed) through the
    device-resident epoch and through the per-batch loop fed the same
    permutation, two trainers from the same seeded weights: the epoch's loss
    and grad norm and every model and EMA tensor bit for bit.  Both run the
    same draws and, after the gather, the same captured step; the scaling
    table makes x0 equal."""
    with tempfile.TemporaryDirectory() as workdir:
        cfg = dataclasses.replace(config, workdir=workdir, epochs=1,
                                  data=dataclasses.replace(config.data,
                                                           synthetic_size=SYNTHETIC_SIZE))
        scanned = train.build_trainer(cfg, DEV)
        looped = train.build_trainer(dataclasses.replace(cfg, scan_epochs=False), DEV)
        looped.train_loader = ScanOrder(scanned.epoch_scan, scanned.train_loader.dataset,
                                        cfg.seed, looped.state)
        losses = (scanned._train_epoch(), looped._train_epoch())
        gnorms = (scanned._last_grad_norm, looped._last_grad_norm)
    counts = (scanned.step_counts, looped.step_counts)
    if (scanned.scan_graph is None or looped.train_graph is None
            or counts != ({"graphed": 6, "eager": WARMUP_STEPS},) * 2):
        raise AssertionError(f"the epoch paths did not replay their graphs: {counts}")
    diff = differing_weights(scanned, looped)
    print(f"device-resident epoch vs per-batch loop, same permutation, B={TRAIN_B} bf16: loss "
          f"{losses[0]!r} / {losses[1]!r}, grad norm {gnorms[0]!r} / {gnorms[1]!r}; {len(diff)} "
          f"of the model and EMA tensors differ {diff[:4]}")
    if losses[0] != losses[1] or gnorms[0] != gnorms[1] or diff:
        raise AssertionError("the device-resident epoch differs from the per-batch loop")
    return {"bit_identical": True, "loss": losses[0]}


def percentile(values, q: float) -> float:
    """The service's own rule: the value at index int(len * q) of the sorted list."""
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


def time_batches(svc) -> list:
    """Wrap the started service's sampler in CUDA events on the batcher
    thread's stream; returns the list of (start, end) pairs, one a batch."""
    spans, sample_fn = [], svc.sample_fn

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sample_fn(*args)
        end.record()
        spans.append((start, end))
        return out

    svc.sample_fn = timed
    return spans


def device_timeline(spans) -> dict:
    """The device's side of a run's batches: its ms a batch back to back
    (median) and its busy share between the first batch's start and the last
    one's end (the gaps hold the uploads, the uint8 packing and any idle)."""
    torch.cuda.synchronize()
    busy = [s.elapsed_time(e) for s, e in spans]
    span = spans[0][0].elapsed_time(spans[-1][1])
    return {"device_ms_per_batch_served": float(np.median(busy)),
            "device_busy_share": sum(busy) / span, "device_span_s": span / 1e3}


def saturate(svc, spans: list, clients: int = 8, images: int = 2048, n: int = 32) -> dict:
    """``images`` images from ``clients`` threads, each submitting requests of
    ``n`` mixed classes one after another: img/s over the wall time, the
    padded share of the slots, latency p50 / p95 (client side) and the
    batcher's host ms a batch, from the service's counters around the run,
    and the device's timeline of the run's batches from ``spans``."""
    per_client = images // (clients * n)
    lat, errors = [], []

    def client(k: int):
        for r in range(per_client):
            ids = ((np.arange(n) + k + r) % 10).tolist()
            t = time.perf_counter()
            try:
                out = svc.submit(ids, n=n, seed=1000 * k + r).result(timeout=600)
                if out.shape != (n, 32, 32, 3):
                    errors.append(out.shape)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
            lat.append(time.perf_counter() - t)

    s0, k0 = svc.stats(), len(spans)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    s1 = svc.stats()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"saturated run: {errors[:3]}")
    batches = s1.batches - s0.batches
    if len(spans) - k0 != batches:
        raise AssertionError(f"{len(spans) - k0} batches timed of {batches}")
    host = s1.host_ms_per_batch * s1.batches - s0.host_ms_per_batch * s0.batches
    return {"images": clients * per_client * n, "clients": clients, "n": n, "wall_s": wall,
            "img_s": clients * per_client * n / wall, "batches": batches,
            "padded_share": (s1.padded_slots - s0.padded_slots) / (batches * svc.batch_size),
            "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
            "host_ms_per_batch": host / batches, **device_timeline(spans[k0:])}


def under_load(svc, clients: int = 16) -> tuple:
    """The reference request submitted while ``clients`` threads send three
    requests each of mixed n and classes; returns its images and the load's
    image count."""
    rng = np.random.default_rng(7)
    plans = [[(int(rng.integers(1, 25)), int(rng.integers(0, 10)), int(rng.integers(1, 2**30)))
              for _ in range(3)] for _ in range(clients)]
    done, errors = [], []

    def client(plan):
        for n, c, seed in plan:
            try:
                done.append(svc.submit(((np.arange(n) + c) % 10).tolist(), n=n,
                                       seed=seed).result(timeout=600).shape[0])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(p,)) for p in plans]
    for t in threads:
        t.start()
    time.sleep(0.05)  # the clients' first requests are queued
    images = svc.submit(REF_CLASSES, n=10, seed=REF_SEED).result(timeout=600)
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"load clients: {errors[:3]}")
    return images, sum(done)


def via_http(svc) -> np.ndarray:
    """The reference request through POST /generate (npy) on 127.0.0.1."""
    server = GenerationHTTPServer(svc, host="127.0.0.1", port=0).start()
    try:
        body = json.dumps({"class_id": REF_CLASSES, "n": 10, "seed": REF_SEED,
                           "format": "npy"}).encode()
        req = urllib.request.Request(server.address + "/generate", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
    finally:
        server.stop()
    return np.stack([np.load(io.BytesIO(base64.b64decode(b))) for b in out["images"]])


def serve(config, ckpt: str, sampler: str, sampler_steps: int, steps: int, tag: str,
          checks: bool, blocks: int = 8, norms: int = GN_PIXEL, decode_norms: int = 0,
          sites=None) -> dict:
    """One service over ``ckpt`` at B=64; every count set to 0 before it is
    built and read after it stopped.  ``checks``: the reference request alone,
    under load and through HTTP, light load and the drain; always the
    saturated run.  ``blocks``: the UNet's attention blocks, each one launch
    of the forward kernel a sampler step; ``norms``: its GroupNorm calls, each
    one launch of the GroupNorm pass a step; ``decode_norms``: the VAE
    decoder's, once a batch; ``sites``: the UNet's attention sites, whose
    forward launches on the persistent path are checked at 2B (CFG)."""
    zero_counts()
    svc = build_generation_service(config, ckpt, sampler=sampler, ddim_steps=sampler_steps,
                                   batch_size=SERVE_B)
    if svc._slotq is None:
        raise AssertionError("the native slot queue did not load")
    t0 = time.perf_counter()
    svc.start(warmup=True)
    out = {"start_s": time.perf_counter() - t0}
    spans = time_batches(svc)  # after the capture: the workers record outside it
    drained = []
    try:
        if checks:
            out["alone"] = svc.submit(REF_CLASSES, n=10, seed=REF_SEED).result(timeout=600)
            out["under_load"], out["load_images"] = under_load(svc)
            out["http"] = via_http(svc)
        out["saturated"] = saturate(svc, spans)
        if checks:
            lat = []
            s0 = svc.stats()
            for i in range(10):
                t = time.perf_counter()
                svc.submit(i % 10, n=1, seed=5000 + i).result(timeout=600)
                lat.append(time.perf_counter() - t)
            s1 = svc.stats()
            out["light_p50_s"], out["light_runs_s"] = percentile(lat, 0.5), lat
            # the batcher's time a batch on an idle card: its launches still
            # wait for room in the stream's queue once that is full
            out["light_host_ms_per_batch"] = (
                s1.host_ms_per_batch * s1.batches - s0.host_ms_per_batch * s0.batches) / (
                s1.batches - s0.batches)
            drained = [svc.submit(c, n=5, seed=100 + c) for c in range(6)]
    finally:
        svc.stop()
    out["counts"], out["batches"] = read_counts(), svc.stats().batches
    if not all(f.done() and f.result(timeout=1).shape == (5, 32, 32, 3) for f in drained):
        raise AssertionError("stop() left a drained request unresolved")
    forwards = steps * out["batches"] + WARMUP_STEPS
    want = blocks * forwards
    want_gn = norms * forwards + decode_norms * out["batches"]
    print(f"serving {sampler}-{steps}: {out['batches']} batches of {SERVE_B} (the warm-up's "
          f"included); kernel launches {out['counts']} (want {want} of the forward kernel: "
          f"{blocks} x "
          f"({steps} x {out['batches']} + {WARMUP_STEPS} warm-up steps), {want_gn} of the "
          f"GroupNorm pass: {norms} a step, {decode_norms} a batch's decode, and no other)"
          f"{'; stop() resolved the 6 requests it drained' if drained else ''}")
    if out["counts"] != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": want,
                                                     "group_norm_silu": want_gn}:
        raise AssertionError(f"the {sampler} service launched {out['counts']}")
    if sites is not None:
        out["persistent"] = check_persistent(want, 2 * SERVE_B, sites,
                                             f"serving {sampler}-{steps} at B={SERVE_B}")
    return out


def check_serving(config, tag: str) -> dict:
    """Phase 7b: the serving slice at full width, B=64, CFG 3, bf16: DDIM-50
    with every check, then DPM-Solver++-15 saturated."""
    host = GaussianDiffusion(T_STEPS)
    steps = {"ddim": len(host.ddim_timesteps(50)[0]), "dpmpp": len(host._dpmpp_coeffs(15)[0])}
    cfg = config.diffusion.cfg_scale
    dt = "bf16" if config.use_amp else "fp32"
    shape = (32, 32, 3)
    with tempfile.TemporaryDirectory() as d:
        ckpt = seeded_checkpoint(config, os.path.join(d, "diffusion_model_ema.pt"))
        runs = {"ddim": serve(config, ckpt, "ddim", 50, steps["ddim"], tag, checks=True,
                              sites=SITES),
                "dpmpp": serve(config, ckpt, "dpmpp", 15, steps["dpmpp"], tag, checks=False,
                               sites=SITES)}
        # the reference: sample_ddim at B=64 on the x_T the service gave the
        # request alone (slots 0-9; the pad slots' seed 0, index 0, class 0)
        model, diffusion = load_sampler(config, ckpt, device=DEV)
        pads = SERVE_B - 10
        seeds = np.array([REF_SEED] * 10 + [0] * pads, np.int32)
        idxs = np.array(list(range(10)) + [0] * pads, np.int32)
        x_init, _ = slot_x_init(seeds, idxs, shape)
        classes = torch.tensor(REF_CLASSES + [0] * pads, device=DEV)
        kw = dict(cfg_scale=cfg, null_label=model.null_label, x_init=x_init,
                  generator=torch.Generator(device=DEV).manual_seed(0))
        x0 = diffusion.sample_ddim(model, classes, shape, n_sample_steps=50, eta=0.0, **kw)
        reference = reverse_transform(x0.cpu().numpy())[:10]
        device_ms = {"ddim": diffusion.sampler_graphs()[-1].device_ms(20)}
        diffusion.sample_dpmpp(model, classes, shape, n_sample_steps=15, **kw)
        device_ms["dpmpp"] = diffusion.sampler_graphs()[-1].device_ms(20)
        # a repeated call at a served shape, its inputs on the card, waits for
        # the device nowhere: the service's batcher keeps the queue full
        kw.update(x_init=x_init.to(DEV), generator=torch.Generator(device=DEV).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            diffusion.sample_ddim(model, classes, shape, n_sample_steps=50, eta=0.0, **kw)
            diffusion.sample_dpmpp(model, classes, shape, n_sample_steps=15, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print("a repeated sample_ddim / sample_dpmpp call at B=64 under "
              "torch.cuda.set_sync_debug_mode('error'): no host sync")
    d = runs["ddim"]
    alone = d["alone"]
    off = np.abs(alone.astype(np.int32) - d["under_load"].astype(np.int32))
    checks = {"alone == under load": np.array_equal(alone, d["under_load"]),
              f"alone == sample_ddim B={SERVE_B}": np.array_equal(alone, reference),
              "alone == POST /generate npy": np.array_equal(alone, d["http"])}
    print(f"serving ddim-{steps['ddim']} B={SERVE_B} CFG {cfg} {dt}: the 10-image request (seed {REF_SEED}) "
          f"alone, under {d['load_images']} images of 16 concurrent clients, through HTTP and "
          f"against sample_ddim: {checks}; alone vs under load: {int((off > 0).sum())} pixels "
          f"differ, by at most {int(off.max())}; images {alone.shape} {alone.dtype}, values "
          f"{int(alone.min())}-{int(alone.max())}")
    if not all(checks.values()) or alone.shape != (10,) + shape or len(np.unique(alone)) < 50:
        raise AssertionError(f"serving checks failed: {checks}")
    out = {}
    for name, r in runs.items():
        sat = r["saturated"]
        dev_batch = steps[name] * device_ms[name]
        print(f"serving {name}-{steps[name]} B={SERVE_B} CFG {cfg} {dt}, saturated ({sat['images']} "
              f"images from {sat['clients']} clients, n={sat['n']}): {sat['img_s']:.3f} img/s "
              f"({sat['wall_s']:.3f} s, {sat['batches']} batches), padded share "
              f"{sat['padded_share']:.4f}, latency p50 {sat['latency_p50_s']:.4f} s p95 "
              f"{sat['latency_p95_s']:.4f} s; host {sat['host_ms_per_batch']:.3f} ms a batch (the "
              f"batcher's) against the device's {dev_batch:.3f} ({steps[name]} x "
              f"{device_ms[name]:.4f} ms a replay), device-bound {SERVE_B / dev_batch * 1e3:.3f} "
              f"img/s; served, the device {sat['device_ms_per_batch_served']:.3f} ms a batch "
              f"(median), busy {sat['device_busy_share']:.4f} of its {sat['device_span_s']:.3f} s "
              f"from the first batch's start to the last one's end; start with warm-up and "
              f"capture {r['start_s']:.3f} s [{tag}]")
        out[name] = {**sat, "steps": steps[name], "device_ms_per_replay": device_ms[name],
                     "device_ms_per_batch": dev_batch, "device_bound_img_s":
                     SERVE_B / dev_batch * 1e3, "launches": r["counts"]["linear_attention_fwd"],
                     "gn_launches": r["counts"]["group_norm_silu"],
                     "persistent": r["persistent"],
                     "batches_served": r["batches"], "start_s": r["start_s"]}
    x_init_ms = host_x_init_ms(shape)
    print(f"serving ddim-{steps['ddim']} light load, ten 1-image requests one at a time: latency p50 "
          f"{d['light_p50_s']:.4f} s (runs {' '.join(f'{v:.4f}' for v in d['light_runs_s'])}); "
          f"the batcher's time {d['light_host_ms_per_batch']:.3f} ms a batch on an idle card (its "
          f"launches wait for room in the stream's queue); the host's x_T draws for {SERVE_B} "
          f"slots {x_init_ms:.3f} ms (median of 20) [{tag}]")
    out["ddim"]["light_p50_s"] = d["light_p50_s"]
    out["ddim"]["light_host_ms_per_batch"] = d["light_host_ms_per_batch"]
    out["x_init_ms"] = x_init_ms
    return out


def host_x_init_ms(shape, runs: int = 20) -> float:
    """The batcher's own work of drawing a batch's x_T on the host (one CPU
    generator a slot), in ms, median of ``runs``."""
    seeds, idxs = np.arange(SERVE_B, dtype=np.int32), np.zeros(SERVE_B, np.int32)
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        slot_x_init(seeds, idxs, shape)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def seeded_pair(config, seed: int = 0):
    """A kernel-path and a plain-path UNet with the same random weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        m_kernel = build_model(config, DEV).eval()
    m_plain = build_model(config, DEV, attention_impl="torch").eval()
    m_plain.load_state_dict(m_kernel.state_dict(), strict=True)
    return m_kernel, m_plain


def check_unet(config) -> None:
    """Phase 5: parameter count; kernel-path vs plain-path forward."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(20, 32, 32, 3, generator=g).to(DEV)
    t = torch.randint(0, T_STEPS, (20,), generator=g).to(DEV)
    y = torch.cat([torch.arange(10), torch.full((10,), 10)]).to(DEV)
    for use_amp in (False, True):
        m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=use_amp))
        n = sum(p.numel() for p in m_kernel.parameters())
        if n != N_PARAMS:
            raise AssertionError(f"UNet has {n} parameters, want {N_PARAMS}")
        with torch.inference_mode():
            ek, ep = m_kernel(x, t, y), m_plain(x, t, y)
        err = (ek - ep).abs().max().item()
        dt = "bf16" if use_amp else "fp32"
        print(f"full-width UNet ({n} parameters) 2B=20 {dt}: kernel path vs plain "
              f"path max_abs_err {err:.3e}, |eps| max {ep.abs().max().item():.3f}")
        if not torch.isfinite(ek).all():
            raise AssertionError(f"{dt} UNet output not finite")
        if not use_amp and err > UNET_FP32_TOL:
            raise AssertionError(f"fp32 UNet kernel vs plain err {err} > {UNET_FP32_TOL}")


def check_unet_64px(config) -> None:
    """Phase 5, 64px: the full-width UNet's forward at the shape of
    configs/protocol_hard_64.yaml (attention sites (4096, 64), (1024, 128),
    (256, 256), (64, 512)), 2B=4, kernel path vs plain path."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4, 64, 64, 3, generator=g).to(DEV)
    t = torch.randint(0, T_STEPS, (4,), generator=g).to(DEV)
    y = torch.tensor([3, 7, 10, 10]).to(DEV)
    for use_amp in (False, True):
        m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=use_amp), seed=8)
        with torch.inference_mode():
            ek, ep = m_kernel(x, t, y), m_plain(x, t, y)
        err = (ek - ep).abs().max().item()
        dt = "bf16" if use_amp else "fp32"
        print(f"full-width UNet at 64px 2B=4 {dt}: kernel path vs plain path max_abs_err "
              f"{err:.3e}, |eps| max {ep.abs().max().item():.3f}")
        if ek.shape != (4, 64, 64, 3) or not torch.isfinite(ek).all():
            raise AssertionError(f"{dt} 64px UNet output {ek.shape} not finite")
        if not use_amp and err > UNET_FP32_TOL:
            raise AssertionError(f"fp32 64px UNet kernel vs plain err {err} > {UNET_FP32_TOL}")


def check_trajectory(config) -> None:
    """Short fp32 CFG trajectories, same weights, same injected x_T: the
    ancestral sampler graphed (the injected noise copied into the graph's
    fixed buffer) vs eager vs the plain path; DDIM eta=0 and DPM-Solver++
    graphed vs eager."""
    m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=False), seed=2)
    diffusion = GaussianDiffusion(10, device=DEV)
    g = torch.Generator().manual_seed(3)
    x_init = torch.randn(2, 32, 32, 3, generator=g)
    noise = torch.randn(10, 2, 32, 32, 3, generator=g).to(DEV)
    classes = torch.tensor([3, 7], device=DEV)
    kw = dict(cfg_scale=3.0, null_label=10, x_init=x_init)
    shape = (32, 32, 3)
    graphed = diffusion.sample(m_kernel, classes, shape, noise=lambda t: noise[t], graph=True, **kw)
    eager = diffusion.sample(m_kernel, classes, shape, noise=lambda t: noise[t], **kw)
    plain = diffusion.sample(m_plain, classes, shape, noise=lambda t: noise[t], **kw)
    errs = {"ancestral graphed vs eager": (graphed - eager).abs().max().item(),
            "ancestral graphed vs plain path": (graphed - plain).abs().max().item()}
    for name, fn in (("DDIM eta=0", diffusion.sample_ddim), ("DPM-Solver++", diffusion.sample_dpmpp)):
        a = fn(m_kernel, classes, shape, n_sample_steps=5, graph=True, **kw)
        b = fn(m_kernel, classes, shape, n_sample_steps=5, graph=False, **kw)
        errs[f"{name} (5 steps) graphed vs eager"] = (a - b).abs().max().item()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} trajectory not finite")
    print("fp32 CFG trajectories B=2, T=10, max_abs_err: "
          + "; ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if not torch.isfinite(graphed).all() or max(errs.values()) > UNET_FP32_TOL:
        raise AssertionError(f"trajectory errs {errs}")


def check_requests(config, tag: str) -> dict:
    """Phase 6, the requests through generate.main at B=10, bf16, as
    replayed graphs: ancestral T=400, DDIM-50, DPM-Solver++-15.  Counts set
    to 0 before each, read after: the forward kernel 8 x (the sampler's
    steps + the warm-up steps before the capture) times, no other kernel."""
    host = GaussianDiffusion(T_STEPS)  # the samplers' step tables, on the host
    requests = [("ddpm", [], T_STEPS),
                ("ddim", ["--sampler", "ddim", "--ddim-steps", "50"],
                 len(host.ddim_timesteps(50)[0])),
                ("dpmpp", ["--sampler", "dpmpp", "--ddim-steps", "15"],
                 len(host._dpmpp_coeffs(15)[0]))]
    out = {}
    for name, extra, steps in requests:
        with tempfile.TemporaryDirectory() as d:
            path = seeded_run(d, FLAGSHIP)
            zero_counts()
            res = generate.main([path, "--per-class", "1", "--device", "cuda",
                                 "--out", os.path.join(d, "x.npy"), *extra])
            counts = read_counts()
        want = 8 * (steps + WARMUP_STEPS)
        want_gn = GN_PIXEL * (steps + WARMUP_STEPS)
        print(f"kernel launches in the {name} request of {steps} steps: {counts} (want {want} "
              f"of the forward kernel: 8 x ({steps} replayed + {WARMUP_STEPS} warm-up steps), "
              f"{want_gn} of the GroupNorm pass: one a GroupNorm module a step, and no other)")
        if counts != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": want,
                                                  "group_norm_silu": want_gn}:
            raise AssertionError(f"the {name} request launched {counts}")
        persistent = check_persistent(want, 20, SITES, f"the {name} request (2B=20)")
        if res.images.dtype != np.uint8 or res.images.shape != (10, 32, 32, 3):
            raise AssertionError(f"images {res.images.dtype} {res.images.shape}")
        if not np.isfinite(res.x0).all():
            raise AssertionError("x0 not finite")
        print(f"request {name} {steps} steps CFG 3 B=10 bf16: {10 / res.seconds:.3f} img/s "
              f"({res.seconds:.3f} s of which warm-up and capture {res.capture_seconds:.3f} s; "
              f"x0 in [{res.x0.min():.3f}, {res.x0.max():.3f}]) [{tag}]")
        out[name] = {"counts": counts, "steps": steps, "seconds": res.seconds,
                     "capture_seconds": res.capture_seconds, "persistent": persistent}
    return out


def check_sampler_persistent(model, b: int, tag: str) -> dict:
    """The pixel sampler at the benchmark's batch: 20 ancestral CFG steps
    at batch ``b`` (2B in the UNet) as replayed graphs, bf16; its forward
    launches, and those on the persistent path."""
    diffusion = GaussianDiffusion(20, device=DEV)
    classes = (torch.arange(b) % 10).to(DEV)
    zero_counts()
    diffusion.sample(model, classes, (32, 32, 3), cfg_scale=3.0, null_label=model.null_label,
                     generator=torch.Generator(device=DEV).manual_seed(0), graph=True)
    torch.cuda.synchronize()
    counts = read_counts()
    want = len(SITES) * (20 + WARMUP_STEPS)
    if counts["linear_attention_fwd"] != want:
        raise AssertionError(f"sampler B={b} launched {counts}, want {want} forwards")
    return check_persistent(want, 2 * b, SITES, f"the pixel sampler B={b} (2B={2 * b}), "
                            f"20 steps as replayed graphs [{tag}]")


def check_sampler_speed(model, b: int, tag: str, shape=(32, 32, 3), schedule="linear",
                        name="sampler") -> dict:
    """Host ms/step of 20 ancestral CFG sampler steps at batch ``b`` (bf16),
    graphed and eager, and the device's time for one replay; ``shape`` and
    ``schedule``: the latent UNet's."""
    diffusion = GaussianDiffusion(20, schedule=schedule, device=DEV)
    classes = (torch.arange(b) % 10).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)

    def run(graph: bool):
        diffusion.sample(model, classes, shape, cfg_scale=3.0,
                         null_label=model.null_label, generator=gen, graph=graph)

    runs = {}
    for graph in (True, False):
        run(graph)  # warm-up, and the capture
        runs[graph] = host_ms(lambda: run(graph), 20)
    (captured,) = diffusion.sampler_graphs()
    if captured.graph.replays != 6 * 20:
        raise AssertionError(f"{captured.graph.replays} replays in 6 runs of 20 steps")
    device_ms = captured.device_ms(20)
    return path_line(f"{name} B={b} (2B={2 * b}) bf16", runs[True], runs[False], device_ms, tag)


def rb_inputs(b: int, site: str, side: int, cin: int, cout: int, dtype, seed: int):
    """The block's arguments at one site (probe13's recipe); zero time rows
    for the head block.  Returns (args, keyword arguments)."""
    args, use_sc = probe13.site_args(b, side, cin, cout, dtype, DEV, seed=seed)
    if site == "head":
        args = (args[0], torch.zeros_like(args[1])) + args[2:]
    return args, dict(groups=8, compute_dtype=dtype, use_shortcut=use_sc)


def conv_products(args, use_sc: bool):
    """The block's products alone as PyTorch calls in bf16, channels_last: two
    3x3 convolutions and the 1x1 where C_in != C_out.  A yardstick for the
    kernel's time that the port never calls."""
    dt, cl = torch.bfloat16, torch.channels_last
    x = args[0].permute(0, 3, 1, 2)  # NHWC storage as a channels_last NCHW view
    w1 = args[4].to(dt).permute(3, 2, 0, 1).contiguous(memory_format=cl)
    w2 = args[8].to(dt).permute(3, 2, 0, 1).contiguous(memory_format=cl)
    ws = args[10].to(dt).t()[:, :, None, None].contiguous(memory_format=cl) if use_sc else None

    def run():
        y = F.conv2d(F.conv2d(x, w1, padding=1), w2, padding=1)
        return y + F.conv2d(x, ws) if use_sc else y

    return run


def check_resnet_block(tag: str) -> dict:
    """Phase 8: the ResNet-block kernel vs plain at the 11 flagship sites
    (2B=20, 2B=128), probe13's sites (2B=256), the 64px site (2B=4) and the
    edge cases; timings at 2B=128 and 2B=20 bf16."""
    cases = [(b, site) for b in (20, 128) for site in RB_SITES]
    cases += [(probe13.B, site) for site in probe13.SITES]
    cases += [(4, ("64px-l0", 64, 64, 64))] + RB_EDGE_CASES
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    splits = set()
    for dtype in (torch.float32, torch.bfloat16):
        for b, (site, side, cin, cout) in cases:
            args, kw = rb_inputs(b, site, side, cin, cout, dtype, seed=b + side + cin + cout)
            with torch.inference_mode():
                got = rb.resnet_block(*args, **kw)
                again = rb.resnet_block(*args, **kw)
                want = rb.resnet_block_torch(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            plan = rb.plan_resnet(b, side, side, cin, cout, dtype)
            splits |= {plan.split1, plan.split2}
            print(f"resnet kernel vs plain {site} ({side}x{side}, {cin}->{cout}) 2B={b} "
                  f"{str(dtype)[6:]} [{plan.m_tiles} x {plan.n_tiles} tiles, {plan.split1} / "
                  f"{plan.split2} CTAs a tile in conv1 / conv2, {plan.ctas(1)} / {plan.ctas(2)} "
                  f"CTAs, {max(plan.smem1, plan.smem2)} B shared]: max_abs_err {err:.3e}, "
                  f"max|plain| {scale:.3e} (tol {RB_TOL[dtype]:g} x max|plain|, ratio "
                  f"{err / scale:.2e}; bit-identical rerun)")
            if not (torch.isfinite(got).all() and err <= RB_TOL[dtype] * scale):
                raise AssertionError(f"resnet {site} 2B={b} {dtype}: err {err}, scale {scale}")
            if not torch.equal(got, again):
                raise AssertionError(f"resnet {site} 2B={b} {dtype}: not deterministic")
            worst[dtype] = max(worst[dtype], err / scale)
    if not {1, 2, 4, 8} <= splits:
        raise AssertionError(f"the cases took only the splits {sorted(splits)}")

    # device time by CUDA-graph replay: a block is three short launches, and
    # eager timing would read the host's launch cost
    sums = {}
    bounds = []
    for b in (128, 20):
        ms = plain_ms = lib_ms = 0.0
        for i, (site, side, cin, cout) in enumerate(RB_SITES):
            args, kw = rb_inputs(b, site, side, cin, cout, torch.bfloat16, seed=i)
            with torch.inference_mode():
                k = cuda_graph_ms(lambda: rb.resnet_block(*args, **kw))
                t = cuda_graph_ms(lambda: rb.resnet_block_torch(*args, **kw), iters=10)
                lib = cuda_graph_ms(conv_products(args, kw["use_shortcut"]), iters=10)
            bd = rb_bound(b, side, cin, cout)
            if b == 128:
                bounds.append(bd)
            ms, plain_ms, lib_ms = ms + k, plain_ms + t, lib_ms + lib
            print(f"time resnet {site} ({side}x{side}, {cin}->{cout}) 2B={b} bf16: kernel "
                  f"{k:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}, plain "
                  f"{t:.4f} ms, its products alone as cuDNN convolutions {lib:.4f} ms [{tag}]")
        sums[b] = (ms, plain_ms, lib_ms)
        print(f"time resnet all 11 sites 2B={b} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, products alone as cuDNN convolutions {lib_ms:.4f} ms [{tag}]")
    total = add_bounds(*bounds)
    print(f"bound of the 11 sites at 2B=128: {total['bound_ms']:.4f} ms by {total['bound_by']}")
    return {"max_rel_err": worst[torch.bfloat16], "max_rel_err_fp32": worst[torch.float32],
            "ms": sums[128][0], "plain_ms": sums[128][1], "conv_library_ms": sums[128][2],
            "ms_2b20": sums[20][0], "plain_ms_2b20": sums[20][1],
            "conv_library_ms_2b20": sums[20][2], **total}


def check_resnet_block_fn() -> int:
    """Phase 8, gradients: ResNetBlockFn at B=8 on the decoder site
    (16x16, 192->64), fp32: the kernel forward and the recomputed backward
    against plain autograd of resnet_block_torch; returns the launches."""
    args, kw = rb_inputs(8, "dec2", 16, 192, 64, torch.float32, seed=7)
    dy = torch.randn(8, 16, 16, 64, generator=torch.Generator().manual_seed(8)).to(DEV)
    grads = []
    before = registry.read(rb.LIB.name)
    for fn in (rb.resnet_block, rb.resnet_block_torch):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        y = fn(*leaves, **kw)
        (y * dy).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    torch.cuda.synchronize()
    launches = registry.read(rb.LIB.name) - before
    names = ("x", "temb", "n1s", "n1b", "w1", "b1", "n2s", "n2b", "w2", "b2", "ws", "bs")
    worst = 0.0
    for name, g, w in zip(names, *grads):
        rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not torch.isfinite(g).all() or rel > RB_TOL[torch.float32]:
            raise AssertionError(f"ResNetBlockFn grad {name}: {rel} x max|grad|")
    print(f"ResNetBlockFn B=8 (16x16, 192->64) fp32: gradients of x, temb and the 10 "
          f"weights vs plain autograd, worst max_abs_err / max|grad| {worst:.3e}; kernel "
          f"launches {launches} (want 1)")
    if launches != 1:
        raise AssertionError(f"ResNetBlockFn launched the kernel {launches} times")
    return launches


def check_probes() -> dict:
    """Phase 9: the probes' own libraries built and read as phase 2 reads
    the production set, then the three probe entry points, each one's
    launches counted from 0."""
    t0 = time.perf_counter()
    built = build.build("resnet_block_probe", "linear_attention_fwd_probe")
    print_build(built)
    print(f"probe build wall time {time.perf_counter() - t0:.1f} s (compiled in parallel)")
    check_sass(built)
    before = registry.read(rb.LIB.name)
    rows13 = probe13.main(["--iters", "5"])
    launches13 = registry.read(rb.LIB.name) - before
    for r in rows13:
        if r["launches"] < 1 or not r["rel_err"] <= RB_TOL[torch.bfloat16]:
            raise AssertionError(f"probe13 {r}")

    before = registry.read(probe13b.LIB.name)
    rows13b = probe13b.main(["--iters", "5"])
    launches13b = registry.read(probe13b.LIB.name) - before
    bad = [r["mode"] for r in rows13b if not r["ok"]]
    if bad or launches13b < len(probe13b.MODES):
        raise AssertionError(f"probe13b modes {bad} off their plain versions, "
                             f"{launches13b} launches")
    args, _ = probe13.site_args(8, 32, 64, 64, torch.bfloat16, DEV, seed=3)
    with torch.inference_mode():
        full = probe13b.probe_block("full", *args[:10])
        prod = rb.resnet_block(*args, groups=8, compute_dtype=torch.bfloat16)
    if not torch.equal(full, prod):
        raise AssertionError("probe13b full mode differs from the production kernel")
    print("probe13b full mode bit-identical to the production ResNet-block kernel (B=8)")

    before = registry.read(probe7.LIB.name)
    rows7 = probe7.main(["--iters", "5"])
    launches7 = registry.read(probe7.LIB.name) - before
    bad = [r["stage"] for r in rows7 if not r["ok"]]
    if bad or launches7 < len(probe7.STAGES):
        raise AssertionError(f"probe7 stages {bad} failed, {launches7} launches")
    return {"probe13": (rows13, launches13), "probe13b": (rows13b, launches13b),
            "probe7": (rows7, launches7)}


def write_config(path: str, base: str, **overrides) -> str:
    """``base`` with ``overrides`` (``data`` merged key by key), written as
    JSON (which YAML reads); ``configs/`` is not touched."""
    raw = dataclasses.asdict(load_config(base))
    raw["data"].update(overrides.pop("data", {}))
    raw.update(overrides)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def seeded_checkpoint(config, path: str) -> str:
    """The UNet of ``config`` with weights from its seed, as a state_dict."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        torch.save(build_model(config).state_dict(), path)
    return path


def seeded_run(workdir: str, base: str) -> str:
    """``base`` with its run directory under ``workdir``, and its UNet's
    weights from its seed where a trainer leaves the EMA weights (what
    ``generate`` reads by default); the config's path."""
    path = write_config(os.path.join(workdir, "run.json"), base, workdir=workdir)
    config = load_config(path)
    os.makedirs(config.checkpoints, exist_ok=True)
    seeded_checkpoint(config, checkpoint_path(config))
    return path


def protocol_config(family: str, workdir: str) -> str:
    """The family's config with the phase's overrides (2,560 synthetic
    images, one generator epoch, the run directory under ``workdir``),
    written as JSON (which YAML reads) beside it; ``configs/`` is not
    touched."""
    return write_config(os.path.join(workdir, f"protocol_{family}.yaml"), PROTOCOL[family],
                        workdir=workdir, epochs=1, sample_every=0,
                        data={"synthetic_size": PROTOCOL_SIZE})


def classifier_steps(n_real: int, n_synth: int, batch: int) -> dict:
    """The optimizer steps of each classifier experiment, from the size of
    its real / synthetic mix (the loaders drop the last batch): epochs x
    (size // batch); the broken control trains on a synthetic-sized set."""
    sizes = {name: int(fr * n_real) + int(fs * n_synth) for name, fr, fs in aug.EXPERIMENTS}
    sizes["exp2_broken"] = n_synth
    return {k: PROTOCOL_CLF_EPOCHS * (v // batch) for k, v in sizes.items()}


def protocol_launches(family: str, config, ddim_steps=None, negative_control=True) -> dict:
    """The launches each phase must make, from the shapes: Phase A's train
    steps (8 forward and 8 backward launches and one optimizer pass each)
    and validation batches (two forwards: CFG's lerp), Phase C's sampler
    steps over the chunks plus the warm-up steps before each capture (a Heun
    step is two forwards; ``ddim_steps``: the pixel DDPM's Phase C by DDIM at
    that many steps), the classifier phases no attention kernel and one
    optimizer pass a step (``classifier_steps``); the negative control's
    phases only with ``negative_control``.  The GroupNorm pass: GN_PIXEL a
    forward outside autograd (validation and Phase C), none in a train step."""
    n_train = int(0.9 * (PROTOCOL_SIZE // 2))
    steps = n_train // config.batch_size
    val_batches = (PROTOCOL_SIZE // 2 - n_train) // config.batch_size
    chunks = -(-10 * PROTOCOL_PER_CLASS // SAMPLE_B)
    if family == "flow":
        c_steps = c_broken = 25   # Heun-25, 2 forwards a step; broken: the other direction
        per = 16
    else:
        # ancestral T=400 (or DDIM); broken: DDIM-5, cfg 0
        c_steps, c_broken, per = ddim_steps or T_STEPS, 5, 8
    per_broken = per if family == "flow" else 8
    want = {"A": {"linear_attention_fwd": 8 * steps + 16 * val_batches,
                  "linear_attention_bwd": 8 * steps, "fused_adam_ema": steps,
                  "group_norm_silu": GN_PIXEL * 2 * val_batches},
            "C": {"linear_attention_fwd": per * (chunks * c_steps + WARMUP_STEPS),
                  "group_norm_silu": GN_PIXEL * per // 8 * (chunks * c_steps + WARMUP_STEPS)},
            "C_broken": {"linear_attention_fwd": per_broken * (chunks * c_broken
                                                                 + WARMUP_STEPS),
                         "group_norm_silu": GN_PIXEL * per_broken // 8
                         * (chunks * c_broken + WARMUP_STEPS)}}
    phases = ["A", "C", "C_broken"] + PROTOCOL_EXPS if negative_control else \
        ["A", "C"] + [name for name, _, _ in aug.EXPERIMENTS]
    for name, n in classifier_steps(n_train, 10 * PROTOCOL_PER_CLASS,
                                    config.batch_size).items():
        want[name] = {"fused_adam_ema": n}
    return {phase: {"linear_attention_fwd": 0, "linear_attention_bwd": 0,
                    "resnet_block_fwd": 0, "fused_adam_ema": 0, "group_norm_silu": 0}
            | want.get(phase, {}) for phase in phases}


def rerun_exp2(result, config) -> None:
    """exp2 (the classifier on the synthetic set alone) retrained twice
    through the protocol's own trainer: the protocol's F1 both times, and
    the two runs' weights and BatchNorm buffers bit-identical (``reset``
    restarts the validation loader's shuffle, so a rerun sees the passes the
    protocol's exp2 saw)."""
    rt = result.classifier_trainer
    synth = result.synthetic
    exp2 = aug._mix(synth, synth, 0.0, 1.0, aug._exp_seed(config.seed, "exp2"))
    states, f1s = [], []
    for i in range(2):
        rt.reset(seed=aug._exp_seed(config.seed, "exp2"), name=f"resnet_exp2_rerun{i}")
        rt.set_train_data(exp2)
        rt.train()
        f1s.append(rt.test()["f1_micro"])
        states.append({k: v.clone() for k, v in rt.model.state_dict().items()})
    differ = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    print(f"exp2 retrained twice: test F1 {f1s[0]!r}, {f1s[1]!r} (the protocol's "
          f"{result.test_f1['exp2']!r}); weights and BatchNorm buffers bit-identical: "
          f"{not differ}")
    if f1s != [result.test_f1["exp2"]] * 2 or differ:
        raise AssertionError(f"exp2 reruns: F1 {f1s}, differing tensors {differ[:5]}")


def rerun_chunk(result, config, sampler: str, ddim_steps: int) -> None:
    """Phase C's first chunk again, from the same state and the same
    generator: the same images, bit for bit."""
    dt = result.diffusion_trainer
    labels = result.synthetic.labels[:SAMPLE_B]
    n = len(labels)
    labels = np.concatenate([labels, np.zeros(SAMPLE_B - n, np.int32)])  # the tail's padding
    gen = step_generator(config.seed, aug.GENERATE_SALT, DEV, aug.GENERATE_SALT)
    again = dt.sample(labels, cfg_scale=config.diffusion.cfg_scale, generator=gen,
                      method=sampler, ddim_steps=ddim_steps)
    same = np.array_equal(again[:n], result.synthetic.images[:n])
    print(f"Phase C's first chunk ({n} images) again from the same state and "
          f"generator: bit-identical {same}")
    if not same:
        raise AssertionError("Phase C is not reproducible")


def classifier_trainer(dtype_amp: bool, graphs, workdir: str) -> ResNetTrainer:
    """The protocol's ResNet-18 on 640 synthetic 32px images at B=64, from
    the seed-0 init (reset)."""
    cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=dtype_amp, workdir=workdir,
                              loss_fn="cross-entropy", project_name="clf_check")
    ds = synthetic_dataset(SYNTHETIC_SIZE, 32, 3, train=True)
    return ResNetTrainer(cfg, build_classifier(cfg, 3, 10, device=DEV),
                         DataLoader(ds, TRAIN_B, seed=0), None, list(range(10)), device=DEV,
                         graphs=graphs)


def classifier_batches(n: int, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [{"image": torch.rand(TRAIN_B, 32, 32, 3, generator=g) * 2 - 1,
             "label": torch.randint(0, 10, (TRAIN_B,), generator=g)} for _ in range(n)]


def check_classifier_steps(tag: str) -> dict:
    """The classifier's step on the card: graphed against eager in fp32 (8
    steps, 3 eager warm-up and 5 replayed, from one init: losses and every
    weight within 1e-3 of its leaf's scale); then host ms a step graphed and
    eager (median of 5 runs of 10 steps) and the device's ms a replay at
    B=64 in bf16, under cuDNN's deterministic algorithms (the protocol's
    setting) and under its defaults; whether two runs under the defaults
    give the same weights (else the first parameter that differs)."""
    with tempfile.TemporaryDirectory() as workdir:
        graphed, eager = (classifier_trainer(False, g, workdir) for g in (None, False))
        worst = 0.0
        for step, b in enumerate(classifier_batches(8, 21)):
            la_, lb = graphed.train_step(b)["loss"].item(), eager.train_step(b)["loss"].item()
            worst = max(worst, abs(la_ - lb) / lb)
        others = dict(eager.model.named_parameters())
        w_err = max((p.detach() - others[n].detach()).abs().max().item()
                    / max(others[n].detach().abs().max().item(), 1e-6)
                    for n, p in graphed.model.named_parameters())
        print(f"classifier fp32, graphed vs eager over 8 steps "
              f"({graphed.step_counts['graphed']} replayed): worst loss difference "
              f"{worst:.2e} of the loss, weights within {w_err:.2e} of their leaf's max")
        if graphed.step_counts != {"graphed": 8 - WARMUP_STEPS, "eager": WARMUP_STEPS} or \
                worst > UNET_FP32_TOL or w_err > UNET_FP32_TOL:
            raise AssertionError(f"graphed classifier step off the eager one: {worst}, {w_err}")

        out = {}
        batches = classifier_batches(10, 22)
        for deterministic in (True, False):
            torch.backends.cudnn.deterministic = deterministic
            trainers = {g: classifier_trainer(True, g, workdir) for g in (None, False)}
            runs = {}
            for g, rt in trainers.items():
                for b in batches[:WARMUP_STEPS + 1]:
                    rt.train_step(b)  # warm-up and, graphed, the capture
                runs[g] = host_ms(lambda: [rt.train_step(b) for b in batches], len(batches))
            device_ms = trainers[None].train_graph.device_ms(20)
            name = f"classifier step B={TRAIN_B} ResNet-18 bf16, cudnn.deterministic=" \
                   f"{deterministic}"
            out[f"deterministic_{deterministic}"] = path_line(name, runs[None], runs[False],
                                                              device_ms, tag)
        # two eager runs under the defaults from one init on the same batches
        states = []
        for _ in range(2):
            rt = classifier_trainer(True, False, workdir)
            for b in batches:
                rt.train_step(b)
            states.append(rt.model.state_dict())
        differ = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
        out["default_bit_identical"] = not differ
        out["default_first_differing"] = differ[0] if differ else None
        print(f"two classifier runs of 10 steps under cuDNN's default algorithms: "
              f"bit-identical {not differ}"
              + (f"; the first tensor that differs: {differ[0]} ({len(differ)} differ)"
                 if differ else ""))
        torch.backends.cudnn.deterministic = False
    return out


def check_heun_trajectory(config) -> None:
    """A 10-step Heun trajectory (CFG 3, B=2, fp32, the flow's time scale):
    the kernel path graphed against the plain path and against the kernel
    path's eager loop, and Euler graphed against eager."""
    m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=False), seed=4)
    flow = RectifiedFlow(T_STEPS, device=DEV)
    g = torch.Generator().manual_seed(5)
    x_init = torch.randn(2, 32, 32, 3, generator=g)
    classes = torch.tensor([2, 8], device=DEV)
    kw = dict(cfg_scale=3.0, null_label=10, x_init=x_init, n_sample_steps=10)
    shape = (32, 32, 3)
    graphed = flow.sample_dpmpp(m_kernel, classes, shape, graph=True, **kw)
    errs = {"Heun graphed vs plain path":
            (graphed - flow.sample_dpmpp(m_plain, classes, shape, graph=False, **kw)).abs().max(),
            "Heun graphed vs eager":
            (graphed - flow.sample_dpmpp(m_kernel, classes, shape, graph=False, **kw)).abs().max(),
            "Euler graphed vs eager":
            (flow.sample_ddim(m_kernel, classes, shape, graph=True, **kw)
             - flow.sample_ddim(m_kernel, classes, shape, graph=False, **kw)).abs().max()}
    errs = {k: v.item() for k, v in errs.items()}
    moved = (graphed - x_init.to(DEV)).abs().max().item()
    print("fp32 flow CFG trajectories B=2, 10 steps, max_abs_err: "
          + "; ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (x moved {moved:.3f})")
    if not torch.isfinite(graphed).all() or max(errs.values()) > UNET_FP32_TOL or moved < 1e-2:
        raise AssertionError(f"flow trajectory errs {errs}, moved {moved}")


def run_protocol(family: str, tag: str) -> dict:
    """One family's protocol through ``ldm_tpu_torch.main.main``, counted and
    checked; returns its numbers."""
    with tempfile.TemporaryDirectory() as workdir:
        path = protocol_config(family, workdir)
        config = load_config(path)
        zero_counts()
        t0 = time.perf_counter()
        result = protocol_main.main([path, "--per-class", str(PROTOCOL_PER_CLASS),
                                     "--classifier-epochs", str(PROTOCOL_CLF_EPOCHS),
                                     "--negative-control", "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        dt = result.diffusion_trainer
        sampler, ddim_steps = aug.phase_c_sampler_default(dt, None, None)
        print(f"{family}: {type(dt.diffusion).__name__}, Phase C {sampler} "
              f"({ddim_steps if sampler != 'ddpm' else dt.diffusion.n_steps} steps), "
              f"{wall:.1f} s in all; kernel launches in the run: {counts}")
        print(f"{family} wall seconds by phase: "
              + ", ".join(f"{k} {v:.3f}" for k, v in result.seconds.items()))
        print(f"{family} attention launches by phase (forward / backward): "
              + ", ".join(f"{k} {v['linear_attention_fwd']} / "
                          f"{v['linear_attention_bwd']}"
                          for k, v in result.launches.items()))
        want = protocol_launches(family, config)
        if result.launches != want:
            raise AssertionError(f"{family} launches by phase {result.launches}, want {want}")
        if counts["linear_attention_fwd"] != sum(v["linear_attention_fwd"]
                                                 for v in want.values()):
            raise AssertionError(f"{family}: {counts} launches in the run")
        (phase_c, *_) = dt.diffusion.sampler_graphs()
        step_ms = phase_c.device_ms(10)
        n_images = 10 * PROTOCOL_PER_CLASS
        img_s = n_images / result.seconds["C"]
        print(f"{family} Phase C: {n_images} images in {result.seconds['C']:.3f} s, "
              f"{img_s:.3f} img/s (graph captures included), device {step_ms:.4f} ms a "
              f"sampler step at 2B={2 * SAMPLE_B} [{tag}]")
        print(f"{family} test F1: " + ", ".join(f"{k} {v:.4f}" for k, v in result.test_f1.items())
              + f"; FID pixel {result.fid_pixel:.4f} (broken {result.fid_pixel_broken:.4f}), "
              f"classifier {result.fid_classifier:.4f} (broken "
              f"{result.fid_classifier_broken:.4f})")
        for v in (result.fid_pixel, result.fid_classifier, result.fid_pixel_broken,
                  result.fid_classifier_broken, *result.test_f1.values()):
            if not np.isfinite(v):
                raise AssertionError(f"{family}: a result is not finite: {result}")
        if set(result.test_f1) != set(PROTOCOL_EXPS) or result.synthetic_size != n_images:
            raise AssertionError(f"{family}: {result.test_f1} {result.synthetic_size}")
        if result.synthetic.images.shape != (n_images, 32, 32, 3):
            raise AssertionError(f"{family}: synthetic set {result.synthetic.images.shape}")
        rerun_chunk(result, config, sampler, ddim_steps)
        rerun_exp2(result, config)
        return {"seconds": result.seconds, "wall_seconds": wall,
                "launches": result.launches, "counts": counts,
                "phase_c_img_s": img_s, "phase_c_step_device_ms": step_ms,
                "phase_c_sampler": f"{sampler}-{ddim_steps}" if sampler != "ddpm"
                else f"ancestral-{dt.diffusion.n_steps}",
                "test_f1": result.test_f1, "fid_pixel": result.fid_pixel,
                "fid_classifier": result.fid_classifier,
                "fid_pixel_broken": result.fid_pixel_broken,
                "fid_classifier_broken": result.fid_classifier_broken}


def check_protocol(tag: str) -> dict:
    """Phase 7c: both families' protocol runs, the classifier's step, the
    Heun trajectory and the graphed flow train step.  The protocol sets
    cuDNN's deterministic algorithms; the flags are put back after it, so
    the phases that follow time cuDNN as before."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        out = {family: run_protocol(family, tag) for family in PROTOCOL}
        out["classifier_step"] = check_classifier_steps(tag)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    flow_config = load_config(FLOW)
    check_heun_trajectory(flow_config)
    check_graphed_training(flow_config)
    return out


# the real-data drill (phase 7j): the MNIST flagship from raw IDX files
MNIST = "configs/pixel_diffusion_model_mnist.yaml"
MNIST_SIDE, DRILL_TEST, DRILL_DDIM_STEPS = 28, 512, 50
DRILL_BUDGET_S = 60  # 18.5 s in its first run (NVIDIA H100 80GB HBM3, 700.00 W)


def write_mnist_idx(root: str, n_train: int, n_test: int, seed: int) -> dict:
    """Raw MNIST files in the full IDX format under ``root/MNIST/raw``
    (torchvision's layout), from ``seed``: 28x28 uint8 images (magic 2051)
    and uint8 labels 0-9 in turn (magic 2049); the test labels gzipped, as
    the JAX package's drill writes them.  Returns the image count a file."""
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(seed)
    for prefix, n, gz in (("train", n_train, False), ("t10k", n_test, True)):
        images = rng.integers(0, 256, (n, MNIST_SIDE, MNIST_SIDE), dtype=np.uint8)
        with open(os.path.join(raw, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, MNIST_SIDE, MNIST_SIDE) + images.tobytes())
        labels = (np.arange(n) % 10).astype(np.uint8)
        name = os.path.join(raw, f"{prefix}-labels-idx1-ubyte" + (".gz" if gz else ""))
        with (gzip.open if gz else open)(name, "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return {"train": n_train, "t10k": n_test}


class RecordingWandb(types.ModuleType):
    """A stand-in for the wandb module in ``sys.modules``: every call the
    logger makes, recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.run = None
        self.init_calls, self.logged, self.define_calls = [], [], []

    def init(self, **kw):
        self.init_calls.append(kw)
        self.run = object()
        return self.run

    def log(self, metrics, step=None):
        self.logged.append((dict(metrics), step))

    def define_metric(self, key, summary=None):
        self.define_calls.append((key, summary))

    class Image:
        def __init__(self, data):
            self.data = np.asarray(data)

    class Histogram:
        def __init__(self, data):
            self.data = np.asarray(data)


@contextlib.contextmanager
def wandb_stub():
    """``sys.modules["wandb"]`` is a ``RecordingWandb`` inside, what it was
    after."""
    saved = sys.modules.get("wandb")
    stub = sys.modules["wandb"] = RecordingWandb()
    try:
        yield stub
    finally:
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved


def check_drill(tag: str) -> dict:
    """Phase 7j: ``ldm_tpu_torch.main`` on the MNIST flagship at full width
    from raw IDX files, ``--strict-data --wandb`` with a recording wandb, the
    five mixes; then the same argv without the files must raise
    ``FileNotFoundError`` before any device work."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        data_path = os.path.join(workdir, "data")
        files = write_mnist_idx(data_path, PROTOCOL_SIZE, DRILL_TEST, seed=0)
        path = write_config(os.path.join(workdir, "mnist.yaml"), MNIST, workdir=workdir,
                            epochs=1, sample_every=0, data={"data_path": data_path})
        config = load_config(path)
        mp = config.model.params
        if (mp["channels"], list(mp["channel_multipliers"]), mp["in_channels"],
                config.diffusion.n_steps, config.diffusion.cfg_scale, config.use_amp) != (
                64, [1, 2, 4, 8], 1, T_STEPS, 3, True):
            raise AssertionError(f"{MNIST} is not the full-width MNIST flagship: {config}")
        argv = [path, "--strict-data", "--wandb", "--per-class", str(PROTOCOL_PER_CLASS),
                "--classifier-epochs", str(PROTOCOL_CLF_EPOCHS), "--sampler", "ddim",
                "--ddim-steps", str(DRILL_DDIM_STEPS)]
        with wandb_stub() as stub:
            zero_counts()
            t0 = time.perf_counter()
            result = protocol_main.main(argv)
            wall = time.perf_counter() - t0
            counts = read_counts()

            dt, rt = result.diffusion_trainer, result.classifier_trainer
            n_params = sum(p.numel() for p in dt.model.parameters())
            print(f"MNIST flagship UNet: {n_params:,} parameters (in_channels 1, 64 channels, "
                  f"1/2/4/8), bf16, T={config.diffusion.n_steps}, CFG "
                  f"{config.diffusion.cfg_scale}")
            # the data came from the files
            gen_half = [dl.dataset for dl in (dt.train_loader, dt.val_loader)]
            test = rt.test_loader.dataset
            names = {ds.name for ds in gen_half + [test]}
            print(f"data: {files} images in the IDX files; generator half "
                  f"{sum(len(ds) for ds in gen_half)} ({len(gen_half[0])} train + "
                  f"{len(gen_half[1])} validation), test {len(test)}, names {names}, "
                  f"{test.images.shape[1:]} after the resize")
            if names != {"MNIST"} or sum(len(ds) for ds in gen_half) != files["train"] // 2 \
                    or len(test) != files["t10k"] or test.images.shape[1:] != (32, 32, 1):
                raise AssertionError("the protocol did not read the IDX files")
            # the JSON main printed
            out = protocol_main.result_json(result)
            if set(out["test_f1"]) != {name for name, _, _ in aug.EXPERIMENTS} or \
                    out["synthetic_size"] != 10 * PROTOCOL_PER_CLASS or \
                    not np.isfinite(out["fid_pixel"]) or not np.isfinite(out["fid_classifier"]):
                raise AssertionError(f"main's result: {out}")
            if result.synthetic.images.shape != (10 * PROTOCOL_PER_CLASS, 32, 32, 1):
                raise AssertionError(f"synthetic set {result.synthetic.images.shape}")
            # the wandb sink: one offline init with the config's project, and
            # Phase A's losses at their steps, as metrics.jsonl has them
            with open(os.path.join(config.dirpath, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            want = [(rec["step"], {k: v for k, v in rec.items() if k not in ("step", "ts")})
                    for rec in recs if "diffusion_model train_loss" in rec]
            got = [(step, m) for m, step in stub.logged if "diffusion_model train_loss" in m]
            print(f"wandb: init {stub.init_calls}; {len(stub.logged)} log calls, "
                  f"{len(stub.define_calls)} summary rules; Phase A's train losses (step, "
                  f"loss): {[(s, m['diffusion_model train_loss']) for s, m in got]}")
            if stub.init_calls != [{"project": config.project_name,
                                    "mode": os.environ.get("WANDB_MODE", "offline")}]:
                raise AssertionError(f"wandb.init calls {stub.init_calls}")
            if not want or got != want or [s for s, _ in got] != list(range(config.epochs)) \
                    or not all(np.isfinite(m["diffusion_model train_loss"]) for _, m in got):
                raise AssertionError(f"wandb got Phase A's losses {got}, metrics.jsonl {want}")
            # the attention launches by phase
            print("attention launches by phase (forward / backward): "
                  + ", ".join(f"{k} {v['linear_attention_fwd']} / "
                              f"{v['linear_attention_bwd']}"
                              for k, v in result.launches.items()))
            want_launches = protocol_launches("pixel", config, ddim_steps=DRILL_DDIM_STEPS,
                                              negative_control=False)
            if result.launches != want_launches:
                raise AssertionError(f"launches by phase {result.launches}, want "
                                     f"{want_launches}")
            if counts["linear_attention_fwd"] != sum(
                    v["linear_attention_fwd"] for v in want_launches.values()) or \
                    counts["linear_attention_bwd"] != want_launches["A"][
                        "linear_attention_bwd"]:
                raise AssertionError(f"{counts} launches in the run")
            img_s = 10 * PROTOCOL_PER_CLASS / result.seconds["C"]
            print(f"MNIST drill: {wall:.3f} s in all; by phase "
                  + ", ".join(f"{k} {v:.3f}" for k, v in result.seconds.items())
                  + f"; Phase C DDIM-{DRILL_DDIM_STEPS}, {10 * PROTOCOL_PER_CLASS} images at "
                  f"{img_s:.3f} img/s (graph captures included); test F1 "
                  + ", ".join(f"{k} {v:.4f}" for k, v in result.test_f1.items())
                  + f"; FID pixel {result.fid_pixel:.4f}, classifier "
                  f"{result.fid_classifier:.4f} [{tag}]")

            # strict mode bites: no files, the same argv fails before any device work
            shutil.rmtree(data_path)
            zero_counts()
            torch.cuda.synchronize()
            allocated = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            try:
                protocol_main.main(argv)
            except FileNotFoundError as e:
                missing = str(e)
            else:
                raise AssertionError("--strict-data ran without the dataset's files")
            strict_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            print(f"without the files: FileNotFoundError after {strict_s:.3f} s ({missing}); "
                  f"launches {read_counts()}, device memory allocated "
                  f"{torch.cuda.memory_allocated() - allocated:+d} bytes")
            if any(read_counts().values()) or torch.cuda.memory_allocated() != allocated:
                raise AssertionError("--strict-data did device work before it failed")
    seconds = time.perf_counter() - t_phase
    print(f"phase 7j wall time {seconds:.1f} s (budget {DRILL_BUDGET_S} s) [{tag}]")
    if seconds > DRILL_BUDGET_S:
        raise AssertionError(f"phase 7j took {seconds:.1f} s, over {DRILL_BUDGET_S} s")
    return {"seconds": seconds, "wall_seconds": wall, "by_phase": result.seconds,
            "launches": result.launches, "counts": counts, "phase_c_img_s": img_s,
            "n_params": n_params, "test_f1": result.test_f1, "fid_pixel": result.fid_pixel,
            "fid_classifier": result.fid_classifier, "strict_seconds": strict_s}


class BatchProbe:
    """Records the batch of every call of the forward kernel's wrapper from
    the UNet (the sampler's forwards are one call a block): a CFG pass
    would show 2B."""

    def __enter__(self):
        self.seen, self.orig = [], unet_module.linear_attention_block

        def record(x, *args, **kw):
            self.seen.append(x.shape[0])
            return self.orig(x, *args, **kw)

        unet_module.linear_attention_block = record
        return self

    def __exit__(self, *exc):
        unet_module.linear_attention_block = self.orig


def distill_trainer(cfg, teacher_path: str, graphs) -> ConsistencyDistillTrainer:
    teacher = build_model(cfg)
    teacher.load_state_dict(torch.load(teacher_path, map_location="cpu", weights_only=True))
    return ConsistencyDistillTrainer(cfg, teacher.to(DEV), build_diffusion(cfg, DEV), None,
                                     list(range(10)), device=DEV, skip_steps=20, graphs=graphs)


def check_distill_graphs(cfg, teacher_path: str) -> dict:
    """Phase 7d: a graphed and an eager fp32 distillation trainer from one
    teacher, fed the same batches and injected n / eps for 8 steps (3 eager,
    5 replayed): the losses within 1e-3; before the replays an eager EMA
    forward fills the EMA's cache of kernel weight copies, after them the
    EMA target on the kernel path equals the plain-path model loaded from
    the EMA's state_dict (1e-3 of its scale), and the teacher kept its
    copies and its weights."""
    cfg = dataclasses.replace(cfg, use_amp=False)
    graphed, eager = distill_trainer(cfg, teacher_path, None), distill_trainer(cfg, teacher_path,
                                                                             False)
    diffusion, teacher = graphed.diffusion, graphed.teacher
    g = torch.Generator().manual_seed(13)
    x = (torch.rand(TRAIN_B, 32, 32, 3, generator=g) * 2 - 1).to(DEV)
    y = torch.randint(0, 10, (TRAIN_B,), generator=g).to(DEV)
    t = graphed.sub_t[torch.randint(0, len(graphed.sub), (TRAIN_B,), generator=g).to(DEV)]
    with torch.no_grad():  # the teacher's copies, made before any capture
        teacher_out = consistency_fn(diffusion, teacher, x, t, y)
    teacher_copies = [b._kernel_w for b in teacher.lin_attn_blocks()]
    worst = 0.0
    for step in range(8):
        if step == WARMUP_STEPS:
            with torch.no_grad():
                consistency_fn(diffusion, graphed.state.ema, x, t, y)
        batch = {"image": torch.rand(TRAIN_B, 32, 32, 3, generator=g) * 2 - 1,
                 "label": torch.randint(0, 10, (TRAIN_B,), generator=g)}
        draws = dict(n=torch.randint(0, len(graphed.sub) - 1, (TRAIN_B,), generator=g),
                     eps=torch.randn(TRAIN_B, 32, 32, 3, generator=g))
        a, b = graphed.train_step(batch, **draws), eager.train_step(batch, **draws)
        rel = abs(a["loss"].item() - b["loss"].item()) / b["loss"].item()
        worst = max(worst, rel)
        print(f"  fp32 distill step {step}: loss graphed {a['loss'].item():.6f} eager "
              f"{b['loss'].item():.6f}")
        if rel > UNET_FP32_TOL:
            raise AssertionError(f"distill step {step}: graphed loss off the eager one by {rel}")
    if graphed.step_counts != {"graphed": 8 - WARMUP_STEPS, "eager": WARMUP_STEPS}:
        raise AssertionError(f"distill step counts {graphed.step_counts}")
    plain = build_model(cfg, DEV, attention_impl="torch").eval()
    plain.load_state_dict(graphed.state.ema.state_dict(), strict=True)
    plain_teacher = build_model(cfg, DEV, attention_impl="torch").eval()
    plain_teacher.load_state_dict(teacher.state_dict(), strict=True)
    with torch.no_grad():
        got = consistency_fn(diffusion, graphed.state.ema, x, t, y)
        want = consistency_fn(diffusion, plain, x, t, y)
        teacher_now = consistency_fn(diffusion, teacher, x, t, y)
        teacher_plain = consistency_fn(diffusion, plain_teacher, x, t, y)
    ema_err = ((got - want).abs().max() / want.abs().max()).item()
    teacher_err = ((teacher_now - teacher_plain).abs().max() / teacher_plain.abs().max()).item()
    moved = (got - teacher_out).abs().max().item()
    kept = all(b._kernel_w is c for b, c in zip(teacher.lin_attn_blocks(), teacher_copies))
    print(f"graphed vs eager fp32 distillation, 8 steps ({8 - WARMUP_STEPS} replayed): worst "
          f"loss difference {worst:.2e} of the loss; after the replays the EMA target on the "
          f"kernel path vs the plain-path model from the EMA's state_dict: {ema_err:.2e} of its "
          f"scale (the EMA moved {moved:.3e} from the teacher); the teacher kept its kernel "
          f"weight copies: {kept}, kernel vs plain {teacher_err:.2e}, its output unchanged: "
          f"{torch.equal(teacher_now, teacher_out)}")
    if ema_err > UNET_FP32_TOL or not moved > 0 or not kept or teacher_err > UNET_FP32_TOL \
            or not torch.equal(teacher_now, teacher_out):
        raise AssertionError("the distillation's weight copies are stale or the teacher moved")
    return {"loss_rel_diff": worst, "ema_target_rel_err": ema_err}


def check_consistency(tag: str) -> dict:
    """Phase 7d: consistency distillation at the flagship's width through
    ``distill.main``, the graphed step against the eager one, the sampler
    through ``generate.main`` and the service."""
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        path = write_config(os.path.join(workdir, "distill.json"), FLAGSHIP, workdir=workdir,
                            data={"synthetic_size": SYNTHETIC_SIZE})
        cfg = load_config(path)
        teacher = seeded_checkpoint(cfg, os.path.join(workdir, "teacher.pt"))
        zero_counts()
        t0 = time.perf_counter()
        res = distill.main([path, "--teacher-checkpoint", teacher, "--epochs", "1",
                            "--device", "cuda"])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        tr = res.trainer
        steps, scan = tr.state.step, tr.epoch_scan
        grid_steps = 2  # the grid's --sample-steps, B=80: a captured sampler step
        # the teacher's and the EMA target's forwards run outside autograd
        want = dict.fromkeys(COUNTED, 0) | {
            "linear_attention_fwd": DISTILL_FWD * steps + 8 * (grid_steps + WARMUP_STEPS),
            "linear_attention_bwd": DISTILL_BWD * steps, "fused_adam_ema": steps,
            "group_norm_silu": 2 * GN_PIXEL * steps + GN_PIXEL * (grid_steps + WARMUP_STEPS)}
        print(f"distill.main: {steps} steps at B={TRAIN_B} bf16 in {seconds:.1f} s (builds, "
              f"warm-up and captures included), losses {res.result['history']}, steps "
              f"{tr.step_counts}; kernel launches {counts} (want {want}: {DISTILL_FWD} / "
              f"{DISTILL_BWD} a step, and 8 x ({grid_steps} + {WARMUP_STEPS}) for the 2-step "
              f"grid) [{tag}]")
        if (steps != 9 or counts != want or scan is None or tr._steps.captured.get(scan) is None
                or tr.step_counts != {"graphed": 9 - WARMUP_STEPS, "eager": WARMUP_STEPS}
                or not np.isfinite(res.result["history"]).all()):
            raise AssertionError(f"distill.main: {steps} steps, {counts}, {tr.step_counts}")
        for name in ("consistency_model.pt", "consistency_model_ema.pt"):
            if not os.path.isfile(os.path.join(cfg.checkpoints, name)):
                raise AssertionError(f"distill.main wrote no {name}")
        grid = np.load(res.grid)
        print(f"sample grid {grid.shape} {grid.dtype}; checkpoints written")

        scan.start_epoch(cfg.seed, 0)
        zero_counts()
        tr.scan_step(scan)
        per_step = read_counts()
        if per_step != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": DISTILL_FWD,
                                                    "linear_attention_bwd": DISTILL_BWD,
                                                    "fused_adam_ema": 1,
                                                    "group_norm_silu": 2 * GN_PIXEL}:
            raise AssertionError(f"a replayed distill step launched {per_step}")
        print(f"one replayed distill step launches: {per_step}")

        def epoch():
            scan.start_epoch(cfg.seed, 0)
            for _ in range(scan.n_batches):
                tr.scan_step(scan)

        graphed = host_ms(epoch, scan.n_batches)
        device_ms = tr._steps.captured[scan].device_ms(10)
        tr.graphs = False
        epoch()
        eager = host_ms(epoch, scan.n_batches)
        tr.graphs = True
        out["path"] = path_line(f"distill step B={TRAIN_B} bf16", graphed, eager, device_ms, tag)
        out["per_step"] = per_step
        out["run_counts"] = counts

        student = os.path.join(cfg.checkpoints, "consistency_model_ema.pt")
        requests = {}
        for k in CONSISTENCY_STEPS:
            zero_counts()
            with BatchProbe() as probe, tempfile.TemporaryDirectory() as d:
                g = generate.main([path, "--sampler", "consistency", "--ddim-steps", str(k),
                                   "--weights", student, "--device", "cuda",
                                   "--out", os.path.join(d, "x.npy")])
            counts_k = read_counts()
            want_k = dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": 8 * (k + WARMUP_STEPS),
                                                  "group_norm_silu": GN_PIXEL * (k + WARMUP_STEPS)}
            print(f"generate --sampler consistency {k} steps B=10 bf16: {10 / g.seconds:.3f} "
                  f"img/s ({g.seconds:.3f} s, warm-up and capture {g.capture_seconds:.3f} s); "
                  f"launches {counts_k} (want {want_k}); the forward kernel saw batches "
                  f"{sorted(set(probe.seen))} (10: no CFG pass) [{tag}]")
            if (counts_k != want_k or set(probe.seen) != {10} or g.images.shape != (10, 32, 32, 3)
                    or not np.isfinite(g.x0).all()):
                raise AssertionError(f"consistency request of {k} steps: {counts_k}, "
                                     f"{set(probe.seen)}")
            requests[k] = {"seconds": g.seconds, "capture_seconds": g.capture_seconds,
                           "launches": counts_k["linear_attention_fwd"]}
        # launches a sampler step, from each request's count over its steps
        per_sample_step = {v["launches"] / (k + WARMUP_STEPS) for k, v in requests.items()}
        if len(per_sample_step) != 1:
            raise AssertionError(f"consistency launches a step differ by steps: {requests}")
        out["requests"], out["sample_per_step"] = requests, int(per_sample_step.pop())

        served = serve(cfg, student, "consistency", 2, 2, tag, checks=True)
        model, diffusion = load_sampler(cfg, student, device=DEV)
        pads = SERVE_B - 10
        seeds = np.array([REF_SEED] * 10 + [0] * pads, np.int32)
        idxs = np.array(list(range(10)) + [0] * pads, np.int32)
        x_init, gens = slot_x_init(seeds, idxs, (32, 32, 3))
        x0 = sample_consistency(diffusion, model, torch.tensor(REF_CLASSES + [0] * pads,
                                                               device=DEV),
                                (32, 32, 3), ts=sampling_timesteps(diffusion.n_steps, 2),
                                x_init=x_init, slot_generators=gens)
        reference = reverse_transform(x0.cpu().numpy())[:10]
        alone = served["alone"]
        checks = {"alone == under load": np.array_equal(alone, served["under_load"]),
                  f"alone == sample_consistency B={SERVE_B}": np.array_equal(alone, reference),
                  "alone == POST /generate npy": np.array_equal(alone, served["http"])}
        sat = served["saturated"]
        print(f"serving consistency-2 B={SERVE_B} bf16: the 10-image request alone, under "
              f"{served['load_images']} images of 16 clients, through HTTP and against "
              f"sample_consistency on the slots' generators: {checks}; saturated "
              f"{sat['img_s']:.3f} img/s ({sat['images']} images, {sat['batches']} batches), "
              f"latency p50 {sat['latency_p50_s']:.4f} s p95 {sat['latency_p95_s']:.4f} s, host "
              f"{sat['host_ms_per_batch']:.3f} ms a batch, device "
              f"{sat['device_ms_per_batch_served']:.3f} ms a served batch, busy "
              f"{sat['device_busy_share']:.4f}; light load p50 {served['light_p50_s']:.4f} s "
              f"[{tag}]")
        if not all(checks.values()):
            raise AssertionError(f"consistency serving checks failed: {checks}")
        out["serving"] = {**sat, "launches": served["counts"]["linear_attention_fwd"],
                          "gn_launches": served["counts"]["group_norm_silu"],
                          "light_p50_s": served["light_p50_s"]}
        out["graphs_check"] = check_distill_graphs(cfg, teacher)
    return out


def check_latent(tag: str, keep_dir: str) -> dict:
    """Phase 7e: the VAE, the latent DDPM, their sampler and service at the
    configs' full width, and the protocol with the latent generator; the
    trained VAE's ``autoencoder.pt`` is copied into ``keep_dir`` (phase 7g
    exports it)."""
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        ae_cfg = load_config(write_config(os.path.join(workdir, "ae.json"), AE_CONFIG,
                                          workdir=workdir, epochs=2,
                                          data={"synthetic_size": SYNTHETIC_SIZE}))
        zero_counts()
        t0 = time.perf_counter()
        ae_run = train_autoencoder.run(ae_cfg, DEV)
        ae_s = time.perf_counter() - t0
        counts = read_counts()
        at = ae_run.trainer
        hist = ae_run.history
        ae_pt = os.path.join(ae_cfg.checkpoints, "autoencoder.pt")
        n_ae = sum(p.numel() for p in at.model.parameters())
        print(f"train_autoencoder: {AE_CONFIG} ({n_ae} parameters), {at.state.step} steps in 2 "
              f"epochs at B={TRAIN_B} bf16 in {ae_s:.1f} s, steps {at.step_counts}; train loss "
              f"{hist['train_loss']}, val loss {hist['val_loss']}; launches {counts} (the VAE "
              f"runs no attention kernel; one optimizer pass a step) [{tag}]")
        # the GroupNorm pass in the VAE's validation batches and the epoch-0
        # reconstruction grid, each an encode and a decode; none in its steps
        ae_gn = (GN_VAE_ENC + GN_VAE_DEC) * (2 * len(at.val_loader) + 1)
        if (at.state.step != 18 or not np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
                or not os.path.isfile(ae_pt)
                or counts != dict.fromkeys(COUNTED, 0) | {"fused_adam_ema": 18,
                                                          "group_norm_silu": ae_gn}
                or at.step_counts != {"graphed": 18 - WARMUP_STEPS, "eager": WARMUP_STEPS}):
            raise AssertionError(f"train_autoencoder: {at.step_counts}, {hist}, {counts}")
        shutil.copy(ae_pt, os.path.join(keep_dir, "autoencoder.pt"))
        ae_scan = at.epoch_scan
        out["autoencoder_device_ms"] = at._steps.captured[ae_scan].device_ms(10)
        print(f"autoencoder step B={TRAIN_B} bf16: device {out['autoencoder_device_ms']:.3f} ms "
              f"a replay [{tag}]")

        # the latent run reads the .pt of the .msgpack stem the JAX config names
        ae_ckpt = os.path.join(ae_cfg.checkpoints, "autoencoder.msgpack")
        ldm_path = write_config(os.path.join(workdir, "ldm.json"), LATENT_CONFIG,
                                workdir=workdir, epochs=2, ae_checkpoint=ae_ckpt,
                                data={"synthetic_size": SYNTHETIC_SIZE})
        ldm_cfg = load_config(ldm_path)
        zero_counts()
        run = train_latent.run(ldm_cfg, DEV)
        counts = read_counts()
        tr = run.trainer
        steps = tr.state.step
        val_batches = len(tr.val_loader)
        blocks = len(tr.model.lin_attn_blocks())
        # the GroupNorm pass: the VAE's encode in every step (outside autograd),
        # the scale's calibration (one encode), and a validation batch's encode
        # and two UNet forwards
        want = dict.fromkeys(COUNTED, 0) | {
            "linear_attention_fwd": blocks * steps + 2 * blocks * val_batches * 2,
            "linear_attention_bwd": blocks * steps, "fused_adam_ema": steps,
            "group_norm_silu": GN_VAE_ENC * (steps + 1)
            + 2 * val_batches * (GN_VAE_ENC + 2 * GN_LATENT)}
        factor = load_latent_scaling(ldm_cfg)
        print(f"train_latent: {LATENT_CONFIG} (latent UNet {sum(p.numel() for p in tr.model.parameters())}"
              f" parameters, {blocks} attention blocks at (16, 128), latents {tr.image_shape}), "
              f"{steps} steps in 2 epochs at B={TRAIN_B} bf16, steps {tr.step_counts}; train loss "
              f"{run.history['train_loss']}; latent_scaling.json {factor:.5f}; launches {counts} "
              f"(want {want}: {blocks} + {blocks} a step, 2 x {blocks} a validation batch, none in "
              f"the VAE) [{tag}]")
        if (steps != 18 or counts != want or blocks != 2 or not np.isfinite(factor)
                or tr.epoch_scan is None or tr.scan_graph is None
                or not np.isfinite(run.history["train_loss"]).all()
                or tr.step_counts != {"graphed": 18 - WARMUP_STEPS, "eager": WARMUP_STEPS}):
            raise AssertionError(f"train_latent: {steps} steps, {counts}, {tr.step_counts}")
        scan = tr.epoch_scan
        scan.start_epoch(ldm_cfg.seed, 0)
        zero_counts()
        tr.scan_step(scan)
        per_step = read_counts()
        if per_step != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": 2,
                                                    "linear_attention_bwd": 2,
                                                    "fused_adam_ema": 1,
                                                    "group_norm_silu": GN_VAE_ENC}:
            raise AssertionError(f"a replayed latent train step launched {per_step}")

        def epoch():
            scan.start_epoch(ldm_cfg.seed, 0)
            for _ in range(scan.n_batches):
                tr.scan_step(scan)

        graphed = host_ms(epoch, scan.n_batches)
        device_ms = tr.scan_graph.device_ms(10)
        tr.graphs = False
        epoch()
        eager = host_ms(epoch, scan.n_batches)
        tr.graphs = True
        out["train_path"] = path_line(f"latent train step B={TRAIN_B} bf16 (the VAE's encode "
                                      f"inside)", graphed, eager, device_ms, tag)
        out["train_per_step"], out["train_counts"] = per_step, counts

        # the T=1000 ancestral CFG sample at B=10 through the trainer, graphed
        # and eager; then an fp32 trajectory graphed vs eager on injected draws
        classes = list(range(10))
        sample_counts, sample_gn = {}, {}
        for graphs in (True, False):
            tr.graphs = graphs
            zero_counts()
            images = tr.sample(classes, cfg_scale=3.0)
            sample_counts[graphs] = read_counts()["linear_attention_fwd"]
            sample_gn[graphs] = read_counts()["group_norm_silu"]
            if graphs:  # the latent UNet's two sites at (16, 128), 2B=20
                out["sampler_persistent"] = check_persistent(
                    sample_counts[True], 2 * len(classes), [LATENT_SITES[0]] * blocks,
                    f"the latent sampler B={len(classes)} as replayed graphs")
            if images.shape != (10, 32, 32, 3) or images.dtype != np.uint8:
                raise AssertionError(f"latent sample {images.shape} {images.dtype}")
        tr.graphs = True
        t_steps = tr.diffusion.n_steps
        print(f"latent T={t_steps} ancestral CFG sample B=10: forward launches graphed "
              f"{sample_counts[True]} (want {blocks} x ({t_steps} + {WARMUP_STEPS})), eager "
              f"{sample_counts[False]} (want {blocks} x {t_steps}); decoded images (10, 32, 32, 3)")
        print(f"latent sampler GroupNorm pass launches graphed {sample_gn[True]}, eager "
              f"{sample_gn[False]} (want {GN_LATENT} a step and {GN_VAE_DEC} for the decode)")
        if sample_counts != {True: blocks * (t_steps + WARMUP_STEPS), False: blocks * t_steps}:
            raise AssertionError(f"latent sampler launches {sample_counts}")
        if sample_gn != {True: GN_LATENT * (t_steps + WARMUP_STEPS) + GN_VAE_DEC,
                         False: GN_LATENT * t_steps + GN_VAE_DEC}:
            raise AssertionError(f"latent sampler GroupNorm pass launches {sample_gn}")
        cfg32 = dataclasses.replace(ldm_cfg, use_amp=False)
        m32 = build_model(cfg32, DEV).eval()
        m32.load_state_dict(tr.state.ema.state_dict(), strict=True)
        ldm32 = build_ldm(cfg32, m32, tr.ldm.autoencoder, factor, DEV)
        g = torch.Generator().manual_seed(17)
        z_init = torch.randn((10,) + tr.image_shape, generator=g)
        noise = torch.randn((t_steps, 10) + tr.image_shape, generator=g).to(DEV)
        kw = dict(cfg_scale=3.0, null_label=10, x_init=z_init, noise=lambda t: noise[t])
        ys = torch.arange(10, device=DEV)
        z = {graph: ldm32.diffusion.sample(m32, ys, tr.image_shape, graph=graph, **kw)
             for graph in (True, False)}
        err = (z[True] - z[False]).abs().max().item()
        decoded = ldm32.autoencoder_decode(z[True])
        print(f"latent fp32 T={t_steps} CFG trajectory B=10, injected x_T and noise: graphed vs "
              f"eager max_abs_err {err:.3e} (|z0| max {z[False].abs().max().item():.3f}); "
              f"decoded {tuple(decoded.shape)}")
        if err > UNET_FP32_TOL or not torch.isfinite(decoded).all():
            raise AssertionError(f"latent trajectory graphed vs eager {err}")
        out["sampler_path"] = check_sampler_speed(tr.state.ema.eval(), 64, tag, tr.image_shape,
                                                  "sqrt_linear", name="latent sampler")
        ae = tr.ldm.autoencoder
        z = torch.randn((SERVE_B,) + tr.image_shape, generator=g).to(DEV)
        with torch.inference_mode():
            out["decode_ms"] = cuda_graph_ms(lambda: ae.decode(z), iters=5)
        fp32_convs = sorted({f"{name} {key[0]}" for name, m in ae.named_modules()
                             for key, ok in getattr(m, "position_independent", {}).items()
                             if not ok})
        print(f"VAE decode B={SERVE_B} bf16: device {out['decode_ms']:.3f} ms (CUDA-graph "
              f"replay); decoder convolutions whose bf16 algorithm made an image depend on its "
              f"batch position, run in fp32 on their bf16 values: {fp32_convs} [{tag}]")
        out["sample_counts"] = {"graphed": sample_counts[True], "eager": sample_counts[False]}
        out["sample_gn_counts"] = {"graphed": sample_gn[True], "eager": sample_gn[False]}
        out["sample_per_step"] = sample_counts[True] // (t_steps + WARMUP_STEPS)  # exact: above

        ckpt = os.path.join(ldm_cfg.checkpoints, "diffusion_model_ema.pt")
        steps_ddim = len(GaussianDiffusion(t_steps).ddim_timesteps(50)[0])
        # under the cuDNN flags python -m ldm_tpu_torch.serve runs with (PyTorch's
        # defaults: TF32 on; the trainers above set deterministic algorithms)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=True):
            served = serve(ldm_cfg, ckpt, "ddim", 50, steps_ddim, tag, checks=True,
                           blocks=blocks, norms=GN_LATENT, decode_norms=GN_VAE_DEC)
        alone = served["alone"]
        checks = {"alone == under load": np.array_equal(alone, served["under_load"]),
                  "alone == POST /generate npy": np.array_equal(alone, served["http"])}
        off = np.abs(alone.astype(np.int32) - served["under_load"].astype(np.int32))
        sat = served["saturated"]
        print(f"serving latent ddim-{steps_ddim} B={SERVE_B} CFG 3 bf16 (decoded to 32x32x3), "
              f"cuDNN flags as python -m ldm_tpu_torch.serve's (TF32 on, not deterministic): "
              f"the 10-image request alone, under {served['load_images']} images of 16 clients "
              f"and through HTTP: {checks} ({int((off > 0).sum())} pixels differ alone vs under "
              f"load, by at most {int(off.max())}); saturated {sat['img_s']:.3f} img/s ({sat['images']} "
              f"images, {sat['batches']} batches), latency p50 {sat['latency_p50_s']:.4f} s p95 "
              f"{sat['latency_p95_s']:.4f} s, host {sat['host_ms_per_batch']:.3f} ms a batch, "
              f"device {sat['device_ms_per_batch_served']:.3f} ms a served batch, busy "
              f"{sat['device_busy_share']:.4f} [{tag}]")
        if not all(checks.values()) or len(np.unique(alone)) < 50:
            raise AssertionError(f"latent serving checks failed: {checks}")
        out["serving"] = {**sat, "launches": served["counts"]["linear_attention_fwd"],
                          "gn_launches": served["counts"]["group_norm_silu"]}

        saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        try:
            out["protocol"] = run_latent_protocol(workdir, ae_ckpt, tag)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return out


def run_latent_protocol(workdir: str, ae_ckpt: str, tag: str) -> dict:
    """Phase 7e: ``main.main`` on configs/protocol_hard_latent.yaml with
    ``--generator-config configs/latent_diffusion_hard.yaml`` (its first stage
    the VAE trained above) and ``--negative-control``, at 2,560 images as in
    phase 7c.  Counts by phase exact: Phase A's train steps and validation
    batches, Phase C's T=1000 ancestral steps over the chunks plus the
    warm-up before the capture, C_broken the same captured step again (only
    the decode's scale differs), none in the classifier's phases."""
    proto = write_config(os.path.join(workdir, "protocol_latent.json"), PROTOCOL_LATENT,
                         workdir=workdir, epochs=1, sample_every=0,
                         data={"synthetic_size": PROTOCOL_SIZE})
    gen = write_config(os.path.join(workdir, "latent_gen.json"), LATENT_CONFIG,
                       workdir=workdir, epochs=1, sample_every=0, ae_checkpoint=ae_ckpt,
                       project_name="protocol_latent_generator")
    config, gen_cfg = load_config(proto), load_config(gen)
    zero_counts()
    t0 = time.perf_counter()
    result = protocol_main.main([proto, "--generator-config", gen, "--per-class",
                                 str(PROTOCOL_PER_CLASS), "--classifier-epochs",
                                 str(PROTOCOL_CLF_EPOCHS), "--negative-control",
                                 "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    dt = result.diffusion_trainer
    t_steps = dt.diffusion.n_steps
    n_train = int(0.9 * (PROTOCOL_SIZE // 2))
    steps = n_train // config.batch_size
    val_batches = (PROTOCOL_SIZE // 2 - n_train) // config.batch_size  # the last one dropped
    chunks = -(-10 * PROTOCOL_PER_CLASS // SAMPLE_B)
    zero = {"linear_attention_fwd": 0, "linear_attention_bwd": 0, "resnet_block_fwd": 0,
            "fused_adam_ema": 0, "group_norm_silu": 0}
    want = {phase: dict(zero) for phase in ["A", "C", "C_broken"] + PROTOCOL_EXPS}
    # the GroupNorm pass: the VAE's encode in each train step and validation
    # batch, a validation batch's two UNet forwards, Phase C's sampler steps
    # and one decode a chunk
    want["A"].update(linear_attention_fwd=2 * steps + 4 * val_batches,
                     linear_attention_bwd=2 * steps, fused_adam_ema=steps,
                     group_norm_silu=GN_VAE_ENC * steps
                     + val_batches * (GN_VAE_ENC + 2 * GN_LATENT))
    for name, n in classifier_steps(n_train, 10 * PROTOCOL_PER_CLASS,
                                    config.batch_size).items():
        want[name]["fused_adam_ema"] = n
    want["C"]["linear_attention_fwd"] = 2 * (chunks * t_steps + WARMUP_STEPS)
    want["C_broken"]["linear_attention_fwd"] = 2 * chunks * t_steps
    want["C"]["group_norm_silu"] = (GN_LATENT * (chunks * t_steps + WARMUP_STEPS)
                                    + GN_VAE_DEC * chunks)
    want["C_broken"]["group_norm_silu"] = GN_LATENT * chunks * t_steps + GN_VAE_DEC * chunks
    print(f"latent protocol: {type(dt).__name__} over {dt.image_shape} latents, Phase C "
          f"ancestral-{t_steps}, {wall:.1f} s in all; kernel launches in the run: {counts}")
    print("latent wall seconds by phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in result.seconds.items()))
    print("latent attention launches by phase (forward / backward): "
          + ", ".join(f"{k} {v['linear_attention_fwd']} / {v['linear_attention_bwd']}"
                      for k, v in result.launches.items()))
    if result.launches != want:
        raise AssertionError(f"latent launches by phase {result.launches}, want {want}")
    (phase_c, *_) = dt.diffusion.sampler_graphs()
    step_ms = phase_c.device_ms(10)
    n_images = 10 * PROTOCOL_PER_CLASS
    img_s = n_images / result.seconds["C"]
    print(f"latent Phase C: {n_images} images in {result.seconds['C']:.3f} s, {img_s:.3f} img/s "
          f"(the capture and the decodes included), device {step_ms:.4f} ms a sampler step at "
          f"2B={2 * SAMPLE_B} [{tag}]")
    print("latent test F1: " + ", ".join(f"{k} {v:.4f}" for k, v in result.test_f1.items())
          + f"; FID pixel {result.fid_pixel:.4f} (broken, decoded at 0.18215: "
          f"{result.fid_pixel_broken:.4f}), classifier {result.fid_classifier:.4f} (broken "
          f"{result.fid_classifier_broken:.4f})")
    for v in (result.fid_pixel, result.fid_classifier, result.fid_pixel_broken,
              result.fid_classifier_broken, *result.test_f1.values()):
        if not np.isfinite(v):
            raise AssertionError(f"latent protocol: a result is not finite: {result}")
    if set(result.test_f1) != set(PROTOCOL_EXPS) or result.synthetic.images.shape != (
            n_images, 32, 32, 3):
        raise AssertionError(f"latent protocol: {result.test_f1} {result.synthetic.images.shape}")
    rerun_chunk(result, gen_cfg, "ddpm", 50)
    return {"seconds": result.seconds, "wall_seconds": wall, "launches": result.launches,
            "counts": counts, "phase_c_img_s": img_s, "phase_c_step_device_ms": step_ms,
            "phase_c_sampler": f"ancestral-{t_steps}", "test_f1": result.test_f1,
            "fid_pixel": result.fid_pixel, "fid_classifier": result.fid_classifier,
            "fid_pixel_broken": result.fid_pixel_broken,
            "fid_classifier_broken": result.fid_classifier_broken}


# ---------------------------------------------------------------- phase 7f
MESH_STEPS, GLOO_STEPS, BN_STEPS = 8, 6, 4
MESH_TOL = 1e-6  # fp32, world size 1: the mesh step is the one-process step
ATTN_WEIGHTS = ("to_qkv.weight", "to_out.0.weight")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_trainer(cfg, mesh, graphs=None, seed: int = 11, attention_impl=None
                 ) -> DiffusionTrainer:
    """The flagship UNet from ``seed`` (its attention blocks' ``impl``
    ``attention_impl``) in a trainer over ``mesh`` (None: one process), no
    loaders: the caller hands over the batches."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg, DEV).set_attention_impl(attention_impl)
    return DiffusionTrainer(cfg, model, build_diffusion(cfg, DEV), None, None, list(range(10)),
                            device=DEV, graphs=graphs, mesh=mesh)


def global_steps(n: int, seed: int, b: int = TRAIN_B) -> list:
    """``n`` global batches of ``b`` with their draws (t, eps, drop)."""
    g = torch.Generator().manual_seed(seed)
    return [({"image": torch.rand(b, 32, 32, 3, generator=g) * 2 - 1,
              "label": torch.randint(0, 10, (b,), generator=g)},
             dict(t=torch.randint(0, T_STEPS, (b,), generator=g),
                  eps=torch.randn(b, 32, 32, 3, generator=g),
                  drop=torch.tensor(i % 3 == 0))) for i in range(n)]


def attn_weights(state_dict: dict) -> dict:
    return {k: v.detach().float().cpu() for k, v in state_dict.items()
            if k.endswith(ATTN_WEIGHTS)}


def worst_rel(a: dict, b: dict) -> float:
    """The largest |a - b| of a tensor over its largest |b|."""
    return max(float((a[k] - v).abs().max() / v.abs().max()) for k, v in b.items())


def check_mesh_world1(config, tag: str) -> dict:
    """Phase 7f (a): DiffusionTrainer(mesh=create_mesh()) over a NCCL group
    of one process, graphed, replicated and fsdp, against the one-process
    trainer from the same weights, batches and draws (fp32: losses and the
    attention weights within 1e-6); one replayed step's launches; host ms a
    step and the device's ms a replay at B=64 bf16 beside the one-process
    step's."""
    from ldm_tpu_torch.parallel import create_mesh
    from ldm_tpu_torch.parallel import fsdp

    mesh = create_mesh(device=DEV)
    print(f"mesh: {mesh}")
    out = {"launches": {}}
    # cuDNN's deterministic algorithms: its atomic weight-gradient sums move
    # a weight by Adam's sign noise from run to run, which is not the mesh's
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _check_mesh_world1(config, tag, mesh, out)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


@contextlib.contextmanager
def fsdp_rule_as_if(n: int):
    """The FSDP leaf rule applied as over ``n`` processes: at world size 1
    JAX's rule shards nothing (N = 1 replicates every leaf), so FSDP2's
    sharded parameters, all-gathers and reduce-scatters run on one card
    only under the placements N = 2 would give (each shard the whole leaf)."""
    from ldm_tpu_torch.parallel import fsdp

    rule = fsdp.fsdp_shard_dim
    fsdp.fsdp_shard_dim = lambda shape, _n, min_size=fsdp.MIN_SHARD_SIZE: rule(shape, n,
                                                                                min_size)
    try:
        yield
    finally:
        fsdp.fsdp_shard_dim = rule


def graphed_fp32_runs(cfg, variants, out: dict) -> dict:
    """Each variant ``(name, param_sharding, mesh, rule_n)`` of the flagship
    trainer over ``MESH_STEPS`` fp32 steps on the same batches and draws,
    graphed: its losses, attention weights, step counts and sharded leaves;
    a replayed step must launch 8 + 8 attention kernels.  Every variant but
    the first ("one": one process) is held to it within ``MESH_TOL``."""
    from ldm_tpu_torch.parallel import fsdp

    steps = global_steps(MESH_STEPS, 21)
    runs = {}
    for name, sharding, m, rule_n in variants:
        with fsdp_rule_as_if(rule_n):
            tr = mesh_trainer(dataclasses.replace(cfg, param_sharding=sharding), m)
        losses = []
        for i, (batch, draws) in enumerate(steps):
            if i == MESH_STEPS - 1:
                zero_counts()
            losses.append(tr.train_step(batch, **draws)["loss"].item())
        counts = read_counts()
        runs[name] = (losses, attn_weights(tr.state.state_dict()["model"]),
                      tr.step_counts, [n for n, p in tr.model.named_parameters()
                                       if fsdp.is_sharded(p)])
        print(f"  fp32 {name}: losses {' '.join(f'{v:.7f}' for v in losses)}; steps "
              f"{tr.step_counts}; one replayed step's launches {counts}; sharded leaves "
              f"{len(runs[name][3])}")
        if counts != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": 8,
                                                  "linear_attention_bwd": 8,
                                                  "fused_adam_ema": 1}:
            raise AssertionError(f"{name}: a replayed step launched {counts}")
        if tr.step_counts != {"graphed": MESH_STEPS - WARMUP_STEPS, "eager": WARMUP_STEPS}:
            raise AssertionError(f"{name}: step counts {tr.step_counts}")
        out["launches"][name] = counts
        del tr
        torch.cuda.empty_cache()
    one = variants[0][0]
    ref_losses, ref_w = runs[one][:2]
    for name, *_ in variants[1:]:
        losses, w = runs[name][0], runs[name][1]
        loss_rel = max(abs(a - b) / b for a, b in zip(losses, ref_losses))
        w_rel = worst_rel(w, ref_w)
        out[f"{name}_fp32_loss_rel"], out[f"{name}_fp32_weight_rel"] = loss_rel, w_rel
        print(f"world size 1 {name} vs {one}, fp32, {MESH_STEPS} steps "
              f"({MESH_STEPS - WARMUP_STEPS} replayed): losses within {loss_rel:.2e}, the "
              f"{len(w)} attention weights within {w_rel:.2e} of their largest entry "
              f"(bar {MESH_TOL})")
        if loss_rel > MESH_TOL or w_rel > MESH_TOL:
            raise AssertionError(f"{name} left the one-process step")
    return runs


def _check_mesh_world1(config, tag: str, mesh, out: dict) -> dict:
    variants = (("one", "replicated", None, 1), ("dp", "replicated", mesh, 1),
                ("fsdp", "fsdp", mesh, 1), ("fsdp2", "fsdp", mesh, 2))
    with tempfile.TemporaryDirectory() as workdir:
        cfg = dataclasses.replace(config, use_amp=False, workdir=workdir)
        runs = graphed_fp32_runs(cfg, variants, out)
        if runs["dp"][3] or runs["fsdp"][3] or not runs["fsdp2"][3]:
            raise AssertionError("the rule sharded a leaf at N = 1, or none as at N = 2")

        # the step's time, bf16, B=64: the one-process step, DP and FSDP
        batch, _ = global_steps(1, 22)[0]
        for name, sharding, m, rule_n in variants:
            with fsdp_rule_as_if(rule_n):
                tr = mesh_trainer(dataclasses.replace(config, workdir=workdir,
                                                      param_sharding=sharding), m)

            def ten_steps():
                for _ in range(10):
                    tr.train_step(batch)

            ten_steps()
            graphed = host_ms(ten_steps, 10)
            device_ms = tr.train_graph.device_ms(10)
            tr.graphs = False
            ten_steps()
            eager = host_ms(ten_steps, 10)
            out[name] = path_line(f"train step B={TRAIN_B} bf16, {name} world size 1",
                                  graphed, eager, device_ms, tag)
            del tr
            torch.cuda.empty_cache()
        for name in ("dp", "fsdp", "fsdp2"):
            r = out[name]["graphed_ms"] / out["one"]["graphed_ms"]
            d = out[name]["device_ms"] / out["one"]["device_ms"]
            print(f"{name} / one process at world size 1: host {r:.4f}, device {d:.4f} "
                  f"[{tag}]")
    return out


def mesh_worker(rank: int, port: int, outdir: str) -> None:
    """One of phase 7f (b)'s two processes on the one card: a gloo group
    (eager steps by design), fp32, DP at global B=64 (32 a process) on the
    given global batches and draws, then the classifier's 4 steps at lr 0."""
    import torch.distributed as dist

    from ldm_tpu_torch.parallel import create_mesh
    from ldm_tpu_torch.parallel.mesh import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = create_mesh(device=DEV)
        with tempfile.TemporaryDirectory() as workdir:
            cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=False, workdir=workdir)
            tr = mesh_trainer(cfg, mesh)
            if tr.graphs:
                raise AssertionError("a gloo step must run eagerly")
            losses, ms = [], []
            zero_counts()
            for batch, draws in global_steps(GLOO_STEPS, 23):
                t0 = time.perf_counter()
                losses.append(tr.train_step(shard_batch(mesh, batch), **draws)["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            state = attn_weights(tr.state.state_dict()["model"])
            state_all = {k: v.float().cpu() for k, v in tr.state.state_dict()["model"].items()}
            del tr
            clf = mesh_classifier(workdir, mesh)
            for b in classifier_batches(BN_STEPS, 24):
                clf.train_step(shard_batch(mesh, b))
            stats = {k: v.float().cpu() for k, v in clf.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
        torch.save({"losses": losses, "ms": ms, "counts": counts, "attn": state,
                    "model": state_all, "stats": stats},
                   os.path.join(outdir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def mesh_classifier(workdir: str, mesh) -> ResNetTrainer:
    """ResNet-18 fp32 at lr 0 (its statistics read the data alone), over
    ``mesh`` or one process."""
    cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=False, workdir=workdir, lr=0.0,
                              loss_fn="cross-entropy", project_name="clf_mesh")
    return ResNetTrainer(cfg, build_classifier(cfg, 3, 10, device=DEV), DataLoader(
        synthetic_dataset(SYNTHETIC_SIZE, 32, 3, train=True), TRAIN_B, seed=0), None,
        list(range(10)), device=DEV, graphs=False, mesh=mesh)


def check_mesh_gloo(tag: str) -> dict:
    """Phase 7f (b): two processes on the one card over gloo (eager by
    design: gloo's collectives stage CUDA tensors through the host), DP at
    global B=64, against one process at B=64 on the same global batches and
    draws: losses rtol 1e-5, parameters atol 5e-3 (the JAX DP bar); the
    classifier's running statistics after 4 steps at lr 0 within 1e-6.
    FSDP over two processes cannot run on one card: gloo has no all-gather
    or reduce-scatter for CUDA tensors and NCCL refuses two ranks on one
    GPU; the CPU tests run it."""
    port = free_port()
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                   str(r), str(port), outdir], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"gloo worker {r} failed:\n{logs[r][-4000:]}")
        outs = [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]
        cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=False, workdir=outdir)
        ref = mesh_trainer(cfg, None, graphs=False)
        want = [ref.train_step(b, **d)["loss"].item() for b, d in global_steps(GLOO_STEPS, 23)]
        ref_model = {k: v.float().cpu() for k, v in ref.state.state_dict()["model"].items()}
        del ref
        clf = mesh_classifier(outdir, None)
        for b in classifier_batches(BN_STEPS, 24):
            clf.train_step(b)
        ref_stats = {k: v.float().cpu() for k, v in clf.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
    out = {}
    for r, o in enumerate(outs):
        loss_rel = max(abs(a - b) / b for a, b in zip(o["losses"], want))
        param_abs = max(float((o["model"][k] - v).abs().max()) for k, v in ref_model.items())
        stat_abs = max(float((o["stats"][k] - v).abs().max()) for k, v in ref_stats.items())
        print(f"gloo rank {r}: losses {' '.join(f'{v:.6f}' for v in o['losses'])} (one process "
              f"{' '.join(f'{v:.6f}' for v in want)}): within {loss_rel:.2e} (rtol 1e-5); "
              f"parameters within {param_abs:.2e} (atol 5e-3); classifier running statistics "
              f"within {stat_abs:.2e} (1e-6); launches {o['counts']}")
        if loss_rel > 1e-5 or param_abs > 5e-3 or stat_abs > 1e-6:
            raise AssertionError(f"gloo rank {r} left the one-process run")
        if o["counts"] != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": 8 * GLOO_STEPS,
                                                       "linear_attention_bwd": 8 * GLOO_STEPS,
                                                       "fused_adam_ema": GLOO_STEPS}:
            raise AssertionError(f"gloo rank {r} launched {o['counts']}")
        out[f"rank{r}"] = {"loss_rel": loss_rel, "param_abs": param_abs, "stat_abs": stat_abs,
                           "step_ms": o["ms"], "launches": o["counts"]}
    steady = float(np.median([m for o in outs for m in o["ms"][1:]]))
    out["step_ms_median"] = steady
    print(f"gloo DP step, 2 processes on one card, fp32, global B={TRAIN_B} (32 a process), "
          f"eager by design: host {steady:.3f} ms a step (median of steps 2-{GLOO_STEPS} of both "
          f"processes; runs {' '.join(f'{m:.1f}' for m in outs[0]['ms'])}) [{tag}]")
    return out


def check_mesh_serving(config, tag: str) -> dict:
    """Phase 7f (c): the DDIM-50 service at B=64 with two replicas on the one
    card (``mesh=["cuda:0", "cuda:0"]``, 32 slots each, a graph each): the
    reference request alone and under load, bit for bit against the
    one-device service at the replicas' batch (B=32) and against itself:
    the service's contract, which is per device batch; the forward kernel's
    launches; and how far it lands from the one-device service at B=64,
    which the contract does not promise (cuDNN takes another bf16 algorithm
    for a 3x3 conv at 2B=64 than at 2B=128, so on a card a slot's image
    depends on the device's batch size)."""
    host = GaussianDiffusion(T_STEPS)
    steps = len(host.ddim_timesteps(50)[0])
    out = {}
    with tempfile.TemporaryDirectory() as d:
        ckpt = seeded_checkpoint(config, os.path.join(d, "diffusion_model_ema.pt"))
        images = {}
        for name, mesh, b in (("one", None, SERVE_B), ("one_b32", None, SERVE_B // 2),
                              ("mesh", ["cuda:0", "cuda:0"], SERVE_B)):
            zero_counts()
            svc = build_generation_service(config, ckpt, sampler="ddim", ddim_steps=50,
                                           batch_size=b, mesh=mesh)
            svc.start(warmup=True)
            try:
                alone = svc.submit(REF_CLASSES, n=10, seed=REF_SEED).result(timeout=600)
                loaded, _ = under_load(svc)
                t0 = time.perf_counter()
                futs = [svc.submit(i % 10, n=32, seed=9000 + i) for i in range(16)]
                for f in futs:
                    f.result(timeout=600)
                img_s = 512 / (time.perf_counter() - t0)
            finally:
                svc.stop()
            counts, batches = read_counts(), svc.stats().batches
            replicas = len(svc.devices)
            want = 8 * replicas * (steps * batches + WARMUP_STEPS)
            want_gn = GN_PIXEL * replicas * (steps * batches + WARMUP_STEPS)
            images[name] = (alone, loaded)
            print(f"  {name}: {replicas} replica(s), {batches} batches of {b}; forward "
                  f"launches {counts['linear_attention_fwd']} (want {want}); 512 images from 16 "
                  f"requests of 32 at once: {img_s:.2f} img/s [{tag}]")
            if counts != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": want,
                                                      "group_norm_silu": want_gn}:
                raise AssertionError(f"{name} service launched {counts}")
            out[name] = {"launches": counts["linear_attention_fwd"], "batches": batches,
                         "img_s_512": img_s}
    same = {f"{name} {how} == {ref} alone": np.array_equal(images[name][i], images[ref][0])
            for name, ref in (("mesh", "one_b32"), ("one_b32", "one_b32"), ("one", "one"))
            for i, how in ((0, "alone"), (1, "under load")) if (name, i) != (ref, 0)}
    off = np.abs(images["mesh"][0].astype(np.int32) - images["one"][0].astype(np.int32))
    out["vs_one_b64"] = {"pixels_differ": int((off > 0).sum()), "max_diff": int(off.max()),
                         "pixels": int(off.size)}
    print(f"mesh serving ddim-{steps} B={SERVE_B} over ['cuda:0', 'cuda:0']: {same} (the "
          f"contract: a slot's image is a one-device service's at B={SERVE_B // 2}, the "
          f"replicas' batch); against the one-device service at B={SERVE_B}, which the "
          f"contract does not promise (printed, not asserted): "
          f"{out['vs_one_b64']['pixels_differ']} of {off.size} values differ, by at most "
          f"{out['vs_one_b64']['max_diff']}")
    if not all(same.values()):
        raise AssertionError(f"mesh serving is not bit-identical: {same}")
    return out


def check_mesh_cli(config, tag: str) -> dict:
    """Phase 7f (d): ``python -m ldm_tpu_torch.train <flagship> --mesh`` (its
    ``main``, in this process: the group of one process it joins) for 2
    epochs of 9 steps: the counts, one record an epoch in metrics.jsonl and
    the checkpoints, written by rank 0 alone."""
    with tempfile.TemporaryDirectory() as workdir:
        path = write_config(os.path.join(workdir, "mesh.json"), FLAGSHIP, workdir=workdir,
                            epochs=2, sample_every=0,
                            data={"synthetic_size": SYNTHETIC_SIZE})
        zero_counts()
        res = train.main([path, "--mesh"])
        counts = read_counts()
        steps = res.trainer.state.step
        run = load_config(path).dirpath
        records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
        per_epoch = [sum(1 for r in records if r.get("epoch") == e) for e in range(2)]
        files = [f for f in ("checkpoints/state.pt", "checkpoints/diffusion_model_ema.pt")
                 if os.path.isfile(os.path.join(run, f))]
        print(f"train --mesh: {res.trainer.mesh}, {steps} steps {res.trainer.step_counts}, "
              f"losses {res.history['train_loss']}; launches {counts}; metrics records an epoch "
              f"{per_epoch}; files {files}")
        if (steps != 18 or per_epoch != [1, 1] or len(files) != 2
                or counts["linear_attention_bwd"] != 8 * steps
                or counts["fused_adam_ema"] != steps
                or not res.trainer.mesh.is_primary):
            raise AssertionError("train --mesh did not run as asked")
    return {"steps": steps, "launches": counts, "step_counts": res.trainer.step_counts}


def check_mesh(config, tag: str) -> dict:
    """Phase 7f: (a) world size 1 over NCCL, (b) two gloo processes, (c)
    mesh serving, (d) train --mesh."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        out = {"world1": check_mesh_world1(config, tag)}
        out["cli"] = check_mesh_cli(config, tag)
    finally:
        dist.destroy_process_group()
    out["gloo"] = check_mesh_gloo(tag)
    out["serving"] = check_mesh_serving(config, tag)
    return out


# ---------------------------------------------------------------- phase 7h
AXIS_MODES = ("tp", "fsdp_tp", "spatial")
AXIS_STEPS = GLOO_STEPS
AXIS_BUDGET_S = 120
AXIS_SAMPLE_TOL = 1e-3  # fp32 trajectories (the graphed-vs-eager-vs-plain bar)
AXIS_SAMPLED = ("tp", "spatial")


def axis_config(workdir: str, mode: str):
    """The flagship config in fp32 under a model-axis placement: ``tp`` /
    ``fsdp_tp`` parameters, or ``spatial`` activations."""
    cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=False, workdir=workdir)
    if mode == "spatial":
        return dataclasses.replace(cfg, activation_sharding="spatial")
    return dataclasses.replace(cfg, param_sharding=mode)


def rule_bytes(cfg, model: int) -> tuple:
    """(bytes a process holds of the flagship's fp32 parameters under the TP
    rule over a model axis of ``model``, bytes of the whole model): from
    the shapes alone."""
    from ldm_tpu_torch.parallel.tp import tp_leaf_spec

    shapes = {n: tuple(p.shape) for n, p in build_model(cfg, "cpu").named_parameters()}
    whole = sum(4 * int(np.prod(v)) for v in shapes.values())
    share = sum(4 * int(np.prod(v)) // (model if tp_leaf_spec(n.split("."), v, model) else 1)
                for n, v in shapes.items())
    return share, whole


def axis_worker(rank: int, port: int, outdir: str) -> None:
    """One of phase 7h (a)'s two processes on the one card: a (data=1,
    model=2) mesh over gloo (eager steps by design), fp32, global B=64, each
    placement of ``AXIS_MODES`` for ``AXIS_STEPS`` steps on the given global
    batches and draws; its bytes of the parameters, host ms a step, the
    launches; then the DDIM-50 request at B=10 from the EMA under tp and
    spatial."""
    import torch.distributed as dist

    from ldm_tpu_torch.parallel import create_mesh, fsdp
    from ldm_tpu_torch.parallel.mesh import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = create_mesh(model=2, device=DEV)
        # gloo's MAX on a CUDA tensor (the spatial k-softmax shift's reduction)
        m = torch.tensor([float(rank), -float(rank)], device=DEV)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.model_group)
        res = {"mesh": repr(mesh), "gloo_max": m.tolist()}
        with tempfile.TemporaryDirectory() as workdir:
            for mode in AXIS_MODES:
                cfg = axis_config(workdir, mode)
                tr = mesh_trainer(cfg, mesh)
                if tr.graphs:
                    raise AssertionError("a gloo step must run eagerly")
                losses, gnorms, ms = [], [], []
                zero_counts()
                for batch, draws in global_steps(AXIS_STEPS, 31):
                    t0 = time.perf_counter()
                    m = tr.train_step(shard_batch(mesh, batch), **draws)
                    losses.append(m["loss"].item())
                    ms.append((time.perf_counter() - t0) * 1e3)
                    gnorms.append(m["grad_norm"].item())
                out = {"losses": losses, "grad_norms": gnorms, "ms": ms, "counts": read_counts(),
                       "bytes": sum(fsdp.local(p).nbytes for p in tr.model.parameters()),
                       "impls": sorted({str(b.impl) for b in tr.model.lin_attn_blocks()})}
                state = tr.state.state_dict()  # gathered: every process calls it
                out["model"] = {k: v.float().cpu() for k, v in state["model"].items()}
                if mode in AXIS_SAMPLED:
                    out["ema"] = {k: v.cpu() for k, v in state["ema"].items()}
                    zero_counts()
                    t0 = time.perf_counter()
                    out["x0"] = tr.sample_x0(REF_CLASSES, cfg_scale=3.0, method="ddim",
                                             ddim_steps=50).cpu()
                    out["sample_s"] = time.perf_counter() - t0
                    out["sample_counts"] = read_counts()
                res[mode] = out
                del tr, state
                torch.cuda.empty_cache()
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def check_axis_gloo(tag: str, gloo_dp_ms: float) -> dict:
    """Phase 7h (a) and (b): two processes on the one card over gloo as a
    (data=1, model=2) mesh, each placement against one process on the same
    global batches and draws (losses rtol 1e-5, parameters atol 5e-3: the
    JAX TP / SP bars; each step's gradient norm rtol 1e-5), no attention
    kernel launched; the DDIM-50 request at B=10 under tp and spatial
    against one process from the same EMA weights and x_T (fp32, 1e-3).
    The one-process reference runs the attention the model axis runs
    (``impl="torch"``, plain PyTorch); the kernel path's distance from it is
    printed beside."""
    port = free_port()
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--axis-worker",
                                   str(r), str(port), outdir], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=AXIS_BUDGET_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"model-axis worker {r} failed:\n{logs[r][-4000:]}")
        outs = [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]
        cfg = axis_config(outdir, "tp")
        want, ref_model, ref_x0 = {}, {}, {}
        for impl in ("torch", None):
            ref = mesh_trainer(cfg, None, graphs=False, attention_impl=impl)
            steps = [ref.train_step(b, **d) for b, d in global_steps(AXIS_STEPS, 31)]
            want[impl] = [m["loss"].item() for m in steps]
            if impl == "torch":
                want_gnorms = [m["grad_norm"].item() for m in steps]
                ref_model = {k: v.float().cpu() for k, v in ref.state.state_dict()["model"].items()}
                for mode in AXIS_SAMPLED:
                    ref.state.ema.load_state_dict(outs[0][mode]["ema"])
                    ref_x0[mode] = ref.sample_x0(REF_CLASSES, cfg_scale=3.0, method="ddim",
                                                 ddim_steps=50).cpu()
            del ref
            torch.cuda.empty_cache()
    share, whole = rule_bytes(cfg, 2)
    none = dict.fromkeys(COUNTED, 0)
    print(f"{outs[0]['mesh']}; one process on the same batches and draws, the model axis's "
          f"attention (plain): losses {' '.join(f'{v:.6f}' for v in want['torch'])}, gradient "
          f"norms {' '.join(f'{v:.6f}' for v in want_gnorms)}; the kernel path's losses: "
          f"{' '.join(f'{v:.6f}' for v in want[None])} (within "
          f"{max(abs(a - b) / b for a, b in zip(want[None], want['torch'])):.2e}, printed); "
          f"gloo MAX over the model group on cuda tensors {[o['gloo_max'] for o in outs]}")
    if any(o["gloo_max"] != [1.0, 0.0] for o in outs):
        raise AssertionError("gloo's MAX over the model group went wrong")
    out = {"gloo_dp_step_ms": gloo_dp_ms}
    for mode in AXIS_MODES:
        out[mode] = {}
        for r, o in enumerate(outs):
            m = o[mode]
            loss_rel = max(abs(a - b) / b for a, b in zip(m["losses"], want["torch"]))
            gnorm_rel = max(abs(a - b) / b for a, b in zip(m["grad_norms"], want_gnorms))
            param_abs = max(float((m["model"][k] - v).abs().max()) for k, v in ref_model.items())
            expect = whole if mode == "spatial" else share
            print(f"  {mode} rank {r}: losses {' '.join(f'{v:.6f}' for v in m['losses'])}: "
                  f"within {loss_rel:.2e} (rtol 1e-5); gradient norms within {gnorm_rel:.2e} "
                  f"(rtol 1e-5); parameters within {param_abs:.2e} "
                  f"(atol 5e-3); attention {m['impls']}, launches in {AXIS_STEPS} steps "
                  f"{m['counts']}; parameter bytes {m['bytes']:,} (the rule: {expect:,} of "
                  f"{whole:,}); host ms a step {' '.join(f'{v:.1f}' for v in m['ms'])} [{tag}]")
            if loss_rel > 1e-5 or gnorm_rel > 1e-5 or param_abs > 5e-3:
                raise AssertionError(f"{mode} rank {r} left the one-process run")
            # no attention kernel at model 2; the optimizer's pass a step
            if m["counts"] != none | {"fused_adam_ema": AXIS_STEPS} or m["impls"] != ["torch"]:
                raise AssertionError(f"{mode} rank {r} launched {m['counts']}")
            if m["bytes"] != expect:
                raise AssertionError(f"{mode} rank {r} holds {m['bytes']} bytes, not {expect}")
            row = {"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel, "param_abs": param_abs,
                   "bytes": m["bytes"],
                   "step_ms": m["ms"], "launches": m["counts"]}
            if mode in AXIS_SAMPLED:
                err = float((m["x0"] - ref_x0[mode]).abs().max())
                print(f"  {mode} rank {r}: DDIM-50 at B=10, CFG 3, fp32, from the same EMA and "
                      f"x_T: within {err:.2e} of one process (bar {AXIS_SAMPLE_TOL}); "
                      f"{m['sample_s']:.2f} s; launches {m['sample_counts']} [{tag}]")
                if err > AXIS_SAMPLE_TOL or m["sample_counts"] != none:
                    raise AssertionError(f"{mode} rank {r}: the sampler left one process")
                row.update(sample_err=err, sample_s=m["sample_s"])
            out[mode][f"rank{r}"] = row
        steady = float(np.median([v for o in outs for v in o[mode]["ms"][1:]]))
        out[mode]["step_ms_median"] = steady
        print(f"{mode} step, 2 processes on one card as (data=1, model=2), fp32, global "
              f"B={TRAIN_B}, eager by design: host {steady:.3f} ms a step (median of steps "
              f"2-{AXIS_STEPS} of both processes), phase 7f's gloo DP step {gloo_dp_ms:.3f} ms "
              f"[{tag}]")
    out["bytes_rule"] = {"tp_share": share, "whole": whole}
    return out


def check_axis_world1(config, tag: str) -> dict:
    """Phase 7h (c): ``param_sharding: tp`` at model = 1 over a NCCL group of
    this process alone, graphed: the rule shards nothing at M = 1, so the
    kernels stay (8 + 8 launches a replayed step) and the step is the
    one-process step bit for bit (fp32, 8 steps)."""
    import torch.distributed as dist

    from ldm_tpu_torch.parallel import create_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {"launches": {}}
    try:
        mesh = create_mesh(device=DEV)
        with tempfile.TemporaryDirectory() as workdir:
            cfg = dataclasses.replace(config, use_amp=False, workdir=workdir)
            runs = graphed_fp32_runs(cfg, (("one", "replicated", None, 1),
                                           ("tp_model1", "tp", mesh, 1)), out)
        if runs["tp_model1"][3]:
            raise AssertionError("the TP rule sharded a leaf at M = 1")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        dist.destroy_process_group()
    return out


def check_model_axis(config, tag: str, gloo_dp_ms: float) -> dict:
    """Phase 7h: (a) and (b) two gloo processes as a (1, 2) mesh, (c) tp at
    model = 1 over NCCL, (d) the phase within its budget."""
    t0 = time.perf_counter()
    out = {"gloo": check_axis_gloo(tag, gloo_dp_ms), "world1": check_axis_world1(config, tag)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 7h wall time {out['seconds']:.1f} s (budget {AXIS_BUDGET_S} s)")
    if out["seconds"] > AXIS_BUDGET_S:
        raise AssertionError(f"phase 7h took {out['seconds']:.1f} s, over {AXIS_BUDGET_S} s")
    return out


# ---------------------------------------------------------------- phase 7i
PP_M, PP_M_ALSO = 2, 4
PP_STEPS = GLOO_STEPS
PP_BUDGET_S = 60
PP_SAMPLE_B, PP_SAMPLE_STEPS = 10, 50
PP_SAMPLE_TOL = 1e-3  # fp32 trajectories (the graphed-vs-eager-vs-plain bar)
# the flagship's fp32 parameter bytes by stage: conditioning, stem, encoder
# and bottleneck; decoder and head
PP_STAGE_BYTES = (62_785_536, 18_618_124)
PP_SITES = 4  # attention blocks a stage: the encoder's, the decoder's


def seeded_unet(cfg, seed: int = 11):
    """The flagship UNet of ``cfg`` from ``seed`` on the card (``mesh_trainer``'s)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(cfg, DEV)


def pp_steps(forward, params, cfg, steps: list, norm) -> dict:
    """Adam at the config's learning rate on ``params`` over ``steps``
    (``global_steps``: the whole batch and its draws t, eps and the drop
    mask), by the diffusion trainer's loss: x_t from (x0, t, eps), dropped
    labels to the null label, the mean squared error of ``forward(x_t, t,
    y)`` against eps.  Each step's loss, gradient norm (``norm()``), host ms
    and kernel launches."""
    diffusion = build_diffusion(cfg, DEV)
    opt = torch.optim.Adam(params, lr=cfg.lr, foreach=True)
    out = {"losses": [], "grad_norms": [], "ms": [], "counts": []}
    for batch, d in steps:
        x0, y = batch["image"].to(DEV), batch["label"].to(DEV)
        t, eps, drop = d["t"].to(DEV), d["eps"].to(DEV), d["drop"].to(DEV).expand(y.shape)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        target, xt, t_in = diffusion.noised(x0, t, eps)
        loss = torch.mean((target - forward(xt, t_in, torch.where(drop, 10, y))) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        out["grad_norms"].append(norm().item())
        opt.step()
        out["losses"].append(loss.item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"].append(read_counts())
    return out


def pp_sample(cfg, model_fn, graph) -> tuple:
    """The DDIM-50 request at B=10, CFG 3, fp32, from a fixed x_T (``graph``
    the sampler's): x_0, seconds, launches."""
    g = torch.Generator().manual_seed(REF_SEED)
    x_init = torch.randn((PP_SAMPLE_B, 32, 32, 3), generator=g).to(DEV)
    classes = torch.tensor(REF_CLASSES, device=DEV)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    x0 = build_diffusion(cfg, DEV).sample_ddim(
        model_fn, classes, (32, 32, 3), n_sample_steps=PP_SAMPLE_STEPS, cfg_scale=3.0,
        null_label=10, x_init=x_init, graph=graph)
    x0 = x0.cpu()
    return x0, time.perf_counter() - t0, read_counts()


def pp_worker(rank: int, port: int, outdir: str) -> None:
    """One of phase 7i (b)-(c)'s two processes on the one card: a (data=1,
    model=2) gloo mesh (eager by design), fp32, this process's stage of the
    seeded flagship; ``PP_STEPS`` steps at global B=64 at M = 2 and at M = 4,
    the weights gathered after the M = 2 run, its DDIM-50 request through
    ``make_pp_apply``."""
    import torch.distributed as dist

    from ldm_tpu_torch.parallel import create_mesh, pp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        mesh = create_mesh(model=2, device=DEV)
        cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=False)
        res = {"mesh": repr(mesh)}
        for m in (PP_M, PP_M_ALSO):
            stage = pp.pp_stage(mesh, seeded_unet(cfg))
            run = pp_steps(lambda *a: pp.pipeline_unet_apply(mesh, stage, *a, m),
                           list(stage.parameters()), cfg, global_steps(PP_STEPS, 37),
                           lambda: pp.grad_norm(stage, mesh))
            run["bytes"] = sum(p.nbytes for p in stage.parameters())
            run["payload_bytes"] = 4 * sum(int(np.prod(s)) for s in pp.payload_shapes(
                stage, TRAIN_B // m, 32, 32))
            res[m] = run
            if m == PP_M:
                res["model"] = {k: v.cpu() for k, v in pp.gather_state_dict(stage, mesh).items()}
                stage.eval()
                # graph=None: the sampler asks use_graphs with the apply's mesh
                res["x0"], res["sample_s"], res["sample_counts"] = pp_sample(
                    cfg, pp.make_pp_apply(mesh, stage, PP_M), None)
            del stage
            torch.cuda.empty_cache()
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def check_pp_payload(config) -> dict:
    """Phase 7i (a): one process, bf16, the kernel path, 2B=128:
    ``decode(*encode(...))`` is ``forward`` bit for bit, ``decode`` on the
    unpacked payload is ``decode`` on the tensors packed bit for bit (the
    skips unpacked as NCHW views of NHWC memory, as ``encode`` made them),
    and the staged pass launches the forward kernel 8 times."""
    from ldm_tpu_torch.parallel import pp

    b = 2 * SERVE_B
    model = seeded_unet(config).eval()
    g = torch.Generator().manual_seed(41)
    x = torch.randn((b, 32, 32, 3), generator=g).to(DEV)
    t = torch.randint(0, T_STEPS, (b,), generator=g).to(DEV)
    y = torch.randint(0, 11, (b,), generator=g).to(DEV)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with torch.inference_mode():
            whole = model(x, t, y)
            zero_counts()
            mid, skips, temb = model.encode(x, t, y)
            staged = model.decode(mid, skips, temb)
            counts = read_counts()
            buf = pp.pack_payload(mid, skips, temb)
            moved = model.decode(*pp.unpack_payload(buf, pp.payload_shapes(model, b, 32, 32)))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    out = {"staged_equal": torch.equal(staged, whole), "payload_equal": torch.equal(moved, staged),
           "payload_bytes": buf.nbytes, "dtype": str(buf.dtype), "launches": counts}
    print(f"(a) one process, bf16, 2B={b}: decode(*encode) == forward bit for bit: "
          f"{out['staged_equal']}; decode on the unpacked payload ({buf.numel():,} values, "
          f"{buf.nbytes:,} bytes, {buf.dtype}) == decode on the packed tensors: "
          f"{out['payload_equal']}; launches of the staged pass {counts}")
    if not (out["staged_equal"] and out["payload_equal"]):
        raise AssertionError("the staged UNet or the payload changed the bits")
    if counts != dict.fromkeys(COUNTED, 0) | {"linear_attention_fwd": 2 * PP_SITES,
                                              "group_norm_silu": GN_PIXEL}:
        raise AssertionError(f"the staged pass launched {counts}")
    return out


def check_pp_gloo(tag: str, gloo_dp_ms: float, tp_ms: float) -> dict:
    """Phase 7i (b)-(c): two processes on the one card over gloo as a
    (data=1, model=2) mesh, each holding its stage, against one process
    running the whole UNet through the same recipe on the same batches and
    draws, the kernels in both (fp32): losses and gradient norms rtol 1e-5,
    parameters atol 5e-3 (the phase 7h bars), each process's parameter
    bytes its stage's, 4 M forward and 4 M backward launches a step; the
    DDIM-50 request at B=10 (M = 2) from the same weights and x_T within
    1e-3, 4 M forward launches a step."""
    port = free_port()
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--pp-worker",
                                   str(r), str(port), outdir], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PP_BUDGET_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"pipeline worker {r} failed:\n{logs[r][-4000:]}")
        outs = [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]
    cfg = dataclasses.replace(load_config(FLAGSHIP), use_amp=False)
    model = seeded_unet(cfg)
    params = list(model.parameters())
    ref = pp_steps(model, params, cfg, global_steps(PP_STEPS, 37),
                   lambda: global_norm([p.grad for p in params]))
    ref_model = {k: v.cpu() for k, v in model.state_dict().items()}
    model.load_state_dict(outs[0]["model"])
    ref_x0, ref_s, _ = pp_sample(cfg, model.eval(), False)
    del model, params
    torch.cuda.empty_cache()
    print(f"{outs[0]['mesh']}; one process, the whole UNet, the kernels, on the same batches "
          f"and draws: losses {' '.join(f'{v:.6f}' for v in ref['losses'])}, gradient norms "
          f"{' '.join(f'{v:.6f}' for v in ref['grad_norms'])}; host ms a step "
          f"{' '.join(f'{v:.1f}' for v in ref['ms'])}")
    per_step = dict.fromkeys(COUNTED, 0)
    out = {"gloo_dp_step_ms": gloo_dp_ms, "tp_step_ms": tp_ms,
           "one_process_step_ms": float(np.median(ref["ms"][1:]))}
    for m in (PP_M, PP_M_ALSO):
        want_counts = per_step | {"linear_attention_fwd": PP_SITES * m,
                                  "linear_attention_bwd": PP_SITES * m}
        out[m] = {}
        for r, o in enumerate(outs):
            run = o[m]
            loss_rel = max(abs(a - b) / b for a, b in zip(run["losses"], ref["losses"]))
            gnorm_rel = max(abs(a - b) / b for a, b in zip(run["grad_norms"], ref["grad_norms"]))
            row = {"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel, "bytes": run["bytes"],
                   "step_ms": run["ms"], "launches_per_step": run["counts"][0],
                   "launches": {k: sum(c[k] for c in run["counts"]) for k in COUNTED},
                   "payload_bytes": run["payload_bytes"]}
            line = (f"  M={m} rank {r}: losses {' '.join(f'{v:.6f}' for v in run['losses'])}: "
                    f"within {loss_rel:.2e} (rtol 1e-5); gradient norms within {gnorm_rel:.2e} "
                    f"(rtol 1e-5)")
            if m == PP_M:
                row["param_abs"] = max(float((o["model"][k] - v).abs().max())
                                       for k, v in ref_model.items())
                line += f"; parameters gathered within {row['param_abs']:.2e} (atol 5e-3)"
                if row["param_abs"] > 5e-3:
                    raise AssertionError(f"pipeline rank {r}'s parameters left one process")
            print(f"{line}; parameter bytes {run['bytes']:,} (its stage: "
                  f"{PP_STAGE_BYTES[r]:,}); a payload transfer {run['payload_bytes']:,} bytes; "
                  f"launches a step {run['counts'][0]}; host ms a step "
                  f"{' '.join(f'{v:.1f}' for v in run['ms'])} [{tag}]")
            if loss_rel > 1e-5 or gnorm_rel > 1e-5:
                raise AssertionError(f"pipeline rank {r} at M={m} left the one-process run")
            if run["bytes"] != PP_STAGE_BYTES[r]:
                raise AssertionError(f"pipeline rank {r} holds {run['bytes']} parameter bytes, "
                                     f"not {PP_STAGE_BYTES[r]}")
            if any(c != want_counts for c in run["counts"]):
                raise AssertionError(f"pipeline rank {r} at M={m} launched {run['counts']}, "
                                     f"want {want_counts} a step")
            out[m][f"rank{r}"] = row
        steady = float(np.median([v for o in outs for v in o[m]["ms"][1:]]))
        out[m]["step_ms_median"] = steady
        print(f"pipeline step, 2 processes on one card as (data=1, model=2), fp32, global "
              f"B={TRAIN_B}, M={m}, eager by design: host {steady:.3f} ms a step (median of "
              f"steps 2-{PP_STEPS} of both processes); one process {out['one_process_step_ms']:.3f}"
              f" ms, phase 7f's gloo DP step {gloo_dp_ms:.3f} ms, phase 7h's tp step "
              f"{tp_ms:.3f} ms [{tag}]")
    if any(not torch.equal(outs[1]["model"][k], v) for k, v in outs[0]["model"].items()):
        raise AssertionError("the two processes gathered different weights")
    want_sample = per_step | {"linear_attention_fwd": PP_SITES * PP_M * PP_SAMPLE_STEPS}
    for r, o in enumerate(outs):
        err = float((o["x0"] - ref_x0).abs().max())
        print(f"  rank {r}: DDIM-50 at B={PP_SAMPLE_B} (2B={2 * PP_SAMPLE_B}, M={PP_M}), CFG 3, "
              f"fp32, through make_pp_apply, eager: within {err:.2e} of one process (bar "
              f"{PP_SAMPLE_TOL}); {o['sample_s']:.2f} s (one process, eager: {ref_s:.2f} s); "
              f"launches {o['sample_counts']} [{tag}]")
        if err > PP_SAMPLE_TOL or not torch.isfinite(o["x0"]).all():
            raise AssertionError(f"pipeline rank {r}: the sampler left one process")
        if o["sample_counts"] != want_sample:
            raise AssertionError(f"pipeline rank {r}'s request launched {o['sample_counts']}, "
                                 f"want {want_sample}")
        out[f"sample_rank{r}"] = {"err": err, "seconds": o["sample_s"],
                                  "launches": o["sample_counts"]}
    out["sample_one_process_s"] = ref_s
    return out


def check_pipeline(config, tag: str, gloo_dp_ms: float, tp_ms: float) -> dict:
    """Phase 7i: (a) the staged UNet and the payload in one process, (b)-(c)
    two gloo processes as a (1, 2) pipeline, (d) the phase within its
    budget."""
    t0 = time.perf_counter()
    out = {"payload": check_pp_payload(config), "gloo": check_pp_gloo(tag, gloo_dp_ms, tp_ms)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 7i wall time {out['seconds']:.1f} s (budget {PP_BUDGET_S} s)")
    if out["seconds"] > PP_BUDGET_S:
        raise AssertionError(f"phase 7i took {out['seconds']:.1f} s, over {PP_BUDGET_S} s")
    return out


# ---------------------------------------------------------------- phase 7g
def trace_device_events(trace_dir: str) -> list:
    """The device's events (kernels, copies, sets) of the one Chrome trace
    under ``trace_dir``, largest first."""
    paths = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    if len(paths) != 1:
        raise AssertionError(f"want one trace under {trace_dir}, found {paths}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sorted(device, key=lambda e: -e.get("dur", 0))


def request_b10(path: str, workdir: str, *extra) -> "generate.Generated":
    """The DDIM-50 request of 10 images (one a class) through ``generate.main``."""
    return generate.main([path, "--sampler", "ddim", "--ddim-steps", "50", "--per-class", "1",
                          "--out", os.path.join(workdir, "b10.npy"), *extra])


def check_workflow(tag: str, vae_pt: str) -> dict:
    """Phase 7g: the reference's workflow at the flagship width, bf16,
    graphed: (a) ``train.main --profile`` for 2 epochs of 9 steps at B=64,
    (b) ``generate`` from its checkpoint into the PNG tree, (c)
    ``train_classifier --pretrain-dir`` on that tree, (d) the checkpoint
    bridge both ways (the UNet's EMA, the classifier, the VAE of 7e)."""
    out = {}
    t_phase = time.perf_counter()
    host = GaussianDiffusion(T_STEPS)
    ddim_steps = len(host.ddim_timesteps(50)[0])
    with tempfile.TemporaryDirectory() as workdir:
        # (a) train with a trace
        path = write_config(os.path.join(workdir, "wf.json"), FLAGSHIP, workdir=workdir,
                            epochs=2, sample_every=0, data={"synthetic_size": SYNTHETIC_SIZE})
        config = load_config(path)
        trace_dir = os.path.join(workdir, "trace")
        zero_counts()
        t0 = time.perf_counter()
        run = train.main([path, "--profile", trace_dir])
        seconds = {"train": time.perf_counter() - t0}
        counts, steps = read_counts(), run.trainer.state.step
        events = trace_device_events(trace_dir)
        by_cat = {c: sum(e["cat"] == c for e in events)
                  for c in ("kernel", "gpu_memcpy", "gpu_memset")}
        kernels = [e for e in events if e["cat"] == "kernel"]
        print(f"(a) train --profile: {steps} steps {run.trainer.step_counts} in "
              f"{seconds['train']:.1f} s (profiler on; builds, captures, checkpoints and the "
              f"trace's export included), losses {run.history['train_loss']}; launches {counts}; "
              f"the trace holds {len(events)} device events {by_cat}, the 5 largest (us): "
              + "; ".join(f"{e['name'][:70]} {e['dur']}" for e in events[:5])
              + "; the 5 largest kernels (us): "
              + "; ".join(f"{e['name'][:70]} {e['dur']}" for e in kernels[:5]) + f" [{tag}]")
        if (steps != 18 or counts["linear_attention_bwd"] != 8 * steps
                or counts["fused_adam_ema"] != steps or not events
                or not np.isfinite(run.history["train_loss"]).all()):
            raise AssertionError(f"train --profile: {steps} steps, {counts}, {len(events)} "
                                 "device events")
        out["train"] = {"steps": steps, "launches": counts, "device_events": by_cat,
                        "top5_us": [[e["name"][:100], e["dur"]] for e in events[:5]],
                        "top5_kernels_us": [[e["name"][:100], e["dur"]] for e in kernels[:5]]}

        # (b) generate from the trained checkpoint into the PNG tree
        zero_counts()
        t0 = time.perf_counter()
        g = generate.main([path, "--sampler", "ddim", "--ddim-steps", "50", "--per-class",
                           "32", "--out", os.path.join(workdir, "tree.npy")])
        seconds["generate"] = time.perf_counter() - t0
        counts = read_counts()
        want = dict.fromkeys(COUNTED, 0) | {
            "linear_attention_fwd": 8 * (ddim_steps + WARMUP_STEPS),
            "group_norm_silu": GN_PIXEL * (ddim_steps + WARMUP_STEPS)}
        back = load_image_folder(config.results, config.data.image_size)
        # the reader's order: class directories, then file names, as strings
        order = sorted(range(len(g.paths)), key=lambda i: g.paths[i].split(os.sep)[-2:])
        classes = np.repeat(np.arange(10), 32)[order]
        ok = {"320 PNGs": len(g.paths) == 320 and all(os.path.isfile(q) for q in g.paths),
              "tree read back bit for bit": np.array_equal(back.images, g.images[order])
              and np.array_equal(back.labels, classes),
              "launches": counts == want}
        tree = shutil.copytree(config.results, os.path.join(workdir, "tree"))
        ck = config.checkpoints
        ema, raw = request_b10(path, workdir), request_b10(path, workdir, "--no-ema")
        ok["default == --weights diffusion_model_ema.pt"] = np.array_equal(
            ema.images, request_b10(path, workdir, "--weights",
                                    os.path.join(ck, "diffusion_model_ema.pt")).images)
        ok["--no-ema == --weights diffusion_model.pt"] = np.array_equal(
            raw.images, request_b10(path, workdir, "--weights",
                                    os.path.join(ck, "diffusion_model.pt")).images)
        ok["ema != raw"] = not np.array_equal(ema.x0, raw.x0)
        empty = write_config(os.path.join(workdir, "empty.json"), FLAGSHIP,
                             workdir=os.path.join(workdir, "empty"))
        try:
            request_b10(empty, workdir)
            ok["a missing checkpoint raises"] = False
        except FileNotFoundError as e:
            ok["a missing checkpoint raises"] = "diffusion_model_ema.pt" in str(e)
        print(f"(b) generate ddim-{ddim_steps} --per-class 32 (B=320, CFG 3, bf16) from the "
              f"trained diffusion_model_ema.pt: {g.seconds:.3f} s ({320 / g.seconds:.1f} img/s, "
              f"warm-up and capture {g.capture_seconds:.3f} s), {seconds['generate']:.1f} s with "
              f"the model's load and the PNGs; launches {counts} (want {want}); {ok} [{tag}]")
        if not all(ok.values()):
            raise AssertionError(f"generate from the checkpoint: {ok}")
        out["generate"] = {"seconds": g.seconds, "capture_seconds": g.capture_seconds,
                           "launches": counts["linear_attention_fwd"],
                           "gn_launches": counts["group_norm_silu"]}

        # (c) the classifier on the tree
        clf_path = write_config(os.path.join(workdir, "clf.json"), FLAGSHIP,
                                workdir=os.path.join(workdir, "clf"), epochs=2, sample_every=0,
                                data={"synthetic_size": SYNTHETIC_SIZE})
        zero_counts()
        t0 = time.perf_counter()
        clf = train_classifier.main([clf_path, "--pretrain-dir", tree])
        seconds["classifier"] = time.perf_counter() - t0
        counts = read_counts()
        ct = clf.trainer
        epoch_steps = 2 * (ct.epoch_scan.n_batches if ct.epoch_scan is not None
                           else len(ct.train_loader))
        pre_steps = ct.state.step - epoch_steps
        print(f"(c) train_classifier --pretrain-dir (ResNet-18, B={TRAIN_B}, bf16, 2 epochs): "
              f"pretrain {pre_steps} steps (want {320 // TRAIN_B}) loss "
              f"{clf.pretrain['loss']:.4f}, then {epoch_steps} steps, steps "
              f"{ct.step_counts}; test F1 micro {clf.test['f1_micro']:.4f} macro "
              f"{clf.test['f1_macro']:.4f}; wall s pretrain {clf.seconds['pretrain']:.3f}, train "
              f"{clf.seconds['train']:.3f}, test {clf.seconds['test']:.3f}; launches {counts} "
              f"[{tag}]")
        if (pre_steps != 320 // TRAIN_B
                or counts != dict.fromkeys(COUNTED, 0) | {"fused_adam_ema": ct.state.step}
                or sum(ct.step_counts.values()) != ct.state.step
                or not np.isfinite(clf.test["loss"])):
            raise AssertionError(f"train_classifier: {pre_steps} pretrain steps, {counts}")
        out["classifier"] = {"pretrain_steps": pre_steps, "step_counts": ct.step_counts,
                             "test": clf.test, "seconds": clf.seconds}

        # (d) the bridge: the UNet's EMA, the classifier, the VAE, out and back in
        t0 = time.perf_counter()
        fresh = os.path.join(workdir, "fresh")
        ok = {}
        unet_pt = export_torch_checkpoint.main([path, "--ema", "--out",
                                                os.path.join(workdir, "unet_ref.pt")])
        fresh_unet = write_config(os.path.join(workdir, "fresh_unet.json"), FLAGSHIP,
                                  workdir=fresh)
        import_torch_checkpoint.main([unet_pt, fresh_unet])
        ok["DDIM-50 B=10 from the imported EMA == from the original"] = np.array_equal(
            request_b10(fresh_unet, workdir).x0, request_b10(path, workdir).x0)
        clf_pt = export_torch_checkpoint.main([os.path.join(load_config(clf_path).checkpoints,
                                                            "resnet.pt"), clf_path,
                                               "--out", os.path.join(workdir, "clf_ref.pt")])
        fresh_clf = write_config(os.path.join(workdir, "fresh_clf.json"), clf_path,
                                 workdir=fresh)
        import_torch_checkpoint.main([clf_pt, fresh_clf])
        fcfg = load_config(fresh_clf)
        _, val_loader, test_loader, classes = create_dataloaders(fcfg)
        tester = ResNetTrainer(fcfg, build_classifier(fcfg, fcfg.data.image_channels,
                                                      len(classes), DEV), ct.train_loader,
                               val_loader, classes, test_loader=test_loader, name="classifier")
        f1 = tester.test()
        ok["classifier test F1 after the round trip"] = (
            f1["f1_micro"] == clf.test["f1_micro"] and f1["f1_macro"] == clf.test["f1_macro"])
        vae_ref = export_torch_checkpoint.main([vae_pt, AE_CONFIG, "--out",
                                                os.path.join(workdir, "vae_ref.pt")])
        fresh_vae = write_config(os.path.join(workdir, "fresh_vae.json"), AE_CONFIG,
                                 workdir=fresh)
        vae_in = import_torch_checkpoint.main([vae_ref, fresh_vae])
        before = torch.load(vae_pt, map_location="cpu", weights_only=True)
        after = torch.load(vae_in, map_location="cpu", weights_only=True)
        ok["the 7e VAE tensor for tensor"] = before.keys() == after.keys() and all(
            torch.equal(before[k], after[k]) for k in before)
        seconds["bridge"] = time.perf_counter() - t0
        print(f"(d) the bridge, export then import: {ok}; {seconds['bridge']:.1f} s [{tag}]")
        if not all(ok.values()):
            raise AssertionError(f"the bridge: {ok}")
    seconds["phase"] = time.perf_counter() - t_phase
    out["seconds"] = seconds
    print(f"phase 7g seconds by stage: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}"
          f" (budget 60) [{tag}]")
    if seconds["phase"] > 60:
        raise AssertionError(f"phase 7g took {seconds['phase']:.1f} s, over its 60 s budget")
    return out


# ---------------------------------------------------------------- phase 7l
RES64 = "configs/protocol_hard_64.yaml"
RES64_SIZE, RES64_N_FID, RES64_VAL_BATCHES = 2560, 128, 4  # 256 validation images of 64
RES_SP_SIZES, RES_SP_CHECK = (32, 64, 128), (64,)
FWD_BWD_ADAM = {"linear_attention_fwd": 8, "linear_attention_bwd": 8, "resnet_block_fwd": 0,
                "fused_adam_ema": 1, "group_norm_silu": 0}  # a train step's launches


def res64_launches(steps: int, batches: int, warm: bool) -> dict:
    """Probe 39's launches by phase from the shapes: Phase A 8 + 8 a train
    step and 16 a validation batch (the CFG pair), one Adam + EMA pass a
    step; the classifier no attention and one pass a step (an epoch of
    ``RES64_SIZE // 64`` steps); Phase C 8 a sampler step over ``batches``
    batches (one more with ``warm``) plus the 3 eager warm-up steps of the
    one capture; the GroupNorm pass GN_PIXEL a forward outside autograd."""
    zero = dict.fromkeys(FWD_BWD_ADAM, 0)
    n = batches + int(warm)
    c = {f"C_{name}": zero | {"linear_attention_fwd": 8 * (k * n + WARMUP_STEPS),
                              "group_norm_silu": GN_PIXEL * (k * n + WARMUP_STEPS)}
         for name, k in (("ddpm400", T_STEPS), ("ddim50", 50))}
    if warm:
        return c
    return c | {"A": {"linear_attention_fwd": 8 * steps + 16 * RES64_VAL_BATCHES,
                      "linear_attention_bwd": 8 * steps, "resnet_block_fwd": 0,
                      "fused_adam_ema": steps,
                      "group_norm_silu": GN_PIXEL * 2 * RES64_VAL_BATCHES},
                "B": zero | {"fused_adam_ema": RES64_SIZE // 64}}


def check_resolution(tag: str) -> dict:
    """Phase 7l: the resolution axis through the four probes' functions at
    the flagship width, bf16, seed 0: probe 43's sweep at 128 px and its
    recompute against the plain step, probe 39 at 64 px (reduced), probe 39b
    on its run directory, probe 41 at 32, 64 and 128 px over two gloo
    processes on cuda:0."""
    out = {}
    t0 = time.perf_counter()
    cfg = p43.probe_config()  # each attempt runs in a temporary directory of its own
    zero_counts()
    sweep = p43.sweep(cfg, DEV, tag=tag)
    counts = read_counts()
    rows = sweep["attempts"]
    if sweep["n_params"] != N_PARAMS:
        raise AssertionError(f"the 128px UNet has {sweep['n_params']} parameters")
    fit = {r["batch"] for r in rows if r.get("fits") and not r["remat"]}
    if not {8, 16, 32, 64} <= fit:
        raise AssertionError(f"probe 43: only B in {sorted(fit)} fit without the recompute")
    for r in rows:
        want = FWD_BWD_ADAM | ({"linear_attention_fwd": 16} if r["remat"] else {})
        if r.get("fits") and (r["launches_per_step"] != want or not np.isfinite(r["loss"])
                              or not np.isfinite(r["loss_last"])):
            raise AssertionError(f"probe 43 B={r['batch']} remat={r['remat']}: {r}")
    print(f"probe 43 sweep launches, the counts set to 0 before it: {counts} [{tag}]")
    remat = p43.compare_remat(cfg, 8, DEV)
    print(f"probe 43 recompute vs plain, 128px B=8 bf16, {remat['steps']} steps from the "
          f"same weights and draws (cuDNN deterministic), the last replayed "
          f"(graphed {remat['graphed']} / {remat['graphed_remat']}): losses "
          f"{remat['losses']} vs {remat['losses_remat']}, max |loss diff| "
          f"{remat['loss_abs']:.3e}; worst grad max|diff| / max|grad| {remat['grad_rel']:.3e} "
          f"({remat['worst_leaf']}; bar {UNET_FP32_TOL:g}); bit for bit: {remat['bitwise']}; "
          f"launches a step {remat['launches']} vs {remat['launches_remat']} [{tag}]")
    if (remat["grad_rel"] > UNET_FP32_TOL
            or remat["loss_abs"] > UNET_FP32_TOL * abs(remat["losses"][-1])
            or remat["launches"] != FWD_BWD_ADAM
            or remat["launches_remat"] != FWD_BWD_ADAM | {"linear_attention_fwd": 16}):
        raise AssertionError(f"probe 43: the recompute left the plain step: {remat}")
    out["probe43"] = {**sweep, "remat_vs_plain_b8": remat, "launches": counts}
    print(f"phase 7l probe 43 wall time {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    base = load_config(RES64)
    with tempfile.TemporaryDirectory() as workdir, p43.deterministic():
        cfg = dataclasses.replace(base, workdir=workdir,
                                  data=dataclasses.replace(base.data, synthetic_size=RES64_SIZE))
        zero_counts()
        a = p39.run(cfg, epochs=1, n_fid=RES64_N_FID, clf_epochs=1, device=DEV, tag=tag)
        counts_a = read_counts()
        batches = RES64_N_FID // p39.B
        want = res64_launches(a["train"]["steps"], batches, warm=False)
        print(f"probe 39 (64px, {RES64_SIZE} images, 1 + 1 epochs, n_fid {RES64_N_FID}): "
              f"{a['train']['steps']} train steps, launches by phase {a['launches']} (the counts "
              f"set to 0 before it: {counts_a}); FIDs pixel / classifier: "
              + "; ".join(f"{k} {a[k]['fid_pixel']:.4f} / {a[k]['fid_classifier']:.4f}, "
                          f"{a[k]['img_per_sec']:.2f} img/s" for k in ("ddpm400", "ddim50"))
              + f" [{tag}]")
        if a["train"]["steps"] != (RES64_SIZE - RES64_VAL_BATCHES * 64) // 64:
            raise AssertionError(f"probe 39 took {a['train']['steps']} train steps")
        if a["launches"] != want:
            raise AssertionError(f"probe 39 launches {a['launches']}, want {want}")
        if not all(np.isfinite(a[k][m]) for k in ("ddpm400", "ddim50")
                   for m in ("fid_pixel", "fid_classifier", "img_per_sec")):
            raise AssertionError("probe 39: a FID is not finite")
        zero_counts()
        b = p39b.run(cfg, n_fid=RES64_N_FID, clf_epochs=1, device=DEV, tag=tag)
        counts_b = read_counts()
        want = res64_launches(0, batches, warm=True)
        same = {k: bool(np.array_equal(a["images"][k], b["images"][k]))
                for k in ("ddpm400", "ddim50")}
        print(f"probe 39b on probe 39's run directory: train {b['train']} from metrics.jsonl; "
              f"Phase C images bit for bit probe 39's: {same}; launches {b['launches']} (the "
              f"counts set to 0 before it: {counts_b}) [{tag}]")
        if not all(same.values()) or b["launches"] != want:
            raise AssertionError(f"probe 39b: images equal {same}, launches {b['launches']}, "
                                 f"want {want}")
        if b["train"]["steps"] != a["train"]["steps"]:
            raise AssertionError(f"probe 39b read {b['train']['steps']} steps from the metrics")
        out["probe39"], out["probe39b"] = p39.json_rows(a), p39.json_rows(b)
        out["probe39b"]["images_equal"] = same
        del a, b
    torch.cuda.empty_cache()
    print(f"phase 7l probes 39 / 39b wall time {time.perf_counter() - t1:.1f} s")

    t2 = time.perf_counter()
    zero_counts()
    sp = p41.run(RES_SP_SIZES, DEV, check=RES_SP_CHECK, tag=tag)
    for size in RES_SP_SIZES:
        row = sp[f"{size}px"]
        for name, m, _ in p41.ROWS:
            want = dict.fromkeys(launch_counts(), 0) | (
                {"linear_attention_fwd": 8, "linear_attention_bwd": 8} if m == 1 else {})
            if row[name]["launches_per_step"] != want:
                raise AssertionError(f"probe 41 {size}px {name}: {row[name]}")
    for size, c in sp["grad_check"].items():
        if not c["ok"]:
            raise AssertionError(f"probe 41 {size}: the dp and sp gradients disagree: {c}")
    out["probe41"] = sp
    print(f"phase 7l probe 41 wall time {time.perf_counter() - t2:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- phase 12
# the bench's readings against phases 6-7 of the same run
BENCH_TOL = 0.10
BENCH_BUDGET_S = 60


# phase 7k: the optimizer's one pass (ops/fused_adam_ema.py) at the flagship width
ADAM_STEPS = 3
# kernel vs plain: both round at the same points (the kernel contracts no
# FMA), so an ulp or two at most
ADAM_TOL = 1e-6
PEAK_FP32 = 67e12  # the H100's fp32 rate outside the tensor cores (SXM, 700 W)
# bytes an element: p, g, m, v, e read and p, m, v, e written (fp32); no EMA:
# 28; fp32 operations an element: m 3, v 4, p 6, the EMA 3
ADAM_BYTES, ADAM_BYTES_NO_EMA = 36, 28
ADAM_FLOPS, ADAM_FLOPS_NO_EMA = 16, 13


@dataclasses.dataclass
class AdamStreams:
    """A train state's leaves as the pass takes them."""

    p: list
    m: list
    v: list
    e: list
    count: list
    step_t: torch.Tensor

    @classmethod
    def of(cls, state) -> "AdamStreams":
        adam = state._adam_state()
        return cls([p.detach() for p in state.params()], [st["exp_avg"] for st in adam],
                   [st["exp_avg_sq"] for st in adam], [e.detach() for e in state.ema.parameters()],
                   [st["step"] for st in adam], state.step_t)

    def clone(self) -> "AdamStreams":
        return AdamStreams(*([t.clone() for t in ts] for ts in (self.p, self.m, self.v, self.e,
                                                                 self.count)),
                           self.step_t.clone())

    def step(self, fn, grads: list, ema: bool, decay: float, lr: float) -> None:
        """One update by ``fn`` (the wrapper or the plain version), then the
        counts += 1, as ``TrainState.update`` does."""
        d = ema_decay_tensor(decay, self.step_t)
        fn(self.p, grads, self.m, self.v, self.e if ema else None, self.count, d,
           lr, 0.9, 0.999, 1e-8)
        torch._foreach_add_(self.count, 1.0)
        self.step_t += 1

    def max_abs_err(self, other: "AdamStreams", ema: bool) -> dict:
        names = ("p", "m", "v") + (("e",) if ema else ())
        return {k: max(float((a - b).abs().max()) for a, b in zip(getattr(self, k),
                                                                     getattr(other, k)))
                for k in names}

    def equal(self, other: "AdamStreams") -> bool:
        return all(torch.equal(a, b) for k in ("p", "m", "v", "e", "count")
                   for a, b in zip(getattr(self, k), getattr(other, k))) and torch.equal(
            self.step_t, other.step_t)


def foreach_update(state) -> None:
    """The train state's update before the one pass (the yardstick): torch's
    capturable foreach Adam, then the EMA with one ``addcmul_`` a leaf."""
    with torch.no_grad():
        state.optimizer.step()
        d = ema_decay_tensor(state.ema_decay, state.step_t)
        ema = list(state.ema.parameters())
        torch._foreach_mul_(ema, d)
        rest = 1.0 - d
        for e, p in zip(ema, state.params()):
            e.addcmul_(p, rest)
        state.step_t += 1


def adam_trainer(cfg, graphs) -> DiffusionTrainer:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, DEV)
    return DiffusionTrainer(cfg, model, build_diffusion(cfg, DEV), None, None,
                            list(range(10)), device=DEV, graphs=graphs)


def adam_batches(n: int, seed: int) -> list:
    """``n`` batches at B=64 with their injected draws (t, eps, drop)."""
    g = torch.Generator().manual_seed(seed)
    return [({"image": torch.rand(TRAIN_B, 32, 32, 3, generator=g) * 2 - 1,
              "label": torch.randint(0, 10, (TRAIN_B,), generator=g)},
             {"t": torch.randint(0, T_STEPS, (TRAIN_B,), generator=g),
              "eps": torch.randn(TRAIN_B, 32, 32, 3, generator=g),
              "drop": torch.tensor(i % 3 == 0)}) for i in range(n)]


def adam_bound(n: int, ema: bool) -> dict:
    nbytes = n * (ADAM_BYTES if ema else ADAM_BYTES_NO_EMA)
    flops = n * (ADAM_FLOPS if ema else ADAM_FLOPS_NO_EMA)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bound_bytes": nbytes, "bound_flops": flops}


def check_fused_edges(tag: str) -> None:
    """Phase 7k: the kernel's edges against its plain version: more leaves
    than one launch takes (the table in groups), leaves of 1 to 9,000
    elements (scalar tails), every third one at an address 4 bytes off 16
    (the scalar path), every fifth one without a gradient, with and without
    the EMA; bit for bit and launches as the groups give them."""
    per_launch = fa.LIB.ldm_fused_adam_ema_leaves()
    n_leaves = per_launch + 52
    g = torch.Generator(device=DEV).manual_seed(44)
    sizes = torch.randint(1, 9000, (n_leaves,), generator=torch.Generator().manual_seed(45))
    sizes[:3] = torch.tensor([1, 3, 4097])

    def stream(positive=False):
        out = []
        for i, k in enumerate(sizes.tolist()):
            off = 1 if i % 3 == 0 else 0
            t = torch.randn(k + off, generator=g, device=DEV)[off:]
            out.append(t.abs() * 1e-4 if positive else t)
        return out

    for ema in (True, False):
        base = [stream(), stream(), stream(), stream(positive=True), stream()]
        base[1] = [None if i % 5 == 0 else t for i, t in enumerate(base[1])]
        count = [torch.full((), float(i % 7), device=DEV) for i in range(n_leaves)]
        d = torch.full((), 0.7, device=DEV)
        runs = []
        for fn in (fa.fused_adam_ema, fa.fused_adam_ema_torch):
            p, grads, m, v, e = ([None if t is None else t.clone() for t in ts] for ts in base)
            before = registry.read(fa.LIB.name)
            fn(p, grads, m, v, e if ema else None, count, d, 1e-3, 0.9, 0.999, 1e-8)
            runs.append((p, m, v, e, registry.read(fa.LIB.name) - before))
        torch.cuda.synchronize()
        (kp, km, kv, ke, launches), (pp, pm, pv, pe, _) = runs
        same = all(torch.equal(a, b) for xs, ys in ((kp, pp), (km, pm), (kv, pv), (ke, pe))
                   for a, b in zip(xs, ys))
        # the table holds the leaves with a gradient or an EMA
        listed = n_leaves if ema else sum(t is not None for t in base[1])
        want = -(-listed // per_launch)
        print(f"fused Adam{' + EMA' if ema else ''} edges: {n_leaves} leaves of 1-9,000 "
              f"elements ({per_launch} a launch), a third 4 bytes off 16-byte alignment, a fifth "
              f"without a gradient, {listed} in the table: {launches} launches (want {want}); "
              f"kernel == plain bit for bit {same} [{tag}]")
        if launches != want or not same:
            raise AssertionError(f"fused Adam edges: {launches} launches, equal {same}")


def check_fused_update(config, tag: str, train_device_ms: float) -> dict:
    """Phase 7k: the kernel against its plain version over chained steps from
    real train-step gradients, a replayed train step against the eager one,
    and the times (see the module's docstring)."""
    out = {}
    decay = config.ema_decay
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        check_fused_edges(tag)
        with tempfile.TemporaryDirectory() as workdir:
            cfg = dataclasses.replace(config, workdir=workdir)
            # (a) real gradients: a step, the state taken, then ADAM_STEPS steps
            # whose gradients are kept (the trainer's own updates: the kernel)
            tr = adam_trainer(cfg, False)
            batches = adam_batches(1 + ADAM_STEPS, 41)
            tr.train_step(batches[0][0], **batches[0][1])
            start = AdamStreams.of(tr.state).clone()
            grads = []
            for b, draws in batches[1:]:
                tr.train_step(b, **draws)
                grads.append([p.grad.clone() for p in tr.state.params()])
            n = sum(t.numel() for t in start.p)
            if n != N_PARAMS or len(start.p) != 200:
                raise AssertionError(f"{len(start.p)} leaves of {n} parameters")
            trained = AdamStreams.of(tr.state).clone()
            del tr
            errs = {}
            for ema in (True, False):
                runs = {}
                for how, fn in (("kernel", fa.fused_adam_ema), ("rerun", fa.fused_adam_ema),
                                ("plain", fa.fused_adam_ema_torch)):
                    runs[how] = start.clone()
                    for g in grads:
                        runs[how].step(fn, g, ema, decay, cfg.lr)
                torch.cuda.synchronize()
                errs[ema] = runs["kernel"].max_abs_err(runs["plain"], ema)
                rerun = runs["kernel"].equal(runs["rerun"])
                mine = ema and runs["kernel"].equal(trained)
                print(f"fused Adam{' + EMA' if ema else ''} kernel vs plain, {ADAM_STEPS} chained "
                      f"steps from B={TRAIN_B} train-step gradients, 200 leaves, {n:,} parameters: "
                      f"max_abs_err {errs[ema]} (limit {ADAM_TOL}); rerun bit-identical {rerun}"
                      + (f"; the trainer's own {ADAM_STEPS} updates bit-identical {mine}"
                         if ema else "") + f" [{tag}]")
                if max(errs[ema].values()) > ADAM_TOL or not rerun or (ema and not mine):
                    raise AssertionError(f"fused Adam + EMA: {errs[ema]}, rerun {rerun}, "
                                         f"trainer {mine}")
            out["max_abs_err"] = max(max(e.values()) for e in errs.values())
            out["max_abs_err_by_stream"] = {("ema" if k else "no_ema"): v for k, v in errs.items()}

            # (b) a replayed train step against the eager one: the same state,
            # batches and draws; WARMUP_STEPS eager steps, then ADAM_STEPS replays
            steps = adam_batches(WARMUP_STEPS + ADAM_STEPS, 42)
            runs = {}
            for graphs in (True, False):
                t = adam_trainer(cfg, graphs)
                losses = [t.train_step(b, **draws)["loss"].item() for b, draws in steps]
                runs[graphs] = (t, losses)
            (tg, lg), (te, le) = runs[True], runs[False]
            same = AdamStreams.of(tg.state).equal(AdamStreams.of(te.state))
            print(f"replayed vs eager train step, B={TRAIN_B} bf16, cuDNN deterministic, "
                  f"{WARMUP_STEPS} eager + {ADAM_STEPS} replayed steps {tg.step_counts}: losses "
                  f"{lg} / {le}; p, m, v, ema, Adam's counts and the step counter bit-identical "
                  f"{same}")
            if tg.step_counts != {"graphed": ADAM_STEPS, "eager": WARMUP_STEPS} or not same:
                raise AssertionError(f"a replayed train step left the eager one: {lg} vs {le}")
            del runs, te, t

            # (c) the times: the kernel, the plain version and two PyTorch
            # yardsticks on the same tensors, each by CUDA-graph replay
            live, g0 = start.clone(), grads[0]
            d = ema_decay_tensor(decay, live.step_t)

            def kernel(ema: bool):
                return lambda: fa.fused_adam_ema(live.p, g0, live.m, live.v,
                                                 live.e if ema else None, live.count, d,
                                                 cfg.lr, 0.9, 0.999, 1e-8)

            out["ms"] = cuda_graph_ms(kernel(True))
            out["ms_no_ema"] = cuda_graph_ms(kernel(False))
            out["plain_ms"] = cuda_graph_ms(
                lambda: fa.fused_adam_ema_torch(live.p, g0, live.m, live.v, live.e, live.count, d,
                                                cfg.lr, 0.9, 0.999, 1e-8), iters=5)
            params = [torch.nn.Parameter(t.clone()) for t in start.p]
            for p, g in zip(params, g0):
                p.grad = g.clone()
            ema = [t.clone() for t in start.e]

            def adam(**kind):
                opt = torch.optim.Adam(params, lr=cfg.lr, capturable=True, **kind)
                for p, m, v, c in zip(params, live.m, live.v, live.count):
                    opt.state[p] = {"step": c.clone(), "exp_avg": m.clone(),
                                    "exp_avg_sq": v.clone()}
                return opt

            foreach, fused = adam(foreach=True), adam(fused=True)
            rest = 1.0 - d

            def foreach_step():
                foreach.step()
                torch._foreach_mul_(ema, d)
                for e, p in zip(ema, params):
                    e.addcmul_(p.detach(), rest)

            weight = 1.0 - float(d)  # a host number: frozen in the graph, as a yardstick may

            def fused_step():
                fused.step()
                torch._foreach_lerp_(ema, [p.detach() for p in params], weight)

            with torch.no_grad():
                out["foreach_ms"] = cuda_graph_ms(foreach_step)
                out["fused_lerp_ms"] = cuda_graph_ms(fused_step)
            out |= adam_bound(n, True)
            out["bound_ms_no_ema"] = adam_bound(n, False)["bound_ms"]
            del params, ema, foreach, fused, live

            # (d) the train step's device ms a replay, this pass (b's graphed
            # trainer) against the update it replaced, in turns (A B B A)
            pair = {"fused": tg, "foreach": adam_trainer(cfg, True)}
            pair["foreach"].state.update = types.MethodType(foreach_update,
                                                            pair["foreach"].state)
            for b, draws in steps:
                pair["foreach"].train_step(b, **draws)
            order = ["fused", "foreach", "foreach", "fused"]
            readings = {k: [] for k in pair}
            for k in order:
                readings[k].append(pair[k].train_graph.device_ms(10))
            step_ms = {k: float(np.mean(v)) for k, v in readings.items()}
            del pair, tg
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    torch.cuda.empty_cache()
    out["train_step_device_ms"] = step_ms
    out["train_step_device_ms_runs"] = readings
    out["train_step_device_ms_phase7"] = train_device_ms
    print(f"fused Adam + EMA at {n:,} parameters, 200 leaves (device ms by CUDA-graph replay): "
          f"kernel {out['ms']:.4f} (no EMA {out['ms_no_ema']:.4f}), bound {out['bound_ms']:.4f} "
          f"(36 B a parameter at 3.35 TB/s; no EMA {out['bound_ms_no_ema']:.4f}, 28 B), kernel / "
          f"bound {out['ms'] / out['bound_ms']:.2f}; plain version {out['plain_ms']:.4f}; "
          f"yardsticks on the same tensors: foreach Adam + a per-leaf EMA (the update before "
          f"this pass) {out['foreach_ms']:.4f}, torch.optim.Adam(fused=True) + "
          f"_foreach_lerp_ {out['fused_lerp_ms']:.4f} [{tag}]")
    print(f"train step B={TRAIN_B} bf16, device ms a replay, in turns {order}: this pass "
          f"{step_ms['fused']:.4f} (runs {readings['fused']}), the foreach update "
          f"{step_ms['foreach']:.4f} (runs {readings['foreach']}); phase 7's replay "
          f"{train_device_ms:.4f} [{tag}]")
    return out


def check_bench(config, sampler_device_ms: float, train_graphed_ms: float, tag: str) -> dict:
    """Phase 12: ``bench.main(["--quick"])`` in this process on cuda:0 (it
    prints its line), held against phase 6's device ms a B=64 sampler replay
    and phase 7's graphed host ms a train step, its MFU against the FLOP
    count made again here, its kernel launches exactly, within its budget."""
    t0 = time.perf_counter()
    res = bench.main(["--quick"])
    seconds = time.perf_counter() - t0
    line = res.line
    if "errors" in line:
        raise AssertionError(f"the bench's line has errors: {line['errors']}")
    want_value = 64 / (bench.T * sampler_device_ms * 1e-3)
    want_train = 1e3 / train_graphed_ms
    count = flops.sampler_flops_per_img_step(build_model(config))
    want_mfu = count * bench.T * line["value"] / flops.H100_SXM_BF16_PEAK_FLOPS
    zero = dict.fromkeys(launch_counts(), 0.0)
    want_launches = {"sampler_b64": zero | {"linear_attention_fwd": 8.0 * bench.T,
                                            "group_norm_silu": float(GN_PIXEL * bench.T)},
                     "train_step": zero | {"linear_attention_fwd": 8.0,
                                           "linear_attention_bwd": 8.0,
                                           "fused_adam_ema": 1.0}}
    out = {"seconds": seconds, "value": line["value"], "value_want": want_value,
           "train_steps_per_sec": line["train_steps_per_sec"], "train_want": want_train,
           "mfu": line["mfu"], "mfu_want": want_mfu, "train_mfu": line["train_mfu"],
           "flops_per_img_step": count, "launches": res.launches}
    print(f"bench --quick: {line['value']:.4f} img/s (phase 6: {want_value:.4f}), "
          f"{line['train_steps_per_sec']:.4f} train steps/s (phase 7: {want_train:.4f}), mfu "
          f"{line['mfu']:.6f} (count {count / 1e9:.6f} GFLOP an image a step: "
          f"{want_mfu:.6f}), train_mfu {line['train_mfu']:.6f}; launches a timed sampler run / "
          f"train step {res.launches}; {seconds:.1f} s (budget {BENCH_BUDGET_S} s) [{tag}]")
    if abs(line["value"] / want_value - 1) > BENCH_TOL:
        raise AssertionError(f"bench value {line['value']} vs phase 6's {want_value}")
    if abs(line["train_steps_per_sec"] / want_train - 1) > BENCH_TOL:
        raise AssertionError(f"bench train {line['train_steps_per_sec']} vs phase 7's "
                             f"{want_train}")
    if abs(line["mfu"] / want_mfu - 1) > 1e-6 or not (0 < line["mfu"] < 1
                                                      and 0 < line["train_mfu"] < 1):
        raise AssertionError(f"bench mfu {line['mfu']} (want {want_mfu}), train_mfu "
                             f"{line['train_mfu']}")
    if res.launches != want_launches:
        raise AssertionError(f"bench launches {res.launches}, want {want_launches}")
    if seconds > BENCH_BUDGET_S:
        raise AssertionError(f"phase 12 took {seconds:.1f} s, over {BENCH_BUDGET_S} s")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another commit's tree, unpacked: its linear-attention "
                    "and ResNet-block kernels are timed in turns with this tree's")
    ap.add_argument("--mesh-worker", nargs=3, metavar=("RANK", "PORT", "OUTDIR"),
                    help=argparse.SUPPRESS)  # one of phase 7f's gloo processes
    ap.add_argument("--axis-worker", nargs=3, metavar=("RANK", "PORT", "OUTDIR"),
                    help=argparse.SUPPRESS)  # one of phase 7h's gloo processes
    ap.add_argument("--pp-worker", nargs=3, metavar=("RANK", "PORT", "OUTDIR"),
                    help=argparse.SUPPRESS)  # one of phase 7i's gloo processes
    a = ap.parse_args(argv)
    if a.mesh_worker:
        rank, port, outdir = a.mesh_worker
        return mesh_worker(int(rank), int(port), outdir)
    if a.axis_worker:
        rank, port, outdir = a.axis_worker
        return axis_worker(int(rank), int(port), outdir)
    if a.pp_worker:
        rank, port, outdir = a.pp_worker
        return pp_worker(int(rank), int(port), outdir)
    t_script = time.perf_counter()
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    tag = card()
    print(f"card: {tag}; {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    built = build.build()
    print_build(built)
    print(f"build wall time {time.perf_counter() - t0:.1f} s (the production sources compiled "
          f"in parallel)")
    check_sass(built)

    phase("3 forward kernel vs plain")
    kernel = check_kernel(tag)

    phase("3b the GroupNorm (+ SiLU) pass vs plain at every norm site of the pixel UNet, the "
          "latent UNet and the VAE")
    gnorm = check_group_norm(tag)
    gnorm_sd = check_group_norm_sd(tag)

    phase("4 backward kernels vs plain")
    bwd = check_bwd_kernel(tag)

    phase("5 full-width UNet")
    config = load_config(FLAGSHIP)
    check_unet(config)
    check_unet_grads(config)
    check_unet_64px(config)

    phase("6 the sampling slice: generate.main as replayed graphs, CFG 3, B=10, bf16")
    if config.diffusion.n_steps != T_STEPS or not config.use_amp:
        raise AssertionError("flagship config is not T=400 with use_amp")
    requests = check_requests(config, tag)
    sample_counts = requests["ddpm"]["counts"]
    launches = sample_counts["linear_attention_fwd"]
    check_smoke_config(tag)
    check_trajectory(config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(config, DEV).eval()
    paths = {"sampler_b64": check_sampler_speed(model, 64, tag),
             "request_b10": check_sampler_speed(model, 10, tag)}
    sampler_persistent = check_sampler_persistent(model, SAMPLE_B, tag)
    for name in ("sampler_b64", "request_b10"):
        b = 64 if name == "sampler_b64" else 10
        print(f"{name}: {b / (paths[name]['graphed_ms'] * 1e-3 * T_STEPS):.3f} img/s at T=400 "
              f"from the graphed median [{tag}]")
    del model

    phase("7 the training slice: train.run as a replayed graph, 3 epochs, B=64, bf16")
    training = check_training(config, tag)
    paths["train_b64"] = training["path"]
    check_graphed_training(config)
    epoch_check = check_epoch_paths(config)

    phase("7b the serving slice: build_generation_service, B=64, CFG 3, bf16, DDIM-50 and "
          "DPM-Solver++-15")
    serving = check_serving(config, tag)

    phase("7c the protocol slice: ldm_tpu_torch.main for the pixel DDPM and the rectified "
          "flow, full width, bf16, CFG 3, --negative-control")
    t_protocol = time.perf_counter()
    protocol = check_protocol(tag)
    print(f"phase 7c wall time {time.perf_counter() - t_protocol:.1f} s")

    # the entry points below set cuDNN's deterministic algorithms, as the
    # port's do; the flags are put back after each phase
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    phase("7d consistency distillation at the flagship width: distill.main, generate "
          "--sampler consistency, the consistency service, bf16")
    t_phase = time.perf_counter()
    try:
        consistency = check_consistency(tag)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"phase 7d wall time {time.perf_counter() - t_phase:.1f} s")
    paths["distill_b64"] = consistency["path"]

    phase("7e the latent family at full width: train_autoencoder, train_latent, the latent "
          "sampler and service, main --generator-config, bf16")
    t_phase = time.perf_counter()
    keep = tempfile.TemporaryDirectory()  # the VAE 7e trains, for 7g's bridge
    try:
        latent = check_latent(tag, keep.name)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"phase 7e wall time {time.perf_counter() - t_phase:.1f} s")
    paths["latent_train_b64"] = latent["train_path"]
    paths["latent_sampler_b64"] = latent["sampler_path"]

    phase("7f data parallelism and FSDP: world size 1 over NCCL, two gloo processes, mesh "
          "serving, train --mesh")
    t_phase = time.perf_counter()
    mesh = check_mesh(config, tag)
    print(f"phase 7f wall time {time.perf_counter() - t_phase:.1f} s")
    paths["train_b64_dp"] = mesh["world1"]["dp"]
    paths["train_b64_fsdp"] = mesh["world1"]["fsdp"]

    phase("7g the reference's workflow at the flagship width: train --profile, generate into "
          "the PNG tree, train_classifier --pretrain-dir, the checkpoint bridge both ways")
    try:
        workflow = check_workflow(tag, os.path.join(keep.name, "autoencoder.pt"))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        keep.cleanup()

    phase("7h the mesh's model axis at the flagship width: tp, fsdp_tp and spatial over two "
          "gloo processes as (data=1, model=2), their DDIM-50 requests, tp at model = 1 over "
          "NCCL")
    axis = check_model_axis(config, tag, mesh["gloo"]["step_ms_median"])
    axis_launches = {f"train_{mode}_model2_rank0": axis["gloo"][mode]["rank0"]["launches"]
                     for mode in AXIS_MODES}

    phase("7i pipeline parallelism at the flagship width: encode / decode and the payload, "
          "two gloo processes as a (data=1, model=2) pipeline, training and DDIM-50")
    pipeline = check_pipeline(config, tag, mesh["gloo"]["step_ms_median"],
                              axis["gloo"]["tp"]["step_ms_median"])
    pp_gloo = pipeline["gloo"]
    # the pipeline's launches by path (a process's whole run) and a step
    pp_runs = {f"train_pp_m{m}_rank{r}": pp_gloo[m][f"rank{r}"]["launches"]
               for m in (PP_M, PP_M_ALSO) for r in range(2)}
    pp_runs |= {f"sample_pp_ddim50_b10_rank{r}": pp_gloo[f"sample_rank{r}"]["launches"]
                for r in range(2)}
    pp_runs["pp_staged_pass_2b128"] = pipeline["payload"]["launches"]

    def pp_per_step(name: str) -> dict:
        return {"train_pp_per_rank": pp_gloo[PP_M]["rank0"]["launches_per_step"][name],
                "train_pp_m4_per_rank": pp_gloo[PP_M_ALSO]["rank0"]["launches_per_step"][name],
                "sample_pp_per_rank":
                    pp_gloo["sample_rank0"]["launches"][name] // PP_SAMPLE_STEPS}

    phase("7j the real-data drill: ldm_tpu_torch.main on the MNIST flagship at full width from "
          "raw IDX files, --strict-data --wandb, DDIM-50, bf16")
    try:
        drill = check_drill(tag)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    phase("7k the optimizer's one pass at the flagship width: the fused Adam + EMA kernel vs "
          "plain over chained steps, a replayed train step vs the eager one, the times")
    t_phase = time.perf_counter()
    fused = check_fused_update(config, tag, paths["train_b64"]["device_ms"])
    print(f"phase 7k wall time {time.perf_counter() - t_phase:.1f} s")

    phase("7l the resolution axis at the flagship width, bf16: probe 43's 128px train step "
          "swept over B and its recompute, probes 39 / 39b at 64px, probe 41's DP against SP at "
          "32, 64 and 128 px")
    resolution = check_resolution(tag)
    print(f"phase 7l wall time {resolution['seconds']:.1f} s")
    res43, res39 = resolution["probe43"], resolution["probe39"]

    def res_launches(name: str) -> dict:
        """The resolution axis's launches of kernel ``name`` by path."""
        return {"probe43_128px_sweep": res43["launches"][name],
                **{f"probe39_64px_{k}": v[name] for k, v in res39["launches"].items()},
                **{f"probe39b_64px_{k}": v[name]
                   for k, v in resolution["probe39b"]["launches"].items()}}

    def res_per_step(name: str) -> dict:
        rows = {f"train_128px_b{r['batch']}{'_remat' if r['remat'] else ''}":
                r["launches_per_step"][name] for r in res43["attempts"] if r.get("fits")}
        return rows | {f"probe41_{size}_dp2_b2_per_rank":
                       resolution["probe41"][size]["dp2_B2"]["launches_per_step"].get(name, 0)
                       for size in (f"{v}px" for v in RES_SP_SIZES)}

    phase("8 the ResNet-block kernel vs plain, and ResNetBlockFn")
    t_rb = time.perf_counter()
    resnet = check_resnet_block(tag)
    fn_launches = check_resnet_block_fn()

    phase("9 the probes: probe13, probe13b, probe7")
    probes = check_probes()
    print(f"phases 8-9 wall time {time.perf_counter() - t_rb:.1f} s")
    rows13b, launches13b = probes["probe13b"]
    rows7, launches7 = probes["probe7"]

    phase("10 this tree's kernels and another commit's, in turns")
    if a.parent:
        compare_parent.main(["--parent", a.parent])
    else:
        print("skipped: no --parent DIR given (python -m ldm_tpu_torch.perf.compare_parent "
              "--parent DIR runs it alone)")

    phase("11 result")

    def times(res: dict) -> dict:
        return {"ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "bound_bytes": res["bound_bytes"],
                "bound_flops": res["bound_flops"],
                "bound_peaks": "3.35 TB/s, 989 TFLOP/s bf16 (H100 SXM at 700 W)",
                "library_ms": None, "library": "no single PyTorch call computes the block"}

    def per_step(name: str) -> dict:
        """Launches a sampler step and a train step, from the counts read
        around the T-step request and around the one counted train step."""
        steps = T_STEPS + WARMUP_STEPS  # replayed, and eager before the capture
        if sample_counts[name] % steps:
            raise AssertionError(f"{name}: {sample_counts[name]} launches in {steps} steps")
        return {"sampler": sample_counts[name] // steps, "train": training["per_step"][name]}

    train_counts = training["run_counts"]
    probe_full = rb_bound(probe13.B, 32, 64, 64)
    stage6 = la_bound(probe7.B, probe7.N, probe7.C, backward=False)
    print(json.dumps({"kernels": [{
        "name": "linear_attention_fwd",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/linear_attention_fwd.cu",
        "replaces": "ldm_tpu/ops/linear_attention.py:220",
        "also_replaces": "ldm_tpu/ops/linear_attention.py:333",
        "launches": launches,
        "launches_by_path": {"sample": launches, "train": train_counts["linear_attention_fwd"],
                             "sample_ddim": requests["ddim"]["counts"]["linear_attention_fwd"],
                             "sample_dpmpp": requests["dpmpp"]["counts"]["linear_attention_fwd"],
                             "serve_ddim": serving["ddim"]["launches"],
                             "serve_dpmpp": serving["dpmpp"]["launches"],
                             "protocol_pixel": protocol["pixel"]["counts"]["linear_attention_fwd"],
                             "protocol_flow": protocol["flow"]["counts"]["linear_attention_fwd"],
                             "distill": consistency["run_counts"]["linear_attention_fwd"],
                             **{f"sample_consistency_{k}": v["launches"]
                                for k, v in consistency["requests"].items()},
                             "serve_consistency_2": consistency["serving"]["launches"],
                             "train_latent": latent["train_counts"]["linear_attention_fwd"],
                             "sample_latent": latent["sample_counts"]["graphed"],
                             "serve_latent_ddim": latent["serving"]["launches"],
                             "protocol_latent":
                                 latent["protocol"]["counts"]["linear_attention_fwd"],
                             "train_mesh_cli": mesh["cli"]["launches"]["linear_attention_fwd"],
                             "serve_mesh_ddim": mesh["serving"]["mesh"]["launches"],
                             "train_gloo_rank0":
                                 mesh["gloo"]["rank0"]["launches"]["linear_attention_fwd"],
                             "workflow_train_profiled":
                                 workflow["train"]["launches"]["linear_attention_fwd"],
                             "workflow_generate_ddim50_b320": workflow["generate"]["launches"],
                             **{k: v["linear_attention_fwd"] for k, v in axis_launches.items()},
                             **{k: v["linear_attention_fwd"] for k, v in pp_runs.items()},
                             "drill_mnist": drill["counts"]["linear_attention_fwd"],
                             **res_launches("linear_attention_fwd")},
        "launches_per_step": {**per_step("linear_attention_fwd"),
                              "train_dp_per_rank":
                                  mesh["world1"]["launches"]["dp"]["linear_attention_fwd"],
                              "train_fsdp_per_rank":
                                  mesh["world1"]["launches"]["fsdp"]["linear_attention_fwd"],
                              "train_tp_model1_per_rank": axis["world1"]["launches"][
                                  "tp_model1"]["linear_attention_fwd"],
                              "train_model2_per_rank": max(
                                  v["linear_attention_fwd"] for v in axis_launches.values()) // AXIS_STEPS,
                              "distill": consistency["per_step"]["linear_attention_fwd"],
                              "consistency_sample": consistency["sample_per_step"],
                              "latent_train": latent["train_per_step"]["linear_attention_fwd"],
                              "latent_sample": latent["sample_per_step"],
                              **pp_per_step("linear_attention_fwd"),
                              **res_per_step("linear_attention_fwd")},
        "max_abs_err": kernel["max_abs_err"],
        "max_abs_err_fp32": kernel["max_abs_err_fp32"],
        **times(kernel),
        "timed": "sum over the 8 sites, one launch each, 2B=128, bf16; the kernel by "
                 "CUDA-graph replay, the plain version too",
        "site_128px": kernel["site_128px"],
    }, {
        "name": "linear_attention_bwd",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/linear_attention_bwd.cu",
        "replaces": "ldm_tpu/ops/linear_attention.py:476",
        "also_replaces": "ldm_tpu/ops/linear_attention.py:858",
        "launches": train_counts["linear_attention_bwd"],
        "launches_by_path": {"sample": sample_counts["linear_attention_bwd"],
                             "train": train_counts["linear_attention_bwd"],
                             "protocol_pixel": protocol["pixel"]["counts"]["linear_attention_bwd"],
                             "protocol_flow": protocol["flow"]["counts"]["linear_attention_bwd"],
                             "distill": consistency["run_counts"]["linear_attention_bwd"],
                             "train_latent": latent["train_counts"]["linear_attention_bwd"],
                             "protocol_latent":
                                 latent["protocol"]["counts"]["linear_attention_bwd"],
                             "train_mesh_cli": mesh["cli"]["launches"]["linear_attention_bwd"],
                             "train_gloo_rank0":
                                 mesh["gloo"]["rank0"]["launches"]["linear_attention_bwd"],
                             "workflow_train_profiled":
                                 workflow["train"]["launches"]["linear_attention_bwd"],
                             **{k: v["linear_attention_bwd"] for k, v in axis_launches.items()},
                             **{k: v["linear_attention_bwd"] for k, v in pp_runs.items()},
                             "drill_mnist": drill["counts"]["linear_attention_bwd"],
                             **res_launches("linear_attention_bwd")},
        "launches_per_step": {**per_step("linear_attention_bwd"),
                              "train_dp_per_rank":
                                  mesh["world1"]["launches"]["dp"]["linear_attention_bwd"],
                              "train_fsdp_per_rank":
                                  mesh["world1"]["launches"]["fsdp"]["linear_attention_bwd"],
                              "train_tp_model1_per_rank": axis["world1"]["launches"][
                                  "tp_model1"]["linear_attention_bwd"],
                              "train_model2_per_rank": max(
                                  v["linear_attention_bwd"] for v in axis_launches.values()) // AXIS_STEPS,
                              "distill": consistency["per_step"]["linear_attention_bwd"],
                              "latent_train": latent["train_per_step"]["linear_attention_bwd"],
                              **pp_per_step("linear_attention_bwd"),
                              **res_per_step("linear_attention_bwd")},
        "max_abs_err": bwd["max_rel_err"],
        "max_abs_err_fp32": bwd["max_rel_err_fp32"],
        "err_unit": "max_abs_err / max|plain| of the worst of the 8 grads",
        **times(bwd),
        "timed": "sum over the 8 sites, one backward (3 kernels) each, B=64, bf16; the "
                 "kernels by CUDA-graph replay, the plain version too; site_128px: (16384, "
                 "64) alone by batch, b2 a correctness-check size, b8 and b128 batches of "
                 "phase 7l's 128px step",
        "site_128px": bwd["site_128px"],
    }, {
        "name": "resnet_block_fwd",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/resnet_block_fwd.cu",
        "replaces": "ldm_tpu/ops/resnet_block.py:133",
        "launches": probes["probe13"][1],
        "launches_by_path": {"probe13": probes["probe13"][1], "resnet_block_fn": fn_launches,
                             "sample": sample_counts["resnet_block_fwd"],
                             "train": train_counts["resnet_block_fwd"]},
        "launches_per_step": per_step("resnet_block_fwd"),
        "max_abs_err": resnet["max_rel_err"],
        "max_abs_err_fp32": resnet["max_rel_err_fp32"],
        "err_unit": "max_abs_err / max|plain|",
        **times(resnet),
        "conv_library_ms": resnet["conv_library_ms"],
        "conv_library": "the block's products only (F.conv2d twice, and the 1x1 where C_in != "
                        "C_out; bf16, channels_last), no GroupNorm, SiLU, bias or shortcut "
                        "add; never called by the port",
        "ms_2b20": resnet["ms_2b20"],
        "plain_ms_2b20": resnet["plain_ms_2b20"],
        "conv_library_ms_2b20": resnet["conv_library_ms_2b20"],
        "timed": "sum over the 11 ResNet sites, one block (3 kernels) each, 2B=128, bf16 "
                 "(ms_2b20: 2B=20); kernel, plain version and conv_library_ms all by "
                 "CUDA-graph replay (device time, no host launch cost in it)",
    }, {
        "name": "resnet_block_probe",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/resnet_block_probe.cu",
        "replaces": "perf/probe13b.py:40",
        "launches": launches13b,
        "launches_per_step": per_step(probe13b.LIB.name),
        "max_abs_err": max(r["rel_err"] for r in rows13b),
        "err_unit": "max_abs_err / max|plain|, worst mode",
        **times({"ms": rows13b[-1]["ms"], "plain_ms": rows13b[-1]["plain_ms"], **probe_full}),
        "ms_by_mode": {r["mode"]: r["ms"] for r in rows13b},
        "timed": "mode full, (1024, 64->64), 2B=256, bf16; kernel and plain version both by "
                 "CUDA-graph replay",
    }, {
        "name": "linear_attention_fwd_stage",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/linear_attention_fwd_probe.cu",
        "replaces": "perf/probe7.py:30",
        "launches": launches7,
        "launches_per_step": per_step(probe7.LIB.name),
        "max_abs_err": max(r["max_abs_err"] for r in rows7),
        **times({"ms": rows7[-1]["ms"], "plain_ms": rows7[-1]["plain_ms"], **stage6}),
        "ms_by_stage": {r["stage"]: r["ms"] for r in rows7},
        "timed": "stage 6 (the whole block), (1024, 64), 2B=128, bf16; kernel and plain "
                 "version both by CUDA-graph replay",
    }, {
        "name": "group_norm_silu",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/group_norm_silu.cu",
        "replaces": None,
        "replaces_kind": "no pl.pallas_call: the JAX package leaves GroupNorm and SiLU to XLA",
        "launches": sample_counts["group_norm_silu"],
        "launches_by_path": {"sample": sample_counts["group_norm_silu"],
                             "train": train_counts["group_norm_silu"],
                             "sample_ddim": requests["ddim"]["counts"]["group_norm_silu"],
                             "sample_dpmpp": requests["dpmpp"]["counts"]["group_norm_silu"],
                             "serve_ddim": serving["ddim"]["gn_launches"],
                             "serve_dpmpp": serving["dpmpp"]["gn_launches"],
                             "protocol_pixel": protocol["pixel"]["counts"]["group_norm_silu"],
                             "protocol_flow": protocol["flow"]["counts"]["group_norm_silu"],
                             "distill": consistency["run_counts"]["group_norm_silu"],
                             "serve_consistency_2": consistency["serving"]["gn_launches"],
                             "train_latent": latent["train_counts"]["group_norm_silu"],
                             "sample_latent": latent["sample_gn_counts"]["graphed"],
                             "serve_latent_ddim": latent["serving"]["gn_launches"],
                             "protocol_latent": latent["protocol"]["counts"]["group_norm_silu"],
                             "workflow_generate_ddim50_b320":
                                 workflow["generate"]["gn_launches"],
                             "drill_mnist": drill["counts"]["group_norm_silu"],
                             **res_launches("group_norm_silu")},
        "launches_per_step": {**per_step("group_norm_silu"),
                              "distill": consistency["per_step"]["group_norm_silu"],
                              "latent_train": latent["train_per_step"]["group_norm_silu"],
                              **res_per_step("group_norm_silu")},
        "max_spacings": gnorm["max_spacings"],
        "err_unit": "bf16 spacings at the larger magnitude (no less than 2^-6): the norm from "
                    "the plain chain's, the SiLU from F.silu of the kernel's own norm, and from "
                    "the plain chain's SiLU",
        **{k: gnorm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes",
                                 "bound_flops")},
        "bound_peaks": "3.35 TB/s (H100 SXM at 700 W)",
        "library_ms": None,
        "library": "no single PyTorch call takes bf16 channels_last to bf16 channels_last with "
                   "fp32 statistics; plain_ms is the model layer's chain before the pass",
        "rows": gnorm["rows"],
        "timed": "the pixel UNet's 23 norms of a sampler step at 2B=256, bf16, each site's "
                 "time by CUDA-graph replay times its calls; the plain chain likewise",
        "sd": gnorm_sd,
    }, {
        "name": "fused_adam_ema",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/fused_adam_ema.cu",
        "replaces": "ldm_tpu/training/state.py:78",
        "replaces_kind": "no pl.pallas_call: fused_apply_gradients, the JAX package's one-pass "
                         "Adam + EMA, which XLA compiles",
        "launches": train_counts["fused_adam_ema"],
        "launches_by_path": {"sample": sample_counts["fused_adam_ema"],
                             "train": train_counts["fused_adam_ema"],
                             "protocol_pixel": protocol["pixel"]["counts"]["fused_adam_ema"],
                             "protocol_flow": protocol["flow"]["counts"]["fused_adam_ema"],
                             "distill": consistency["run_counts"]["fused_adam_ema"],
                             "train_latent": latent["train_counts"]["fused_adam_ema"],
                             "protocol_latent": latent["protocol"]["counts"]["fused_adam_ema"],
                             "train_mesh_cli": mesh["cli"]["launches"]["fused_adam_ema"],
                             "train_gloo_rank0":
                                 mesh["gloo"]["rank0"]["launches"]["fused_adam_ema"],
                             "workflow_train_profiled":
                                 workflow["train"]["launches"]["fused_adam_ema"],
                             **{k: v["fused_adam_ema"] for k, v in axis_launches.items()},
                             "drill_mnist": drill["counts"]["fused_adam_ema"],
                             **res_launches("fused_adam_ema")},
        "launches_per_step": {**per_step("fused_adam_ema"),
                              "train_dp_per_rank":
                                  mesh["world1"]["launches"]["dp"]["fused_adam_ema"],
                              "train_fsdp_per_rank":
                                  mesh["world1"]["launches"]["fsdp"]["fused_adam_ema"],
                              "distill": consistency["per_step"]["fused_adam_ema"],
                              "latent_train": latent["train_per_step"]["fused_adam_ema"]},
        "max_abs_err": fused["max_abs_err"],
        "max_abs_err_by_stream": fused["max_abs_err_by_stream"],
        **{k: fused[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes",
                                 "bound_flops", "ms_no_ema", "bound_ms_no_ema", "foreach_ms",
                                 "fused_lerp_ms", "train_step_device_ms",
                                 "train_step_device_ms_runs")},
        "bound_peaks": "3.35 TB/s, 67 TFLOP/s fp32 (H100 SXM at 700 W)",
        "library_ms": None,
        "library": "no single PyTorch call computes Adam and the EMA; foreach_ms (torch's "
                   "capturable foreach Adam + a per-leaf EMA, the update before this kernel) "
                   "and fused_lerp_ms (torch.optim.Adam(fused=True) + torch._foreach_lerp_) "
                   "are yardsticks on the same tensors, never called by the port",
        "timed": "the flagship's 200 leaves, 20,350,915 parameters, fp32, with the EMA "
                 "(ms_no_ema: without); kernel, plain version and yardsticks by CUDA-graph "
                 "replay; train_step_device_ms: a replayed train step at B=64 bf16 with this "
                 "pass and with the foreach update, in turns",
    }], "train_step_ms": training["step_ms"], "paths": paths,
        "paths_unit": "host ms/step (median of 5 runs) as a replayed CUDA graph and eager, and "
                      "the device's ms for one replay; bf16; request_b10 is the B=10 request's "
                      "step, sampler_b64 the B=64 sampler's, train_b64 the train step",
        "requests": {k: {"steps": v["steps"], "seconds": v["seconds"],
                         "capture_seconds": v["capture_seconds"]} for k, v in requests.items()},
        "persistent_launches": {
            "sampler_2b256": sampler_persistent, "train_step_b64": training["persistent"],
            "serve_ddim_2b128": serving["ddim"]["persistent"],
            "latent_sampler_2b20": latent["sampler_persistent"],
            **{f"request_{k}_2b20": v["persistent"] for k, v in requests.items()}},
        "epoch_paths": {**training["epochs"], **epoch_check},
        "epoch_paths_unit": "host ms/step of the device-resident epoch (scan) and the per-batch "
                            "loop (loop), graphed, median of 5 epochs of 9 steps at B=64 bf16, "
                            "and the device's ms a replay of each step",
        "serving": serving,
        "mesh": {"world1": {k: v for k, v in mesh["world1"].items() if k != "launches"},
                 "gloo": mesh["gloo"], "serving": mesh["serving"],
                 "cli_steps": mesh["cli"]["step_counts"]},
        "mesh_unit": "phase 7f: world1 fp32 losses / attention weights vs one process (rel), "
                     "and host ms a step graphed / eager with the device's ms a replay, B=64 "
                     "bf16, for one / dp / fsdp at world size 1 over NCCL; gloo: 2 processes on "
                     "one card, fp32, global B=64, eager by design; serving: DDIM-50 B=64 one "
                     "device vs 2 replicas on cuda:0",
        "model_axis": {"gloo": axis["gloo"],
                       "world1": {k: v for k, v in axis["world1"].items() if k != "launches"},
                       "seconds": axis["seconds"]},
        "model_axis_unit": "phase 7h: gloo: 2 processes on one card as (data=1, model=2), fp32, "
                           "global B=64, eager by design, tp / fsdp_tp / spatial vs one process "
                           "(losses rel, parameters abs, bytes a process, host ms a step) and "
                           "the DDIM-50 request at B=10 (max abs vs one process, seconds); "
                           "world1: tp at model = 1 over NCCL vs one process, fp32, graphed",
        "pipeline": pipeline,
        "pipeline_unit": "phase 7i: payload: one process, bf16, 2B=128, encode / decode and the "
                         "payload bit for bit, the staged pass's launches; gloo: 2 processes on "
                         "one card as (data=1, model=2), fp32, global B=64, eager by design, at "
                         "M = 2 and 4 microbatches vs one process (losses and gradient norms "
                         "rel, parameters abs, bytes a process, a payload transfer's bytes, host "
                         "ms a step, launches) and the DDIM-50 request at B=10 (max abs vs one "
                         "process, seconds, launches); seconds: the phase's wall time",
        "protocol": protocol,
        "resolution": resolution,
        "resolution_unit": "phase 7l: probe43: the 128px flagship train step (bf16, T=1000, "
                           "replayed graph) swept over B, bytes from max_memory_allocated / "
                           "reserved, seconds host wall clock, device_ms a replay; probe39 / "
                           "probe39b: 64px, 2,560 images, 1 + 1 epochs, n_fid 128, img/s host "
                           "wall clock; probe41: 2 gloo processes on cuda:0, step_s host wall "
                           "clock over 3 steps, peak_bytes a process",
        "drill": drill,
        "drill_unit": "phase 7j: ldm_tpu_torch.main --strict-data --wandb on "
                      "configs/pixel_diffusion_model_mnist.yaml at full width, bf16, CFG 3, from "
                      "2,560 + 512 fabricated raw MNIST images, 1 generator epoch, 2 classifier "
                      "epochs, 32 images a class by DDIM-50; seconds: wall, by phase",
        "workflow": workflow,
        "workflow_unit": "phase 7g: train --profile (2 epochs of 9 steps, B=64), generate "
                         "DDIM-50 at B=320 into the PNG tree, train_classifier --pretrain-dir "
                         "(ResNet-18, B=64, 2 epochs), the bridge; seconds: host wall clock",
        "consistency": {k: v for k, v in consistency.items() if k != "path"},
        "latent": {k: v for k, v in latent.items() if k not in ("train_path", "sampler_path")},
        "consistency_unit": "phase 7d: distill.main at the flagship width, B=64, bf16; requests "
                            "B=10 through generate.main; serving consistency-2 at B=64 as "
                            "serving_unit",
        "latent_unit": "phase 7e: configs/autoencoder_hard.yaml and latent_diffusion_hard.yaml at "
                       "full width, B=64, bf16; serving latent DDIM-50 at B=64; protocol as "
                       "protocol_unit with --generator-config",
        "protocol_unit": "ldm_tpu_torch.main at full width, bf16, CFG 3, 2,560 synthetic images, "
                         "1 generator epoch, 2 classifier epochs, 32 images a class, "
                         "--negative-control; seconds: wall by phase; classifier_step: host "
                         "ms a step graphed / eager and the device's ms a replay, B=64",
        "serving_unit": "B=64, CFG 3, bf16; saturated: 2,048 images from 8 client threads of "
                        "32-image requests, latency client side; host_ms_per_batch the batcher "
                        "thread's; device_ms_per_batch steps x the device's ms a replay",
    }))
    phase("12 the port's bench, --quick: ldm_tpu_torch.bench.main in this process on cuda:0")
    check_bench(config, paths["sampler_b64"]["device_ms"], paths["train_b64"]["graphed_ms"], tag)

    print(f"chip_smoke wall time {time.perf_counter() - t_script:.1f} s (the build included)")
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
