"""ldm_tpu_torch — the PyTorch / CUDA port of ldm_tpu for NVIDIA Hopper (H100).

The JAX package ``ldm_tpu`` is the reference this package is held against;
modules keep its paths and names.  Ported so far: the sampling slice — the
class-conditional UNet, the ancestral DDPM, DDIM and DPM-Solver++(2M)
samplers with classifier-free guidance — the training slice with its
device-resident epoch, and the serving layer (``serving/``, the host C++
batcher in ``native/``), with every TPU kernel of the JAX package as a
hand-written CUDA kernel (``csrc/``): the fused linear-attention block
forward and backward, the fused ResNet block, and the two stage-ablation
probes (``perf/``).

This package imports torch, numpy and the stdlib; it never imports jax,
flax or anything of ``ldm_tpu``.
"""
