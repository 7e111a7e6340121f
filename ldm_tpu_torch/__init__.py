"""ldm_tpu_torch — the PyTorch / CUDA port of ldm_tpu for NVIDIA Hopper (H100).

The JAX package ``ldm_tpu`` is the reference this package is held against;
modules keep its paths and names.  Ported so far: the sampling slice — the
class-conditional UNet, the ancestral DDPM sampler with classifier-free
guidance — and the training slice, with every TPU kernel of the JAX package
as a hand-written CUDA kernel (``csrc/``): the fused linear-attention block
forward and backward, the fused ResNet block, and the two stage-ablation
probes (``perf/``).

This package imports torch, numpy and the stdlib, plus the JAX-free
``ldm_tpu`` modules ``config``, ``data.datasets``, ``data.loader`` and
``utils.torch_export``; it never imports jax or flax.
"""
