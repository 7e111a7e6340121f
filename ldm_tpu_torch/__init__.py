"""ldm_tpu_torch — the PyTorch / CUDA port of ldm_tpu for NVIDIA Hopper (H100).

The JAX package ``ldm_tpu`` is the reference this package is held against;
modules keep its paths and names.  Ported so far: the sampling slice — the
class-conditional UNet, the ancestral DDPM sampler with classifier-free
guidance, and the fused linear-attention block as a hand-written CUDA kernel
(``csrc/linear_attention_fwd.cu``).

This package imports torch, numpy and the stdlib, plus the JAX-free
``ldm_tpu`` modules ``config``, ``data.transforms`` and ``utils.torch_export``;
it never imports jax or flax.
"""
