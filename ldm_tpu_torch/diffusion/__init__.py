"""Diffusion processes (PyTorch ports of ldm_tpu.diffusion)."""
