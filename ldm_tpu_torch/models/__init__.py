"""Models (PyTorch ports of ldm_tpu.models)."""
