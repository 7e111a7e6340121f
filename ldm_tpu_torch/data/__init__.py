"""Data of the port: numpy readers, synthetic generators, loaders and
transforms; the twins of ``ldm_tpu/data/``, with a resize in numpy."""
