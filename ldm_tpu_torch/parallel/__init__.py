"""Data parallelism, FSDP and the multi-process runtime (port of
``ldm_tpu/parallel/`` for the data axis; the model axis is ROADMAP item 12b)."""

from ldm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    global_batch_multiple,
    shard_batch,
)
