"""Data, tensor and spatial parallelism and the multi-process runtime (port
of ``ldm_tpu/parallel/``; pipeline parallelism is ROADMAP item 12b.3)."""

from ldm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    global_batch_multiple,
    shard_batch,
)
