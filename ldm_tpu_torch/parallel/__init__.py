"""Data, tensor, spatial and pipeline parallelism and the multi-process
runtime (port of ``ldm_tpu/parallel/``)."""

from ldm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    global_batch_multiple,
    shard_batch,
)
from ldm_tpu_torch.parallel.pp import (  # noqa: F401
    gather_state_dict,
    make_pp_apply,
    pipeline_unet_apply,
    pp_stage,
    split_unet_state_dict,
)
