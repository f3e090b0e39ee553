"""Data parallelism, FSDP and spatial sharding over torch.distributed, one
process per card (port of weatherconverter_tpu/parallel)."""

from weatherconverter_tpu_torch.parallel.distributed import (
    is_primary,
    maybe_initialize_distributed,
    process_count,
)
from weatherconverter_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    data_sharding,
    local_batch_slice,
    make_mesh,
    pad_to_multiple,
    plan_data_parallel,
    replicate,
    replicated,
    shard_batch,
)
from weatherconverter_tpu_torch.parallel.spatial import (
    SPACE_AXIS,
    constrain_spatial,
    make_spatial_mesh,
    shard_spatial,
    spatial_image_sharding,
)

__all__ = [
    "DATA_AXIS", "make_mesh", "data_sharding", "replicated", "shard_batch", "replicate", "pad_to_multiple", "local_batch_slice",
    "plan_data_parallel", "maybe_initialize_distributed", "process_count", "is_primary",
    "SPACE_AXIS", "make_spatial_mesh", "spatial_image_sharding", "shard_spatial", "constrain_spatial",
]
