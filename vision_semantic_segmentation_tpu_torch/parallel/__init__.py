"""The device mesh, frame-parallel replay, the row-sharded grid, the process
group of data-parallel training, the spatially sharded (row-banded) forward
and the training steps of the port."""
from .mesh import (
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    create_mesh,
    data_sharding,
    grid_row_sharding,
    local_devices,
    psum,
    replicated,
    shard_batch,
    shard_spatial_batch,
    shard_stacked_batches,
)
from .distributed import World, ensure_distributed
from .train_step import (
    TrainState,
    make_eval_step,
    make_multi_train_step,
    make_per_device_bn_train_step,
    make_spatial_eval_step,
    make_spatial_train_step,
    make_train_step,
)
from .spatial_infer import Bands, SpatialModel, make_spatial_forward, replicate_variables, shard_image
from .grid_shard import (
    ShardedGrid,
    gather_grid,
    init_sharded_grid,
    make_band_updater,
    make_sharded_frame_parallel_run,
    make_sharded_step,
    shard_grid,
)
from .frame_parallel import make_frame_parallel_run, stack_frames

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "create_mesh",
    "data_sharding",
    "grid_row_sharding",
    "local_devices",
    "psum",
    "replicated",
    "shard_batch",
    "shard_spatial_batch",
    "shard_stacked_batches",
    "World",
    "ensure_distributed",
    "TrainState",
    "make_eval_step",
    "make_multi_train_step",
    "make_per_device_bn_train_step",
    "make_spatial_eval_step",
    "make_spatial_train_step",
    "make_train_step",
    "Bands",
    "SpatialModel",
    "make_spatial_forward",
    "replicate_variables",
    "shard_image",
    "ShardedGrid",
    "gather_grid",
    "init_sharded_grid",
    "make_band_updater",
    "make_sharded_frame_parallel_run",
    "make_sharded_step",
    "shard_grid",
    "make_frame_parallel_run",
    "stack_frames",
]
