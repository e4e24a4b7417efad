"""The device mesh, frame-parallel replay, the row-sharded grid and the
training steps of the port.  The data-parallel training steps (ROADMAP
queue 1 item 4) and spatial sharding (item 5) are not ported yet."""
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
from .train_step import TrainState, make_eval_step, make_train_step
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
    "TrainState",
    "make_eval_step",
    "make_train_step",
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
