"""Data parallelism across processes, one device a rank."""

from .mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    shard_stacked_batch,
    replicate,
    jit_train_step_dp,
    jit_multi_step_dp,
    shard_map_forward_dp,
    shard_map_step_dp,
)
from .distributed import (  # noqa: F401
    initialize,
    HostShardedBatcher,
    global_batch,
    global_stacked_batch,
)
