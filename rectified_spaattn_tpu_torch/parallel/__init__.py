from .mesh import (AllGather, DistGroup, InProcessGroup, Mesh, Shift,
                   in_process_mesh, init_distributed, local_device, make_mesh)
from .sharding import RowParallelLinear, ShardedRMSNorm, shard_model
from .multihost import shard_prompts

__all__ = [
    "AllGather", "DistGroup", "InProcessGroup", "Mesh", "Shift",
    "in_process_mesh", "init_distributed", "local_device", "make_mesh",
    "RowParallelLinear", "ShardedRMSNorm", "shard_model",
    "shard_prompts",
]
