"""Data and tensor parallelism on `torch.distributed` (counterpart of
`ealdm_tpu/parallel/`): a `data` x `model` layout of ranks (`mesh.py`),
the sharding rules and their placement (`sharding.py`), the collectives
and tensor parallelism's autograd Functions (`comm.py`), and the step's
random draws at the global batch's shape (`draws.py`).
"""

from .mesh import Mesh, MeshConfig, create_mesh, local_batch_size, scale_learning_rate
from .sharding import (
    gather_state,
    param_sharding_rules,
    replicate,
    shard_batch,
    shard_params,
    shard_state,
    state_sharding_rules,
    whole,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "create_mesh",
    "local_batch_size",
    "scale_learning_rate",
    "gather_state",
    "param_sharding_rules",
    "replicate",
    "shard_batch",
    "shard_params",
    "shard_state",
    "state_sharding_rules",
    "whole",
]
