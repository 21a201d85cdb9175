"""Data parallelism — the port of `tngp/parallel/`: the process group's
environment contract (`distributed.py`) and the ('data', 'model') mesh over
its ranks, with the ray slices, the parameter broadcast and the gradient
average that the trainer uses (`mesh.py`)."""

from .distributed import global_mesh, init_distributed, is_primary
from .mesh import (
    Mesh,
    data_parallel_value_and_grad,
    make_mesh,
    param_sharding_rules,
    ray_sharding,
    replicated,
    shard_params,
)

__all__ = [
    "Mesh",
    "data_parallel_value_and_grad",
    "global_mesh",
    "init_distributed",
    "is_primary",
    "make_mesh",
    "param_sharding_rules",
    "ray_sharding",
    "replicated",
    "shard_params",
]
