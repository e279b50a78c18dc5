"""Data and string-head parallelism over ``torch.distributed`` ranks (the
JAX package's ``parallel/``)."""

from .collectives import use_mesh
from .mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    maybe_initialize_distributed,
    param_shardings,
    replicated,
    shard_batch,
    shard_model,
    string_param_names,
)

__all__ = [
    "Mesh", "batch_sharding", "make_mesh", "maybe_initialize_distributed",
    "param_shardings", "replicated", "shard_batch", "shard_model", "string_param_names",
    "use_mesh",
]
