"""Batch and particle sharding over ``torch.distributed`` ranks (one process
per card): the twin of ``pmpc_tpu/parallel/``."""

from .mesh import data_sharding, make_mesh, shard_batched_data  # noqa: F401
from .sharded import make_sharded_solver  # noqa: F401
