"""Multi-process runtime helpers over ``torch.distributed``.

Twin of ``pmpc_tpu/parallel/distributed.py``: one process per card, NCCL
between cards (gloo on the CPU, or for ranks that share one card, which
NCCL refuses), a global ("batch", "particle") mesh, each process's local
batch placed as its shard, and the all-gather that assembles a
batch-sharded result (the twin of ``process_allgather(..., tiled=True)``).
Nothing on a machine tells a program of its cluster: the address, the
world size and the rank come from the caller, or from torchrun's
environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..torch_scp import SCPData
from .mesh import coords, make_mesh, rank_device


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group (idempotent). ``init_method`` e.g.
    ``"tcp://localhost:29500"``; without arguments torchrun's environment
    (``env://``). ``backend``: NCCL where there is a card, else gloo. Under
    NCCL the process takes card ``LOCAL_RANK`` (or rank modulo the cards)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   (rank if rank is not None else int(os.environ.get("RANK", 0)))
                                   % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    kw = {} if init_method is None and world_size is None else \
        dict(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)


def global_mesh(n_particle: int = 1, device_type: Optional[str] = None):
    """The ("batch", "particle") mesh over every rank; ``n_particle`` should
    divide the ranks of one host, so the consensus reductions stay on
    NVLink."""
    return make_mesh(n_particle=n_particle, device_type=device_type)


def host_local_batch_to_global(mesh, data: SCPData) -> SCPData:
    """This rank's local batch (B_local, M, ...) as its shard on its device:
    the ranks of a particle group pass the same local batch, and each keeps
    its particle slice. The shapes are checked across ranks (every rank
    must hold as many problems of the same shape)."""
    import torch.distributed as dist

    _, p, _, npart = coords(mesh)
    dev = rank_device(mesh)
    shapes = [tuple(getattr(data, f).shape) for f in SCPData._fields
              if getattr(data, f) is not None]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, shapes)
    if any(s != shapes for s in every):
        raise ValueError(f"host_local_batch_to_global: the ranks' local batches differ "
                         f"in shape: {every}")

    def place(x):
        if x is None:
            return None
        if x.ndim >= 2 and npart > 1:
            x = x.narrow(1, p * (x.shape[1] // npart), x.shape[1] // npart)
        return x.to(dev)

    return SCPData(*(place(getattr(data, f)) for f in SCPData._fields))


def process_allgather(mesh, x: torch.Tensor, particle_axis: bool = True) -> torch.Tensor:
    """The full batch of a batch-sharded result: every rank's shard
    gathered and laid out by mesh coordinates, B over the batch axis and,
    with ``particle_axis`` (a (B_local, M_local, ...) leaf of a
    particle-sharded solve), M over the particle axis; without it the
    particle ranks' copies are equal and the first is kept. Every rank gets
    the result."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    ranks = mesh.mesh.tolist()  # (n_batch, n_particle) global ranks
    rows = [torch.cat([parts[r] for r in row], dim=1) if particle_axis else parts[row[0]]
            for row in ranks]
    return torch.cat(rows, dim=0)
