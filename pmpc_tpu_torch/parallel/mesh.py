"""The ("batch", "particle") mesh over the process group's ranks, and each
rank's shard of a batch.

Twin of ``pmpc_tpu/parallel/mesh.py``. The JAX package places a
(B, M, ...) batch on a device mesh and lets XLA partition the program; here
each rank is one process (one card) and holds its own shard as plain
tensors: B cut by the rank's batch coordinate, M by its particle
coordinate. The scenarios are pure data parallel; a problem's particles,
when spread, meet in the consensus reductions over the mesh's particle
group (`particles`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..torch_scp import SCPData
from ..utils import default_device


def make_mesh(n_batch: Optional[int] = None, n_particle: int = 1,
              device_type: Optional[str] = None):
    """A ("batch", "particle") `DeviceMesh` over the default process group's
    ranks (`distributed.init_distributed` first), rank ``b * n_particle + p``
    at (b, p). ``device_type``: "cuda" or "cpu"; None takes the card
    (`utils.default_device`) under either backend, gloo included: the
    shards go to the CPU only when the caller passes "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (call init_distributed first)")
    n = dist.get_world_size()
    if n_batch is None:
        n_batch = n // n_particle
    if n_batch * n_particle != n:
        raise ValueError(f"mesh {n_batch}x{n_particle} does not cover {n} ranks")
    if device_type is None:
        device_type = default_device().type
    return init_device_mesh(device_type, (n_batch, n_particle),
                            mesh_dim_names=("batch", "particle"))


def rank_device(mesh) -> torch.device:
    """The device this rank's shards live on: its current card on a "cuda"
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def coords(mesh):
    """(batch coordinate, particle coordinate, n_batch, n_particle) of this rank."""
    return (mesh.get_local_rank("batch"), mesh.get_local_rank("particle"),
            mesh.size(0), mesh.size(1))


def _cut(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis of {size} does not split over {n} ranks")
    return x.narrow(dim, i * (size // n), size // n)


def shard_batched_data(data: SCPData, mesh, shard_particles: bool = True) -> SCPData:
    """This rank's shard of a full (B, M, ...) batch, on the rank's device
    (`rank_device`): B cut by the batch coordinate and,
    with ``shard_particles``, M by the particle coordinate (M % n_particle
    == 0). Leaves with fewer than 2 dims are not a (B, M, ...) batch and are
    replicated, as the JAX function replicates them; without
    ``shard_particles`` the ranks of a particle group hold the same shard."""
    b, p, nb, npart = coords(mesh)
    dev = rank_device(mesh)

    def place(x):
        if x is None:
            return None
        if x.ndim >= 2:
            x = _cut(x, 0, b, nb)
            if shard_particles:
                x = _cut(x, 1, p, npart)
        return x.to(dev)

    return SCPData(*(place(getattr(data, f)) for f in SCPData._fields))
