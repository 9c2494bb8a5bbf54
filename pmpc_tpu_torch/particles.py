"""Reductions over the particle axis: local, or completed across the ranks
that share one problem's particles.

With particle sharding (`parallel.make_sharded_solver`) each rank of a
particle group holds ``M_local`` of a problem's ``M`` particles. Every
reduction over particles in the solver cores goes through this module:
without a group (the single-process solver) each helper is the local
expression the cores always used, bit for bit; under `particle_scope` the
local partial result is completed by one all-reduce over the group, so
every rank of the group holds the same value and takes the same branch.

The flat constraint vectors of the IPMs put the consensus rows first (the
same on every rank) and the particle rows after them (each rank its own):
`split_sum` / `split_max` / `split_min` take the number of leading
consensus entries and count them once.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .tracing import COUNTS, span

_GROUP = None


@contextlib.contextmanager
def particle_scope(group):
    """Run the enclosed solve with its particle reductions over ``group`` (a
    `torch.distributed` process group; None: local)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def group():
    """The particle group of the running solve (None: local)."""
    return _GROUP


def group_size(g=None) -> int:
    g = _GROUP if g is None else g
    if g is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(g)


def _all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    if _GROUP is None or x.numel() == 0:
        return x
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    out = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous().clone()
    dist.all_reduce(out, op=red, group=_GROUP)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def psum(x: torch.Tensor) -> torch.Tensor:
    """A local sum over particles completed over the group."""
    return _all_reduce(x, "sum")


def pmax(x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(x, "max")


def pmean(x: torch.Tensor, dims) -> torch.Tensor:
    """The mean of ``x`` over ``dims`` (the particle dims among them) over
    every rank's particles; each rank holds as many."""
    if _GROUP is None:
        return x.mean(dims)
    n = 1
    for d in ((dims,) if isinstance(dims, int) else dims):
        n *= x.shape[d]
    return psum(x.sum(dims)) / (n * group_size())


def pany(x: torch.Tensor) -> bool:
    """Host read (a loop test of the SCP loop or an IPM): does any entry
    hold on any rank of the group. Counted in
    ``tracing.COUNTS["host_read"]`` and recorded as the span ``host_read``."""
    COUNTS["host_read"] += 1
    with span("host_read"):
        if _GROUP is None:
            return bool(x.any())
        return bool(pmax(x.any().reshape(1)).item())


def pfirst(x: torch.Tensor) -> torch.Tensor:
    """Rank 0 of the group's value of ``x``: what particle 0 carries (the
    consensus bounds and cone radii follow particle 0)."""
    if _GROUP is None:
        return x
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(_GROUP, 0), group=_GROUP)
    return out


def _split(x: torch.Tensor, n_rep: int, op: str, fn):
    if _GROUP is None:
        return fn(x)
    return {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op](
        fn(x[..., :n_rep]), _all_reduce(fn(x[..., n_rep:]), op))


def split_sum(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``x.sum(-1)`` of a flat vector whose first ``n_rep`` entries are the
    same on every rank of the group and whose others are the rank's own."""
    return _split(x, n_rep, "sum", lambda a: a.sum(-1))


def split_max(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``x.amax(-1)`` of such a vector (-inf where it is empty)."""
    return _split(x, n_rep, "max", lambda a: _amax(a))


def split_min(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``x.amin(-1)`` of such a vector (+inf where it is empty)."""
    return _split(x, n_rep, "min", lambda a: -_amax(-a))


def _amax(a: torch.Tensor) -> torch.Tensor:
    if a.shape[-1] == 0:
        return torch.full(a.shape[:-1], -torch.inf, dtype=a.dtype, device=a.device)
    return a.amax(-1)


def global_particles(M_local: int, g: Optional[object] = None) -> int:
    """The problem's particle count: ``M_local`` on each rank of the group."""
    return M_local * group_size(g)
