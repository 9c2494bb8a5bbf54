"""Continuous batching for a stream of problems (lane refill).

A batched solve runs every lane to the batch's slowest: with problems of
mixed difficulty, converged lanes idle while the stragglers finish. This
module keeps a fixed B-lane batch on the device busy from a stream of
problems: it advances every lane ``chunk_it`` SCP iterations at a time
(`run_chunk`), retires finished lanes into device result buffers, gathers
the next problems into those lanes and re-initializes only their carries
(`init_carry` on the gathered rows). The analog of the reference farm's
greedy dispatch and requeue (``pmpc/remote.py:391-452``).

Twin of ``pmpc_tpu/stream.py``. The JAX function runs the whole stream as
one device ``while_loop`` with one-hot matmul gathers (scatter and gather
were slow on its backend). Here the host drives the loop and reads one
thing per chunk, the lanes' finished mask: a torch program cannot branch
on device values without a host read, and one read per chunk is the
idiom. Retiring and refilling are index copies on the device; the results
come back to the host in one transfer at the end.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .torch_scp import SCPData
from .tracing import COUNTS
from .utils import to_host


def _stack(stream: Sequence[SCPData]) -> SCPData:
    """Single (M, ...) problems -> one (S, M, ...) pool."""
    return SCPData(*(None if getattr(stream[0], f) is None
                     else torch.stack([getattr(d, f) for d in stream])
                     for f in SCPData._fields))


def _rows(tree, idx):
    """Rows ``idx`` of every tensor of a tuple tree (None passes through)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_rows(t, idx) for t in tree)) if hasattr(tree, "_fields") \
            else tuple(_rows(t, idx) for t in tree)
    return tree[idx]


def _put(tree, idx, rows):
    """``tree`` with rows ``idx`` replaced by ``rows`` (out of place)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [_put(t, idx, r) for t, r in zip(tree, rows)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree.index_copy(0, idx, rows.to(tree.dtype))


def solve_stream(
    solver,
    stream: Sequence[SCPData],
    B: int,
    chunk_it: int = 4,
    max_it: int = 10_000,
    max_rounds: int = 100_000,
    stats: Optional[dict] = None,
) -> List[Tuple[np.ndarray, np.ndarray, dict]]:
    """Solve a stream of same-shape problems with lane refill.

    Args:
        solver: a `build_scp_solver(...)` result (it carries ``init_carry``
            / ``run_chunk`` / ``extract``).
        stream: single problems, `SCPData` of (M, ...) tensors on one
            device (`convert.scp_data_from_numpy` turns a JAX ``SCPData``
            into one).
        B: lanes of the device batch.
        chunk_it: SCP iterations between two refills.
        max_it: iteration budget of a problem (the solver's own ``max_it``
            is none, as in the JAX function): `run_chunk` does not move a
            lane past it, and a lane that reaches it unconverged is retired
            with ``info["converged"] = False``.
        stats: a dict to receive ``rounds`` (chunks run), ``host_reads``
            (one per chunk, the final transfer, and the IPM's loop tests
            inside the chunks, one per IPM iteration) and ``lane_slots``
            (B x chunk_it x rounds: the lane-iterations the batch ran).

    Returns:
        (X_traj, U, info) per problem in input order, numpy;
        ``info["iters"]`` is the problem's own iteration count, not a batch
        maximum.
    """
    S = len(stream)
    if S == 0:
        return []
    B = min(B, S)
    reads0 = COUNTS["host_read"]
    pool = _stack(stream)
    dev = pool.x0.device
    data = _rows(pool, torch.arange(B, device=dev))
    carry = solver.init_carry(data)
    X0, U0, _ = solver.extract(data, carry)
    rX = X0.new_zeros((S,) + X0.shape[1:])
    rU = U0.new_zeros((S,) + U0.shape[1:])
    rmeta = X0.new_zeros((S, 3))  # iters, resid, converged
    lane_prob = np.arange(B)  # the problem in each lane (-1: none)
    next_p, n_done, rounds = B, 0, 0
    while n_done < S and rounds < max_rounds:
        carry = solver.run_chunk(data, carry, chunk_it, max_it)
        rounds += 1
        fin = (carry[3] | (carry[2] >= max_it)).cpu().numpy() & (lane_prob >= 0)
        lanes = np.flatnonzero(fin)
        if not len(lanes):
            continue
        # retire the finished lanes into the result rows of their problems
        li = torch.as_tensor(lanes, device=dev)
        pi = torch.as_tensor(lane_prob[lanes], device=dev)
        X, U, info = solver.extract(_rows(data, li), _rows(carry, li))
        rX, rU = rX.index_copy(0, pi, X), rU.index_copy(0, pi, U)
        meta = torch.stack([info["iters"].to(rmeta.dtype), info["resid"].to(rmeta.dtype),
                            info["converged"].to(rmeta.dtype)], -1)
        rmeta = rmeta.index_copy(0, pi, meta)
        n_done += len(lanes)
        lane_prob[lanes] = -1
        # refill: the k-th finished lane takes problem next_p + k
        k = min(len(lanes), S - next_p)
        if k:
            new = torch.as_tensor(lanes[:k], device=dev)
            probs = np.arange(next_p, next_p + k)
            fresh = _rows(pool, torch.as_tensor(probs, device=dev))
            data = _put(data, new, fresh)
            carry = _put(carry, new, solver.init_carry(fresh))
            lane_prob[lanes[:k]] = probs
            next_p += k
    if n_done < S:
        raise RuntimeError(
            f"solve_stream: only {n_done}/{S} problems finished (max_rounds={max_rounds})")
    rX, rU, rmeta = to_host([rX, rU, rmeta])
    if stats is not None:
        stats.update(rounds=rounds, host_reads=rounds + 1 + COUNTS["host_read"] - reads0,
                     lane_slots=B * chunk_it * rounds)
    return [(rX[i], rU[i], dict(iters=int(rmeta[i, 0]), resid=float(rmeta[i, 1]),
                                converged=bool(rmeta[i, 2] > 0)))
            for i in range(S)]

