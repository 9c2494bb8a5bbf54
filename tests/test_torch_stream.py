"""Lane refill in the port (`pmpc_tpu_torch.stream.solve_stream` and the
solver's `init_carry` / `run_chunk` / `extract`), f64 on the CPU, against
the JAX package on the same seeded problems:

- the twins of tests/test_stream.py's two cases (the second against the
  JAX stream: the stream's budget, not the solver's max_it, bounds a lane);
- each problem of a stream against its standalone port solve, to 1e-10 with
  equal iteration counts (the refill changes the schedule, never the math:
  a lane computes what the problem computes alone, up to the batch's
  rounding);
- each problem against the JAX standalone solve, to 1e-7;
- `init_carry` / `run_chunk` / `extract` against `jax.vmap` of the JAX
  pieces on one batch, to 1e-9 with equal counts.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.jax_scp import build_scp_solver as j_build, make_scp_data as j_make
from pmpc_tpu.stream import solve_stream as j_solve_stream
from pmpc_tpu_torch.convert import scp_data_from_numpy
from pmpc_tpu_torch.stream import solve_stream
from pmpc_tpu_torch.torch_scp import SCPData, build_scp_solver

torch.set_num_threads(2)
f64 = torch.float64


def _dub_j(x, u):
    return x + 0.1 * jnp.concatenate([x[2:4], u])


def _dub_t(x, u):
    return x + 0.1 * torch.cat([x[2:4], u])


def _mk(seed, N=10, xdim=4, udim=2, scale=0.3):
    """tests/test_stream.py's problem, in f64."""
    rng = np.random.default_rng(seed)
    x0 = np.ones(xdim) + scale * rng.normal(size=xdim)
    return j_make(x0[None], np.tile(np.eye(xdim), (1, N, 1, 1)),
                  np.tile(1e-2 * np.eye(udim), (1, N, 1, 1)),
                  u_l=-np.ones((1, N, udim)), u_u=np.ones((1, N, udim)))


def _port(d):
    return scp_data_from_numpy(jax.tree.map(np.asarray, d), "cpu", f64)


def _batch(ds):
    return SCPData(*(None if getattr(ds[0], f) is None
                     else torch.stack([getattr(d, f) for d in ds]) for f in SCPData._fields))


def _solvers(N, max_it, **kw):
    args = dict(N=N, xdim=4, udim=2, M=1, Nc=0, max_it=max_it, res_tol=1e-5,
                has_u_bounds=True, **kw)
    return build_scp_solver(_dub_t, **args), j_build(_dub_j, jit=False, **args)


def test_stream_matches_standalone_solves():
    N = 10
    solver, j_solver = _solvers(N, 20, accel="AA")
    # mixed difficulty: x0 spread wide so iteration counts differ
    j_stream = [_mk(i, N=N, scale=0.1 + 0.25 * (i % 4)) for i in range(11)]
    stream = [_port(d) for d in j_stream]
    stats = {}
    out = solve_stream(solver, stream, B=4, chunk_it=3, stats=stats)
    assert len(out) == 11
    j_one = jax.jit(j_solver)
    iters = []
    for i, (X, U, info) in enumerate(out):
        assert info["converged"], (i, info)
        Xs, Us, ds = solver(_batch([stream[i]]))
        np.testing.assert_allclose(U, Us[0].numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(X, Xs[0].numpy(), rtol=0, atol=1e-10)
        assert info["iters"] == int(ds["iters"][0])
        Xj, Uj, dj = j_one(j_stream[i])
        np.testing.assert_allclose(U, np.asarray(Uj), rtol=0, atol=1e-7)
        iters.append(info["iters"])
    # per-problem iteration counts are the lane's own, not a batch max
    assert min(iters) < max(iters)
    assert stats["rounds"] >= -(-sum(iters) // (4 * 3))
    assert stats["lane_slots"] == 4 * 3 * stats["rounds"]


def test_stream_smaller_than_batch():
    """The stream's budget, not the solver's max_it, bounds a problem (as in
    the JAX function): problem 0 needs 17 iterations of the solver's 15, in
    both packages' streams."""
    solver, j_solver = _solvers(8, 15)
    j_stream = [_mk(40 + i, N=8) for i in range(2)]
    stream = [_port(d) for d in j_stream]
    out = solve_stream(solver, stream, B=8, chunk_it=2)
    assert len(out) == 2 and all(o[2]["converged"] for o in out)
    j_out = j_solve_stream(j_solver, j_stream, B=8, chunk_it=2)
    for (X, U, info), (Xj, Uj, ij) in zip(out, j_out):
        np.testing.assert_allclose(U, Uj, rtol=0, atol=1e-7)
        assert info["iters"] == ij["iters"] and info["converged"] == ij["converged"]
    assert out[0][2]["iters"] > solver.max_it


def test_lane_refill_pieces_match_jax():
    """`init_carry` -> `run_chunk` (twice) -> `extract` on one batch against
    `jax.vmap` of the JAX pieces, n_it short of the cap (the JAX
    `run_chunk` has none)."""
    N = 10
    solver, j_solver = _solvers(N, 20, accel="AA", return_state=True)
    j_ds = [_mk(70 + i, N=N, scale=0.1 + 0.3 * i) for i in range(3)]
    j_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *j_ds)
    batch = _batch([_port(d) for d in j_ds])
    carry = solver.init_carry(batch)
    jc = jax.vmap(j_solver.init_carry)(j_batch)
    for n_it in (2, 3):
        carry = solver.run_chunk(batch, carry, n_it)
        jc = jax.vmap(lambda d, c: j_solver.run_chunk(d, c, n_it))(j_batch, jc)
    X, U, info = solver.extract(batch, carry)
    Xj, Uj, ij = jax.vmap(j_solver.extract)(j_batch, jc)
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(ij["iters"]))
    np.testing.assert_array_equal(info["converged"].numpy(), np.asarray(ij["converged"]))
    np.testing.assert_allclose(info["resid"].numpy(), np.asarray(ij["resid"]),
                               rtol=1e-6, atol=1e-12)
    for a, b in zip(info["solver_state"], ij["solver_state"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    # the solver itself is these pieces run to its cap
    Xs, Us, ds = solver(batch)
    c2 = solver.run_chunk(batch, solver.init_carry(batch), solver.max_it, solver.max_it)
    X2, U2, d2 = solver.extract(batch, c2)
    torch.testing.assert_close(U2, Us, rtol=0, atol=0)
    torch.testing.assert_close(d2["iters"], ds["iters"], rtol=0, atol=0)


def test_stream_retires_capped_lanes_unconverged():
    """A problem that reaches the budget leaves unconverged with that count."""
    max_it = 3
    solver, _ = _solvers(10, 20)
    stream = [_port(_mk(90 + i, N=10, scale=1.0)) for i in range(3)]
    out = solve_stream(solver, stream, B=2, chunk_it=2, max_it=max_it)
    assert all(o[2]["iters"] <= max_it for o in out)
    assert any(not o[2]["converged"] for o in out)
