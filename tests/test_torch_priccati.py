"""The parallel-in-time Riccati route in the port (`solvers/priccati.py`,
``method="priccati"``), on the CPU against the JAX package's
`pmpc_tpu.solvers.priccati` and against the port's sequential sweeps
(`solvers/riccati.py`), on tests/test_priccati.py's seeded cases:

- f64: `affine_scan_rollout` against the loop; `priccati_solve` at
  N in {1, 2, 7, 40}; `priccati_solve_scp`; `priccati_consensus_solve` at
  (M, Nc) in {(1, 0), (3, 0), (3, 2), (4, 5)}: U, X, K and k to 1e-9 of both;
- f32 at N = 160: within the JAX test's bound (2e-3 relative to max(1,
  |U|)) of the f64 sequential sweep, and within the same of the JAX f32
  priccati (the scans pair their products differently);
- `build_scp_solver(method="priccati")` against `jax.vmap` of the JAX solver
  built with it (unbounded, f64, U to 1e-9 with equal counts), and with
  control bounds the Riccati IPM route, equal to ``method="riccati"``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.jax_scp import build_scp_solver as j_build, make_scp_data as j_make
from pmpc_tpu.solvers import priccati as jpr
from pmpc_tpu_torch.convert import scp_data_from_numpy
from pmpc_tpu_torch.solvers import priccati as tpr
from pmpc_tpu_torch.solvers import riccati as tri
from pmpc_tpu_torch.torch_scp import build_scp_solver

import oracle
from test_priccati import _rand_stage_problem

torch.set_num_threads(2)
TOL = 1e-9


def _t(a, dt=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dt)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def test_affine_scan_rollout_matches_loop():
    rng = np.random.default_rng(0)
    N, xdim = 13, 4
    F = 0.8 * rng.normal(size=(N, xdim, xdim))
    d = rng.normal(size=(N, xdim))
    x0 = rng.normal(size=(xdim,))
    X = tpr.affine_scan_rollout(_t(F), _t(d), _t(x0)).numpy()
    _close(X, np.asarray(jpr.affine_scan_rollout(*map(jnp.asarray, (F, d, x0)))))
    x = x0
    for j in range(N):
        x = F[j] @ x + d[j]
        _close(X[j], x)


@pytest.mark.parametrize("N", [1, 2, 7, 40])
def test_priccati_matches_jax_and_sequential_riccati(N):
    rng = np.random.default_rng(3 + N)
    args = _rand_stage_problem(rng, N=N)
    par = tpr.priccati_solve(*map(_t, args))
    seq = tri.riccati_solve(*map(_t, args))
    ref = jpr.priccati_solve(*map(jnp.asarray, args))
    for name in ("U", "X", "K", "k"):
        _close(getattr(par, name), getattr(ref, name))
        _close(getattr(par, name), getattr(seq, name))


def test_priccati_scp_matches_jax_and_sequential():
    rng = np.random.default_rng(11)
    p = oracle.random_problem(rng, M=1, N=12, xdim=3, udim=2)
    keys = ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref")
    args = [p[k][0] for k in keys]
    par = tpr.priccati_solve_scp(*map(_t, args), reg_x=1.0, reg_u=0.1)
    seq = tri.riccati_solve_scp(*map(_t, args), reg_x=1.0, reg_u=0.1)
    ref = jpr.priccati_solve_scp(*map(jnp.asarray, args), reg_x=1.0, reg_u=0.1)
    _close(par.U, ref.U)
    _close(par.U, seq.U)


@pytest.mark.parametrize("M,Nc", [(1, 0), (3, 0), (3, 2), (4, 5)])
def test_priccati_consensus_matches_jax_and_sequential(M, Nc):
    rng = np.random.default_rng(29 + 10 * M + Nc)
    p = oracle.random_problem(rng, M=M, N=9, xdim=3, udim=2)
    keys = ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref")
    reg_x, reg_u = np.full((M,), 1.0), np.full((M,), 0.1)
    args = [p[k] for k in keys] + [reg_x, reg_u]
    Xp, Up = tpr.priccati_consensus_solve(*map(_t, args), Nc=Nc)
    Xs, Us = tri.riccati_consensus_solve(*map(_t, args), Nc=Nc)
    Xj, Uj = jpr.priccati_consensus_solve(*map(jnp.asarray, args), Nc=Nc)
    for a, b in ((Up, Uj), (Xp, Xj), (Up, Us), (Xp, Xs)):
        _close(a, b)
    if Nc:
        assert np.ptp(Up.numpy()[:, :Nc, :], axis=0).max() < 1e-12


def test_priccati_f32_accuracy_long_horizon():
    """f32 scans track the f64 sequential sweep at N = 160."""
    rng = np.random.default_rng(5)
    x0, c, A, B, Qt, xt, Rt, ut = _rand_stage_problem(rng, N=160)
    A = 0.95 * A / np.maximum(1.0, np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None])
    args = (x0, c, A, B, Qt, xt, Rt, ut)
    ref = tri.riccati_solve(*map(_t, args)).U.numpy()
    par = tpr.priccati_solve(*[_t(a, torch.float32) for a in args]).U
    assert par.dtype == torch.float32
    scale = np.abs(ref).max()
    err = np.abs(par.numpy().astype(np.float64) - ref).max()
    assert err <= 2e-3 * max(1.0, scale), (err, scale)
    j32 = np.asarray(jpr.priccati_solve(*[jnp.asarray(np.asarray(a, np.float32))
                                          for a in args]).U, np.float64)
    assert np.abs(par.numpy() - j32).max() <= 2e-3 * max(1.0, scale)


def _dub_j(x, u):
    return x + 0.1 * jnp.concatenate([jnp.sin(x[2:4]), u])


def _dub_t(x, u):
    return x + 0.1 * torch.cat([torch.sin(x[2:4]), u])


def _batch(B, M, N, seed, bounds):
    rng = np.random.default_rng(seed)
    ds = [j_make(np.ones((M, 4)) + 0.5 * rng.normal(size=(M, 4)),
                 np.tile(np.eye(4), (M, N, 1, 1)), np.tile(1e-2 * np.eye(2), (M, N, 1, 1)),
                 reg_x=1.0, reg_u=0.1,
                 **(dict(u_l=-np.full((M, N, 2), 0.6), u_u=np.full((M, N, 2), 0.6))
                    if bounds else {}))
          for _ in range(B)]
    j_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *ds)
    return j_batch, scp_data_from_numpy(jax.tree.map(np.asarray, j_batch), "cpu",
                                        torch.float64)


@pytest.mark.parametrize("M,Nc", [(3, 2), (1, 0)])
def test_priccati_method_matches_vmapped_jax(M, Nc):
    N = 9
    kw = dict(N=N, xdim=4, udim=2, M=M, Nc=Nc, max_it=8, res_tol=1e-8, accel="AA")
    j_batch, batch = _batch(3, M, N, 40 + M, bounds=False)
    Xj, Uj, ij = jax.jit(jax.vmap(j_build(_dub_j, method="priccati", jit=False, **kw)))(j_batch)
    X, U, info = build_scp_solver(_dub_t, method="priccati", **kw)(batch)
    _close(U, Uj)
    _close(X, Xj)
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(ij["iters"]))
    # the sequential route reaches the same point
    _, Us, _ = build_scp_solver(_dub_t, method="riccati", **kw)(batch)
    _close(U, Us)


def test_priccati_with_bounds_is_the_riccati_ipm():
    N, M = 8, 2
    kw = dict(N=N, xdim=4, udim=2, M=M, Nc=2, max_it=6, res_tol=1e-8,
              has_u_bounds=True, ipm_iters=20, collect_stats=True)
    _, batch = _batch(2, M, N, 77, bounds=True)
    X, U, info = build_scp_solver(_dub_t, method="priccati", **kw)(batch)
    Xr, Ur, ir = build_scp_solver(_dub_t, method="riccati", **kw)(batch)
    torch.testing.assert_close(U, Ur, rtol=0, atol=0)
    torch.testing.assert_close(info["scan_stats"]["ipm_iters"],
                               ir["scan_stats"]["ipm_iters"], rtol=0, atol=0)
    assert U.abs().max() <= 0.6 + 1e-6  # the box to the IPM's tolerance
