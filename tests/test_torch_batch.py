"""`pmpc_tpu_torch.solve_problems` (`batch.py`) against the JAX package's
`pmpc_tpu.solve_problems`, f64, on the CPU.

The stacked host route on tests/test_frontend.py's instances (U to 1e-7):
homogeneous problems as the particle axis, the heterogeneous fallback, an
array-valued setting with each split result's own ``data`` and ``hist``.
The ``fused=True`` route with a torch double-integrator step against the
JAX route with the same step in JAX (U to 1e-6, equal SCP iterations and
per-problem convergence), box-bounded and unbounded, and the unicycle with
u_soc_r cones. The hand-off of cone features to
`conebatch.solve_problems_cone`, and the refusals with the JAX messages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pmpc_tpu
import pmpc_tpu_torch
from fixtures import double_integrator_f_fx_fu_fn, unicycle_step
from pmpc_tpu_torch import batch, conebatch
from pmpc_tpu_torch.flagship import dubins
from test_conebatch import _extras_row, _mk_problem

torch.set_num_threads(1)

F64 = dict(dtype=np.float64)


def _stacked_problems(seed=0, B=4, N=10, **kw):
    """tests/test_frontend.py::test_solve_problems_stacked_matches_individual's batch."""
    f_fn = double_integrator_f_fx_fu_fn()
    rng = np.random.default_rng(seed)
    return [dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (N, 1, 1)),
                 R=np.tile(0.1 * np.eye(1), (N, 1, 1)), x0=rng.normal(size=2),
                 max_it=10, res_tol=1e-7, solver_settings=dict(F64), **kw)
            for _ in range(B)]


def test_stacked_route_matches_jax():
    problems = _stacked_problems()
    out_t = pmpc_tpu_torch.solve_problems(problems, device="cpu")
    out_j = pmpc_tpu.solve_problems(problems, verbose=False)
    assert len(out_t) == 4
    for i, ((X, U, d), (Xj, Uj, dj)) in enumerate(zip(out_t, out_j)):
        np.testing.assert_allclose(U, Uj, atol=1e-7, rtol=0)
        np.testing.assert_allclose(X, Xj, atol=1e-7, rtol=0)
        assert X.shape == (11, 2) and d["batch_index"] == i
        assert len(d["hist"]) == len(dj["hist"])
    # one stacked solve, each problem its own particle: the same as alone
    X1, U1, _ = pmpc_tpu_torch.solve(**dict(problems[1], verbose=False, device="cpu"))
    np.testing.assert_allclose(out_t[1][1], U1, atol=1e-7, rtol=0)
    # split=False: the stacked arrays
    (Xs, Us, ds), = batch.solve_problems(problems, split=False, device="cpu")
    assert Us.shape == (4, 10, 1)


def test_heterogeneous_fallback_and_array_settings():
    f_fn = double_integrator_f_fx_fu_fn()
    p1 = dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (10, 1, 1)),
              R=np.tile(np.eye(1), (10, 1, 1)), x0=np.ones(2), max_it=3,
              solver_settings=dict(F64))
    p2 = dict(p1, Q=np.tile(np.eye(2), (12, 1, 1)), R=np.tile(np.eye(1), (12, 1, 1)))
    assert not batch._homogeneous([p1, p2])
    out_t = batch.solve_problems([p1, p2], device="cpu")
    out_j = pmpc_tpu.solve_problems([p1, p2], verbose=False)
    assert out_t[0][0].shape == (11, 2) and out_t[1][0].shape == (13, 2)
    for (X, U, _), (Xj, Uj, _) in zip(out_t, out_j):
        np.testing.assert_allclose(U, Uj, atol=1e-7, rtol=0)
    # tests/test_frontend.py::test_solve_problems_array_valued_settings
    problems = _stacked_problems(seed=1, B=3, N=8)
    for p in problems:
        p.update(max_it=4, solver_settings=dict(F64, weights=np.array([1.0])))
    assert batch._homogeneous(problems)
    out_t = batch.solve_problems(problems, device="cpu")
    out_j = pmpc_tpu.solve_problems(problems, verbose=False)
    for (X, U, _), (Xj, Uj, _) in zip(out_t, out_j):
        np.testing.assert_allclose(U, Uj, atol=1e-7, rtol=0)
    datas = [d for (_, _, d) in out_t]
    assert datas[0] is not datas[1] and datas[0]["hist"] is not datas[1]["hist"]
    datas[0]["hist"][-1]["marker"] = 1
    assert "marker" not in datas[1]["hist"][-1]


def _di_torch(x, u):
    return torch.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]])


def _di_jax(x, u):
    return jnp.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]])


def _fused_pair(base, step_t, step_j):
    """The same problems with the port's and the JAX package's protocol
    callbacks."""
    ft = pmpc_tpu_torch.make_f_fx_fu_fn(step_t, device="cpu")
    fj = pmpc_tpu.make_f_fx_fu_fn(step_j)
    return [dict(p, f_fx_fu_fn=ft) for p in base], [dict(p, f_fx_fu_fn=fj) for p in base]


def _hold_fused(out_t, out_j, tol=1e-6):
    for (X, U, d), (Xj, Uj, dj) in zip(out_t, out_j):
        np.testing.assert_allclose(U, Uj, atol=tol, rtol=0)
        np.testing.assert_allclose(X, Xj, atol=tol, rtol=0)
        assert d["fused"] and U.dtype == np.float64
        for key in ("iters", "converged", "batch_index"):
            assert d[key] == dj[key], (key, d[key], dj[key])


@pytest.mark.parametrize("bounded", [True, False])
def test_fused_route_matches_jax(bounded):
    """tests/test_frontend.py::test_solve_problems_fused_matches_host's batch."""
    N, udim = 10, 1
    rng = np.random.default_rng(1)
    box = dict(u_l=-np.ones((N, udim)), u_u=np.ones((N, udim))) if bounded else {}
    base = [dict(Q=np.tile(np.eye(2), (N, 1, 1)), R=np.tile(0.1 * np.eye(udim), (N, 1, 1)),
                 x0=rng.normal(size=2), max_it=12, res_tol=1e-5,
                 solver_settings=dict(F64), **box) for _ in range(3)]
    pt, pj = _fused_pair(base, _di_torch, _di_jax)
    out_t = pmpc_tpu_torch.solve_problems(pt, fused=True, device="cpu")
    _hold_fused(out_t, pmpc_tpu.solve_problems(pj, fused=True))
    # unbounded, the prox terms leave the residual at ~3e-5 after 12 iterations
    assert all(d["converged"] == bounded for _, _, d in out_t)
    # the fused route against the port's own host route
    for (_, U, _), (_, Uh, _) in zip(out_t, batch.solve_problems(pt, device="cpu")):
        np.testing.assert_allclose(U, Uh, atol=1e-5, rtol=0)
    (X, U, d), = batch.solve_problems(pt, fused=True, split=False, device="cpu")
    assert U.shape == (3, N, udim) and d["resid_particle"].shape == (3,)


def test_fused_unicycle_with_cones_matches_jax():
    """The unicycle (the fixtures' JAX step and the port's `dubins`) with a
    box and identical u_soc_r cones: the fused box-and-cone program, B = 4."""
    N, xdim, udim = 8, 4, 2
    rng = np.random.default_rng(7)
    base = [dict(Q=np.tile(np.eye(xdim), (N, 1, 1)),
                 R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
                 x0=np.ones(xdim) + 0.1 * rng.normal(size=xdim),
                 u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)), max_it=15, res_tol=1e-6,
                 solver_settings=dict(F64, u_soc_r=np.full(N, 0.8), ipm_iters=40))
            for _ in range(4)]
    pt, pj = _fused_pair(base, dubins, unicycle_step)
    out_t = pmpc_tpu_torch.solve_problems(pt, fused=True, device="cpu")
    _hold_fused(out_t, pmpc_tpu.solve_problems(pj, fused=True))
    for X, U, d in out_t:
        assert np.linalg.norm(U, axis=-1).max() <= 0.8 + 1e-6


def test_cone_features_go_to_the_cone_batcher(monkeypatch):
    """fused=True with extra_cstrs: `solve_problems_cone` on the caller's
    device, its results returned as they are."""
    M, N, xdim, udim, Nc = 2, 6, 4, 2, 2
    probs = [dict(_mk_problem(i, M=M, N=N), f_fx_fu_fn=pmpc_tpu_torch.make_f_fx_fu_fn(
        dubins, device="cpu"), solver_settings=dict(
        F64, Nc=Nc, extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.2)])) for i in range(2)]
    seen = {}
    real = conebatch.solve_problems_cone

    def spy(problems, split=True, device=None, **kw):
        seen["device"] = device
        return real(problems, split=split, device=device, **kw)

    monkeypatch.setattr(conebatch, "solve_problems_cone", spy)
    out = batch.solve_problems(probs, fused=True, device="cpu")
    assert seen["device"] == "cpu"
    assert all(d["fused_cone"] and d["converged"] for _, _, d in out)
    for X, U, d in out:
        assert U[0, 0].sum() <= 0.2 + 1e-5


def test_refusals_with_the_jax_messages(monkeypatch):
    """tests/test_frontend.py::test_solve_problems_fused_rejects_unsupported."""
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(
        lambda x, u: x + 0.1 * torch.cat([u, u]), device="cpu")
    p = dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (5, 1, 1)),
             R=np.tile(np.eye(1), (5, 1, 1)), x0=np.ones(2),
             solver_settings=dict(diff_cost_fn=lambda X, U: 0.0))
    with pytest.raises(ValueError, match="not support"):
        batch.solve_problems([p, p], fused=True, device="cpu")
    with pytest.raises(ValueError, match="not support"):
        batch.solve_problems([dict(p, solver_settings=dict(method="riccati"))] * 2,
                             fused=True, device="cpu")
    p2 = dict(p, solver_settings=None)
    p2["f_fx_fu_fn"] = lambda X, U: (np.zeros((5, 2)), np.zeros((5, 2, 2)),
                                     np.zeros((5, 2, 1)))
    with pytest.raises(ValueError, match="dynamics protocol"):
        batch.solve_problems([p2, p2], fused=True, device="cpu")
    p3 = dict(p2, f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (6, 1, 1)),
              R=np.tile(np.eye(1), (6, 1, 1)))
    with pytest.raises(ValueError, match="homogeneous"):
        batch.solve_problems([p2 | dict(f_fx_fu_fn=f_fn), p3], fused=True, device="cpu")
    assert batch.solve_problems([]) == []
    # without a device every route goes to the card, which is not here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = dict(p2, f_fx_fu_fn=f_fn)
    for fused in (True, False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch.solve_problems([q, q], fused=fused)


@pytest.mark.parametrize("args", [["--N", "6", "--M", "2", "--Nc", "1", "--max-it", "2",
                                   "--bounded", "--soc", "--batch", "3"],
                                  ["--N", "6", "--max-it", "2", "--bounded", "--host"]])
def test_warmup_cli(args):
    """The twin of tests/test_frontend.py::test_warmup_cli_smoke on the CPU:
    the fused path over a batch of scenarios, then the host loop."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "pmpc_tpu_torch.warmup", *args, "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=root,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("warm (")
