"""The port's host SCP loop (`pmpc_tpu_torch.solve` / `scp_solve`) against the
JAX package's, f64, on the CPU.

(a) The loop alone: `tests/test_scp.py`'s cases through the JAX loop and the
port's, both on the port's subproblem solver (the JAX loop's
`affine_solve_np` replaced by the port's, which tests/test_torch_dispatch.py
holds against the JAX one; the JAX solvers' compiles would cost most of
this file's time), with the torch unicycle's callback: U and X to 1e-10
with equal SCP iteration counts: the Dubins car unconstrained, particles
with their own dynamics under consensus with weights, slew and an anchor,
one-sided bounds, the filters (AA, select), the ``data`` contract (keys,
``hist`` rows, ``sol_hist`` only under ``debug``), ``return_min_viol``, the
time limit's projection, the NaN contract, and the reject contract (a
subproblem reporting ``ipm_failed`` sets ``rejected_subproblem`` and keeps
the last accepted iterate, or gives (None, None, None) at iteration 0);
(b) the whole frontend against the whole JAX frontend, U to 1e-6 with equal
SCP and IPM iteration counts: the linear system (also against the dense
KKT oracle), the Dubins car with control boxes on the fixtures' callback
and on the port's torch callback (two device reads an SCP iteration: the
linearization and the subproblem's packed result), and a JAX
``solver_state`` warm-starting the port's next subproblem exactly as it
warm-starts the JAX one (1e-8, equal IPM counts);
(c) `tests/test_fuzz_paths.py` within the port: the host loop against the
fused solver `build_scp_solver` on seeds 200-204 (5e-5, that test's bound)
and the cone seeds 300-303 (1e-4, cones held);
(d) the serial batch and the f32 stall flag."""

import warnings

import numpy as np
import pytest
import torch

import pmpc_tpu
import pmpc_tpu_torch
from fixtures import dubins_f_fx_fu_fn, linear_f_fx_fu_fn
from pmpc_tpu.solvers import dispatch as jdisp
from pmpc_tpu_torch import scp as tscp
from pmpc_tpu_torch.flagship import dubins
from pmpc_tpu_torch.solvers import dispatch as tdisp
from pmpc_tpu_torch.torch_scp import build_scp_solver, make_scp_data

import oracle

torch.set_num_threads(1)

F64 = dict(dtype=np.float64)
HIST_KEYS = {"it", "elaps", "obj", "resid", "reg_x", "reg_u"}
TORCH_FN = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")


@pytest.fixture
def port_solver_under_jax(monkeypatch):
    """The JAX loop on the port's subproblem solver."""
    monkeypatch.setattr(jdisp, "affine_solve_np",
                        lambda *a, **k: tdisp.affine_solve_np(*a, **k, device="cpu"))


def _pair(f_fn, *args, **kw):
    """The same solve in both packages: (port, JAX)."""
    kw.setdefault("verbose", False)
    kw["solver_settings"] = dict(F64, **(kw.get("solver_settings") or {}))
    out_j = pmpc_tpu.solve(f_fn, *args, **kw)
    out_t = pmpc_tpu_torch.solve(f_fn, *args, device="cpu", **kw)
    return out_t, out_j


def _held(out_t, out_j, tol=1e-6):
    (Xt, Ut, dt), (Xj, Uj, dj) = out_t, out_j
    assert len(dt["hist"]) == len(dj["hist"])
    assert set(dt) == set(dj)
    np.testing.assert_allclose(Ut, Uj, atol=tol)
    np.testing.assert_allclose(Xt, Xj, atol=tol)
    for ht, hj in zip(dt["hist"], dj["hist"]):
        assert set(ht) == HIST_KEYS
        np.testing.assert_allclose(ht["resid"], hj["resid"], rtol=1e-5, atol=1e-9)
    its_t = [d.get("ipm_iters") for d in dt["solver_data"]]
    assert its_t == [d.get("ipm_iters") for d in dj["solver_data"]]


def _dubins(N, M=None):
    xdim, udim = 4, 2
    lead = (N,) if M is None else (M, N)
    Q = np.tile(np.eye(xdim), lead[:-1] + (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), lead[:-1] + (N, 1, 1))
    x0 = np.ones(xdim) if M is None else np.ones((M, xdim))
    return Q, R, x0


BOXED = dict(u_l=-np.ones((12, 2)), u_u=np.ones((12, 2)), reg_x=1.0, reg_u=0.1, max_it=12,
             res_tol=1e-5)


# ---- (a) the loop alone ---------------------------------------------------------

def test_loop_contracts_match_the_jax_loop(port_solver_under_jax):
    Q, R, x0 = _dubins(12)
    out = _pair(TORCH_FN, Q, R, x0, reg_x=1.0, reg_u=0.1, max_it=12, res_tol=1e-5, debug=True)
    _held(*out, tol=1e-10)
    X, U, data = out[0]
    assert X.shape == (13, 4) and U.shape == (12, 2)  # unbatched in, unbatched out
    assert len(data["sol_hist"]) == len(data["hist"]) and "f32_stall_suspected" not in data
    assert "sol_hist" not in _pair(TORCH_FN, Q, R, x0, max_it=2)[0][2]
    # time_limit projects one iteration ahead: a limit below one iteration's
    # time stops after the first; the min-violation point is kept
    X1, U1, d1 = pmpc_tpu_torch.solve(TORCH_FN, Q, R, x0, max_it=50, res_tol=0.0,
                                      time_limit=1e-9, return_min_viol=True, verbose=False,
                                      solver_settings=F64, device="cpu")
    assert len(d1["hist"]) == 1 and "min_viol_sol" in d1


def test_consensus_particles_with_their_own_dynamics_match_the_jax_loop(
        port_solver_under_jax):
    M, N, Nc = 3, 10, 4
    rng = np.random.default_rng(3)
    params = [(1.0 + 0.1 * rng.normal(), 1.0 + 0.1 * rng.normal(), 0.3) for _ in range(M)]
    fns = [pmpc_tpu_torch.make_f_fx_fu_fn(lambda x, u, p=p: dubins(x, u, p), device="cpu")
           for p in params]

    def f_fx_fu_fn(X, U):
        outs = [fn(X[i], U[i]) for i, fn in enumerate(fns)]
        return tuple(np.stack([o[k] for o in outs]) for k in range(3))

    Q, R, x0 = _dubins(N, M)
    out = _pair(f_fx_fu_fn, Q, R, x0, reg_x=1.0, reg_u=0.1, max_it=25, res_tol=1e-6,
                slew_rate=0.3, u0_slew=np.array([0.1, -0.2]),
                solver_settings=dict(Nc=Nc, weights=[1.0, 2.0, 1.0]))
    _held(*out, tol=1e-10)
    U = out[0][1]
    assert np.ptp(U[:, :Nc, :], axis=0).max() < 1e-8
    assert np.ptp(U[:, Nc:, :], axis=0).max() > 1e-6


def test_one_sided_bounds_and_filters_match_the_jax_loop(port_solver_under_jax):
    N, xdim, udim = 10, 4, 2
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    Q[:, :2, :2] *= 50.0
    R = np.tile(1e-3 * np.eye(udim), (N, 1, 1))
    X_ref = np.tile(np.array([5.0, 5.0, 0.0, 0.0]), (N, 1))
    kw = dict(X_ref=X_ref, reg_x=1.0, reg_u=0.1, max_it=8, res_tol=1e-6)
    out = _pair(TORCH_FN, Q, R, np.zeros(xdim), u_u=0.3 * np.ones((N, udim)), **kw)
    _held(*out, tol=1e-10)
    assert out[0][1].max() <= 0.3 + 1e-6
    out = _pair(TORCH_FN, Q, R, np.zeros(xdim), u_l=-0.1 * np.ones((N, udim)), **kw)
    _held(*out, tol=1e-10)
    assert out[0][1].min() >= -0.1 - 1e-6
    for fm in ("AA", "select"):
        _held(*_pair(TORCH_FN, Q, R, np.zeros(xdim), **dict(kw, filter_method=fm,
                                                          filter_it0=2, filter_window=3)),
              tol=1e-10)


def test_nan_and_reject_contracts_match_the_jax_loop(monkeypatch):
    N, xdim, udim = 5, 2, 1

    def bad_fn(X, U):
        return (np.full(X.shape, np.nan), np.zeros(X.shape + (xdim,)),
                np.zeros(X.shape + (udim,)))

    Q, R = np.tile(np.eye(xdim), (N, 1, 1)), np.tile(np.eye(udim), (N, 1, 1))
    assert pmpc_tpu_torch.solve(bad_fn, Q, R, np.ones(xdim), max_it=2, verbose=False,
                                device="cpu") == (None, None, None)

    # a subproblem solver that reports a hard failure at the k-th call: the
    # port's solver in both loops
    f_fn = linear_f_fx_fu_fn(np.eye(xdim), np.ones((xdim, udim)))
    real = tdisp.affine_solve_np
    for fail_at in (0, 2):
        outs = []
        for mod, pkg, kw in ((tdisp, pmpc_tpu_torch, dict(device="cpu")),
                             (jdisp, pmpc_tpu, {})):
            calls = []

            def failing(*a, _calls=calls, **k):
                X, U, d = real(*a, **dict(k, device="cpu"))
                _calls.append(1)
                return X, U, dict(d, ipm_failed=len(_calls) == fail_at + 1)

            with monkeypatch.context() as m:
                m.setattr(mod, "affine_solve_np", failing)
                outs.append(pkg.solve(f_fn, Q, R, np.ones(xdim), max_it=5, res_tol=0.0,
                                      verbose=False, u_u=np.ones((N, udim)),
                                      solver_settings=F64, **kw))
        if fail_at == 0:
            assert outs[0] == (None, None, None) and outs[1] == (None, None, None)
        else:
            _held(*outs, tol=1e-10)
            assert outs[0][2]["rejected_subproblem"] and len(outs[0][2]["hist"]) == fail_at


# ---- (b) the whole frontend against the whole JAX frontend --------------------------

def test_linear_system_matches_jax_and_the_oracle():
    rng = np.random.default_rng(0)
    M, N, xdim, udim = 2, 10, 3, 2
    A = 0.9 * np.eye(xdim) + 0.05 * rng.normal(size=(xdim, xdim))
    B = rng.normal(size=(xdim, udim))
    f_fn = linear_f_fx_fu_fn(A, B)
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(0.1 * np.eye(udim), (M, N, 1, 1))
    x0 = rng.normal(size=(M, xdim))
    X_ref = rng.normal(size=(M, N, xdim))
    U_ref = np.zeros((M, N, udim))
    out_t, out_j = _pair(f_fn, Q, R, x0, X_ref=X_ref, U_ref=U_ref, reg_x=0.0, reg_u=0.0,
                         max_it=2, res_tol=1e-9, solver_settings=dict(Nc=0))
    _held(out_t, out_j, 1e-10)
    X, U, _ = out_t
    X_ = np.concatenate([x0[:, None, :], X_ref[:, :-1, :]], axis=1)
    f, fx, fu = f_fn(X_, U_ref)
    p = dict(x0=x0, f=f, fx=fx, fu=fu, X_prev=X_ref, U_prev=U_ref, Q=Q, R=R, X_ref=X_ref,
             U_ref=U_ref)
    P, q = oracle.build_Pq(**p, reg_x=0.0, reg_u=0.0, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=0)
    Ab, bb = oracle.build_Ab(x0, f, fx, fu, X_ref, U_ref, 0)
    X_o, U_o = oracle.split_z(oracle.solve_eq_kkt(P, q, Ab, bb), N, xdim, udim, M, 0)
    np.testing.assert_allclose(U, U_o, atol=1e-6)
    np.testing.assert_allclose(X[:, 1:], X_o, atol=1e-6)


def test_boxed_dubins_matches_jax_on_either_callback(monkeypatch):
    """The Dubins car with control boxes (the JAX IPM warm-started across SCP
    iterations in both packages) on the fixtures' JAX callback, then on the
    port's torch callback against the same JAX solve."""
    from pmpc_tpu_torch import utils as tutils

    Q, R, x0 = _dubins(12)
    out_t, out_j = _pair(dubins_f_fx_fu_fn(), Q, R, x0, **BOXED)
    _held(out_t, out_j)
    U = out_t[1]
    assert np.abs(U).max() <= 1.0 + 1e-6 and (np.abs(np.abs(U) - 1.0) < 1e-6).any()
    assert all("ipm_warm" in d["solver_state"] for d in out_t[2]["solver_data"])
    reads, real = [], tutils.to_host
    count = lambda ts: reads.append(len(ts)) or real(ts)
    monkeypatch.setattr("pmpc_tpu_torch.dynamics.to_host", count)
    monkeypatch.setattr("pmpc_tpu_torch.solvers.ipm.to_host", count)
    Xt, Ut, dt = pmpc_tpu_torch.solve(TORCH_FN, Q, R, x0, device="cpu", verbose=False,
                                      solver_settings=F64, **BOXED)
    assert reads == [3, 10] * len(dt["hist"])
    assert len(dt["hist"]) == len(out_j[2]["hist"])
    np.testing.assert_allclose(Ut, out_j[1], atol=1e-6)


def test_a_jax_solver_state_warm_starts_the_port():
    f_fn = dubins_f_fx_fu_fn()
    Q, R, x0 = _dubins(12)
    kw = dict(BOXED, verbose=False, solver_settings=F64)
    X1, U1, d1 = pmpc_tpu.solve(f_fn, Q, R, x0, **dict(kw, max_it=1))
    # (the Riccati warm tuple from JAX: tests/test_torch_dispatch.py)
    nxt = dict(kw, X_prev=X1[1:], U_prev=U1, solver_state=d1["solver_data"][-1]["solver_state"],
               max_it=1)
    Xj, Uj, dj = pmpc_tpu.solve(f_fn, Q, R, x0, **nxt)
    Xt, Ut, dt = pmpc_tpu_torch.solve(f_fn, Q, R, x0, device="cpu", **nxt)
    np.testing.assert_allclose(Ut, Uj, atol=1e-8)
    it_t, it_j = dt["solver_data"][0]["ipm_iters"], dj["solver_data"][0]["ipm_iters"]
    assert it_t == it_j < d1["solver_data"][0]["ipm_iters"], (it_t, it_j)


def test_problem_dicts_and_the_serial_batch():
    p = pmpc_tpu_torch.Problem(N=12, xdim=4, udim=2)
    p.f_fx_fu_fn = TORCH_FN
    p.x0 = np.ones(4)
    Xp, Up, _ = pmpc_tpu_torch.solve_with_a_dict(dict(p, verbose=False, max_it=3,
                                                      device="cpu"))
    assert Xp.shape == (13, 4) and np.isfinite(Up).all()
    # the serial batch: each problem's own solve, with the keywords applied to all
    p2 = dict(p, x0=0.5 * np.ones(4))
    outs = tscp.solve_problems_serial([dict(p), p2], max_it=3, device="cpu")
    for (Xs, Us, _), q in zip(outs, (dict(p), p2)):
        np.testing.assert_array_equal(
            Us, pmpc_tpu_torch.solve(**dict(q, verbose=False, max_it=3, device="cpu"))[1])


# ---- (c) host against fused within the port ------------------------------------------

def _fuzz_step(x, u):
    dt = 0.2
    return torch.stack([x[0] + dt * x[2] * torch.cos(x[3]), x[1] + dt * x[2] * torch.sin(x[3]),
                        x[2] + dt * u[0], x[3] + dt * u[1]])


def _host_vs_fused(seed, soc):
    """`tests/test_fuzz_paths.py`'s draws, through the port's two entry points."""
    rng = np.random.default_rng(seed)
    M = int(rng.integers(1, 3 if soc else 4))
    N = int(rng.integers(4, 9 if soc else 10))
    Nc = int(rng.integers(0, 3 if soc else min(N, 4)))
    xdim, udim = 4, 2
    max_it = int(rng.integers(2, 4 if soc else 5))
    if soc:
        r = float(rng.uniform(0.3, 0.8))
        bounds, use_slew, use_slew0 = "u", False, False
    else:
        bounds = str(rng.choice(["none", "u", "u_onesided", "ux"]))
        use_slew, use_slew0 = bool(rng.integers(2)), bool(rng.integers(2))
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim)) + 0.1 * rng.normal(size=(M, xdim))
    X_ref = None if soc else 0.3 * rng.normal(size=(M, N, xdim))
    u_l = u_u = x_l = x_u = None
    if bounds in ("u", "ux"):
        u_l, u_u = -(1.0 if soc else 0.6) * np.ones((M, N, udim)), \
            (1.0 if soc else 0.6) * np.ones((M, N, udim))
    elif bounds == "u_onesided":
        u_u = 0.5 * np.ones((M, N, udim))
    if bounds == "ux":
        x_l, x_u = -5.0 * np.ones((M, N, xdim)), 5.0 * np.ones((M, N, xdim))
    slew_rate = 0.4 if use_slew else 0.0
    u0_slew = 0.2 * rng.normal(size=udim) if use_slew0 else None
    iters = 80 if soc else 60
    settings = dict(F64, Nc=Nc, ipm_tol_exp=-10, ipm_iters=iters)
    fused_kw = {}
    if soc:
        settings["u_soc_r"] = np.full((M, N), r)
        fused_kw = dict(has_u_soc=True, u_soc_r=np.full((M, N), r))
    Xh, Uh, dh = pmpc_tpu_torch.solve(
        pmpc_tpu_torch.make_f_fx_fu_fn(_fuzz_step, device="cpu"), Q, R, x0, X_ref=X_ref,
        u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u, reg_x=1.0, reg_u=0.1, slew_rate=slew_rate,
        u0_slew=u0_slew, max_it=max_it, res_tol=0.0, verbose=False, solver_settings=settings,
        device="cpu")
    assert Xh is not None
    data = make_scp_data(
        x0[None], Q[None], R[None], X_ref=None if X_ref is None else X_ref[None],
        reg_x=1.0, reg_u=0.1, slew_reg=slew_rate,
        slew_reg0=slew_rate if u0_slew is not None else 0.0,
        slew_um1=np.tile(u0_slew, (M, 1)) if u0_slew is not None else None,
        u_l=None if u_l is None else u_l[None], u_u=None if u_u is None else u_u[None],
        x_l=None if x_l is None else x_l[None], x_u=None if x_u is None else x_u[None],
        dtype=torch.float64, device="cpu",
        **{k: v[None] for k, v in fused_kw.items() if k == "u_soc_r"})
    solver = build_scp_solver(
        _fuzz_step, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=max_it, res_tol=0.0,
        has_u_bounds=u_l is not None or u_u is not None, has_x_bounds=x_l is not None,
        ipm_iters=iters, ipm_tol_exp=-10, adaptive_tol=False,
        **{k: v for k, v in fused_kw.items() if k != "u_soc_r"})
    _, Uf, _ = solver(data)
    dU = float(np.abs(Uf[0].numpy() - Uh).max())
    assert dU < (1e-4 if soc else 5e-5), (seed, M, N, Nc, bounds, dU)
    if soc:
        assert np.linalg.norm(Uh, axis=-1).max() <= r + 1e-6


@pytest.mark.parametrize("seed", list(range(200, 205)) + list(range(300, 304)))
def test_host_vs_fused_paths_agree(seed):
    _host_vs_fused(seed, soc=seed >= 300)


def test_f32_stall_flag():
    data = dict(hist=[dict(resid=r) for r in (5e-3, 4.9e-3, 4.85e-3, 4.8e-3)])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tscp._flag_f32_stall(data, dict(dtype=torch.float32), 4.8e-3, 1e-5)
    assert data["f32_stall_suspected"] and any("float32" in str(x.message) for x in w)
    quiet = dict(hist=[dict(resid=r) for r in (1e-2, 5e-3, 4.9e-3, 4.8e-3)])
    tscp._flag_f32_stall(quiet, dict(dtype=np.float64), 4.8e-3, 1e-5)
    assert "f32_stall_suspected" not in quiet
