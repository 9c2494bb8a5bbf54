"""The port's `solvers.dispatch.affine_solve_np` against the JAX package's on
every route, f64, on the CPU, on one `oracle.random_problem` subproblem
(M = 2, N = 6, Nc = 2, xdim = 3, udim = 2).

(a) Every route of the JAX dispatcher that reaches the host IPM entry points
or an unconstrained solve: the box IPM (control and state boxes, one-sided
bounds, the default tolerances with the SCP-residual forcing, slew,
weights), linear extras on the arrow IPM under the logbarrier
central-path stop, the unconstrained condensed and Riccati solves, and the
Riccati IPM (boxes, state boxes, slew, weights; cones with linear extras,
by ``method="riccati"`` and by the auto-route at N >= ``riccati_auto_N``,
set to 4 here; logbarrier): U and X to 1e-8 with equal IPM iteration
counts and flags; the warm layout: each package's ``solver_state`` fed to
the other's next subproblem gives the same point. The routes that end in
a solver an earlier slice already held against the JAX one (the composed
cone programs: CVaR with weights, state SOC extras with ``Hf``, control
cones under squareplus and under logbarrier in ``cone_dtype`` f32 on
``cone_device``; the condensed and Riccati smooth Newton, the named smooth
solvers) are held on every input the dispatcher hands that solver, to
1e-12 (1e-5 in f32);
(b) the refusals raise the JAX package's `NotImplementedError` messages
word for word;
(c) the control cones with linear rows on the condensed cone route against
the JAX Riccati route, 1e-7 (the JAX condensed cone path at HEAD is red:
ROADMAP §3 R1, F5), and a ``diff_cost_fn`` routed to `barrier_solve_np`'s
L-BFGS as the JAX dispatcher routes it;
(d) `test_fuzz_dispatch`'s seeds 101-105 through the port, against
`tests/oracle.py` (its own bounds);
(e) ROADMAP §3 F5 follow-up, the twin of `test_extras::
test_stage_u_cone_extras_take_structured_route`: the detected stage cones
and linear rows take the structured route (the composed program is never
built), hold the cones and the row, and agree with the JAX composed route
(``extras_structured=False``) and with the port's composed route to 1e-6;
no composed fallback follows an ``ipm_failed`` there (R2, kept)."""

import numpy as np
import pytest
import torch

from pmpc_tpu.solvers.dispatch import affine_solve_np as j_affine
from pmpc_tpu_torch.solvers import compose as tcomp
from pmpc_tpu_torch.solvers.dispatch import affine_solve_np as t_affine

import oracle
import test_fuzz_dispatch

torch.set_num_threads(1)

M, N, NC, XDIM, UDIM = 2, 6, 2, 3, 2
KEYS = ["x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref"]
TIGHT = dict(ipm_iters=60, ipm_tol_exp=-10)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(11)
    p = oracle.random_problem(rng, M=M, N=N, xdim=XDIM, udim=UDIM)
    p["U_prev"] = np.clip(p["U_prev"], -0.3, 0.3)
    ub = 0.4 + 0.1 * rng.uniform(size=(M, N, UDIM))
    nc, nf = NC * UDIM, (N - NC) * UDIM
    n_full = nc + M * nf + M * N * XDIM
    # row 0: the first consensus controls' sum, bounded below its box; row 1:
    # a random row with 0.2 of room at zero controls (which every cone holds)
    G = np.zeros((2, n_full))
    G[0, :UDIM] = 1.0
    G[1] = 0.5 * rng.normal(size=n_full) * (rng.uniform(size=n_full) < 0.4)
    x, X0 = p["x0"], []
    for j in range(N):  # the linearized dynamics at zero controls
        x = p["f"][:, j] - np.einsum("mij,mj->mi", p["fu"][:, j], p["U_prev"][:, j]) + (
            np.einsum("mij,mj->mi", p["fx"][:, j], x - p["X_prev"][:, j - 1]) if j else 0.0)
        X0.append(x)
    h = np.array([0.3, G[1, nc + M * nf:] @ np.stack(X0, 1).reshape(-1) + 0.2])
    ec_lin = (2, [], 0, G, np.zeros((2, 0)), h, np.zeros(n_full), np.zeros(0))
    # a keep-in cone on particle 1's last state (a state SOC: stays composed)
    Gq = np.zeros((3, n_full))
    Gq[1:, nc + M * nf + (M * N - 1) * XDIM:][:, :2] = -np.eye(2)
    ec_soc = (0, [3], 0, Gq, np.zeros((3, 0)), np.array([3.0, 0.0, 0.0]), np.zeros(n_full),
              np.zeros(0))
    # state boxes that bind but stay feasible: around the states of the
    # half-box solution and 30% of the way from the unboxed optimum to them
    args = [p[k] for k in KEYS]
    base = dict(reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1), slew_reg=np.zeros(M),
                slew_reg0=np.zeros(M), slew_um1=np.zeros((M, UDIM)), x_l=None, x_u=None,
                Nc=NC)
    X_half = t_affine(*args, **base, u_l=-0.5 * ub, u_u=0.5 * ub, settings=TIGHT,
                      device="cpu")[0]
    X_opt = t_affine(*args, **base, u_l=-ub, u_u=ub, settings=TIGHT, device="cpu")[0]
    Y = X_opt + 0.3 * (X_half - X_opt)
    x_box = (np.minimum(X_half, Y) - 1e-3, np.maximum(X_half, Y) + 1e-3)
    return dict(p=p, ub=ub, ec_lin=ec_lin, ec_soc=ec_soc, n_full=n_full, x_box=x_box)


def _kw(prob, bounds="u", slew=False):
    ub = prob["ub"]
    kw = dict(reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
              slew_reg=np.full(M, 0.4 if slew else 0.0),
              slew_reg0=np.full(M, 0.6 if slew else 0.0),
              slew_um1=np.full((M, UDIM), 0.2 if slew else 0.0),
              u_l=-ub if "u" in bounds else None, u_u=ub if "u" in bounds else None,
              x_l=None, x_u=None, Nc=NC)
    if bounds == "u_upper":
        kw["u_u"] = 0.25 * ub
    if "x" in bounds:
        kw["x_l"], kw["x_u"] = prob["x_box"]
    return kw


def _both(prob, settings, **kw):
    args = [prob["p"][k] for k in KEYS]
    out_j = j_affine(*args, **kw, settings=dict(settings))
    out_t = t_affine(*args, **kw, settings=dict(settings), device="cpu")
    return out_t, out_j


def _held(out_t, out_j, tol=1e-8):
    (Xt, Ut, dt), (Xj, Uj, dj) = out_t, out_j
    assert isinstance(Ut, np.ndarray) and Ut.shape == (M, N, UDIM) and Xt.shape == (M, N, XDIM)
    np.testing.assert_allclose(Ut, np.asarray(Uj), rtol=0, atol=tol)
    np.testing.assert_allclose(Xt, np.asarray(Xj), rtol=0, atol=10 * tol)
    for key in ("ipm_iters", "ipm_converged", "ipm_failed"):
        assert (key in dt) == (key in dj), key
        if key in dj:
            assert dt[key] == dj[key], (key, dt[key], dj[key])
    assert set(dt) == set(dj)


# (name, settings, _kw arguments, tolerance); "lin" stands for the two
# linear rows. Each case is one compiled JAX program: the routes' features
# share cases where the reference converges on them together
ROUTES = [
    ("box_ipm_state_boxes_slew_weights", dict(TIGHT, weights=[1.0, 3.0]),
     dict(bounds="ux", slew=True), 1e-8),
    ("box_ipm_one_sided_default_tolerance", dict(scp_residual=0.05), dict(bounds="u_upper"),
     1e-8),
    ("equality_condensed", dict(weights=[2.0, 1.0]), dict(bounds="", slew=True), 1e-8),
    ("equality_riccati", dict(method="riccati"), dict(bounds="", slew=True), 1e-8),
    ("linear_extras_logbarrier", dict(TIGHT, smooth_alpha=20.0, extra_cstrs="lin"), dict(),
     1e-8),
    ("riccati_boxes_state_boxes_slew_weights",
     dict(TIGHT, method="riccati", weights=[1.0, 3.0]), dict(bounds="ux", slew=True), 1e-8),
    ("riccati_cones_linear_extras", dict(TIGHT, method="riccati", u_soc_r=0.45,
                                         extra_cstrs="lin"), dict(), 1e-8),
    ("riccati_logbarrier_auto_route", dict(TIGHT, riccati_auto_N=4, smooth_alpha=20.0),
     dict(), 1e-8),
]


def _settings(prob, settings):
    st = dict(settings)
    if st.get("extra_cstrs") == "lin":
        st["extra_cstrs"] = [prob["ec_lin"]]
    elif st.get("extra_cstrs") == "soc":
        st["extra_cstrs"] = [prob["ec_lin"], prob["ec_soc"]]
    return st


@pytest.mark.parametrize("name,settings,kw,tol", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_matches_jax(prob, name, settings, kw, tol):
    st = _settings(prob, settings)
    out_t, out_j = _both(prob, st, **_kw(prob, **kw))
    _held(out_t, out_j, tol)
    if "ipm_iters" in out_j[2]:
        assert out_j[2]["ipm_converged"], out_j[2]
        taken = set(out_t[2]["solver_state"])
        assert taken == ({"riccati_warm"} if "riccati" in name else {"ipm_warm"})
    if name == "riccati_cones_linear_extras":
        # the auto-route at N >= riccati_auto_N takes the same solve
        auto = dict(st, riccati_auto_N=4)
        auto.pop("method")
        out_a = t_affine(*[prob["p"][k] for k in KEYS], **_kw(prob, **kw), settings=auto,
                         device="cpu")
        _held(out_a, out_t, 1e-12)
    if name == "riccati_cones_linear_extras":
        # the warm layout: each package's state warm-starts the other's
        # next subproblem (the JAX Riccati warm tuple holds JAX arrays; the
        # condensed one: tests/test_torch_host_scp.py)
        state_t, state_j = out_t[2]["solver_state"], out_j[2]["solver_state"]
        warm_j = _both(prob, dict(st, solver_state=state_t), **_kw(prob, **kw))[1]
        warm_t = _both(prob, dict(st, solver_state=state_j), **_kw(prob, **kw))[0]
        _held(warm_t, warm_j, tol)
        assert warm_t[2]["ipm_iters"] < out_t[2]["ipm_iters"]


# The routes that end in a solver an earlier slice held against the JAX one
# (tests/test_torch_barrier.py: `barrier_solve_np`, its Newton, L-BFGS and
# CVX / SQP, `riccati_barrier_solve_np`; tests/test_torch_compose.py:
# `composed_cone_solve` feature by feature) are held on what the dispatcher
# hands that solver: the JAX programs behind them compile for seconds each.
# One composed solve runs end to end in
# test_stage_u_cone_extras_take_structured_route.
SMOOTH = [
    ("squareplus_newton", dict(smooth_cstr="squareplus", smooth_alpha=8.0, smooth_beta=2.0,
                               weights=[1.0, 3.0]), dict(bounds="ux", slew=True),
     "barrier_solve_np"),
    ("logbarrier_sqp", dict(smooth_alpha=20.0, solver="SQP"), dict(), "barrier_solve_np"),
    ("riccati_squareplus", dict(method="riccati", smooth_cstr="squareplus", smooth_alpha=8.0,
                                weights=[1.0, 3.0]), dict(slew=True),
     "riccati_barrier_solve_np"),
]


def _same_input(a, b, key):
    if callable(b) and not isinstance(b, np.ndarray):
        assert a is b, key
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            _same_input(x, y, key)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), key
    elif b is None or isinstance(b, (str, bool, int, float)):
        assert a == b, (key, a, b)
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("name,settings,kw,fn", SMOOTH, ids=[c[0] for c in SMOOTH])
def test_smooth_route_hands_the_jax_inputs(prob, monkeypatch, name, settings, kw, fn):
    from pmpc_tpu.solvers import barrier as jbar
    from pmpc_tpu_torch.solvers import barrier as tbar

    calls = []

    def capture(*a, **k):
        calls.append((a, k))
        return np.zeros((M, N, XDIM)), np.zeros((M, N, UDIM)), {}

    monkeypatch.setattr(jbar, fn, capture)
    monkeypatch.setattr(tbar, fn, capture)
    _both(prob, settings, **_kw(prob, **kw))
    (at, kt), (aj, kj) = calls[1], calls[0]
    assert kt.pop("device").type == "cpu"
    _same_input(at, aj, "args")
    assert kt.keys() == kj.keys()
    for key in kj:
        _same_input(kt[key], kj[key], key)


COMPOSED = [
    ("cvar_weights_slew", dict(k=1, weights=[1.0, 2.0]), dict(slew=True)),
    ("state_soc_hf_cones_squareplus", dict(extra_cstrs="soc", Hf=0.2 * np.eye(M * XDIM),
                                          u_soc_r=np.full((M, N), 0.45),
                                          smooth_cstr="squareplus", smooth_beta=2.0),
     dict(bounds="ux")),
    ("cones_logbarrier_f32_cpu", dict(u_soc_r=np.full((M, N), 0.45), smooth_alpha=20.0,
                                      cone_dtype=np.float32, cone_device="cpu"), dict()),
]


@pytest.mark.parametrize("name,settings,kw", COMPOSED, ids=[c[0] for c in COMPOSED])
def test_composed_route_hands_the_jax_inputs(prob, monkeypatch, name, settings, kw):
    from pmpc_tpu.solvers import compose as jcomp

    calls = []

    def capture(cqp, **k):
        calls.append((cqp, k))
        return np.zeros((M, N, XDIM)), np.zeros((M, N, UDIM)), {}

    monkeypatch.setattr(jcomp, "composed_cone_solve", capture)
    monkeypatch.setattr(tcomp, "composed_cone_solve", capture)
    _both(prob, _settings(prob, settings), **_kw(prob, **kw))
    (cqp_t, kt), (cqp_j, kj) = calls[1], calls[0]
    dt = torch.float32 if "f32" in name else torch.float64
    tol = dict(rtol=1e-5, atol=1e-5) if "f32" in name else dict(rtol=0, atol=1e-12)
    for field in cqp_j._fields:
        a, b = getattr(cqp_t, field), getattr(cqp_j, field)
        if b is None:
            assert a is None, field
            continue
        b = np.asarray(b)
        assert a.dtype == dt and a.device.type == "cpu" and a.shape == (1,) + b.shape
        np.testing.assert_allclose(a[0].numpy(), b, **tol)
    assert set(kt) == set(kj)
    for key, b in kj.items():
        a = kt[key]
        if key == "cvar" and b is not None:
            for f in ("H_per", "q_per", "c_per"):
                np.testing.assert_allclose(getattr(a, f)[0].numpy(), np.asarray(getattr(b, f)),
                                           atol=1e-12)
            assert a.k == float(b.k) and a.eps == float(b.eps)
        elif key in ("H_extra", "q_extra") and b is not None:
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-12)
        elif key == "settings":
            assert a.keys() == b.keys()
        elif key == "extra_cstrs":
            assert len(a) == len(b) and all(x is y for x, y in zip(a, b))
        elif isinstance(b, np.ndarray) or b is None:
            assert (a is None and b is None) or np.array_equal(a, b)
        else:
            assert a == b, key


def test_refusals_raise_the_jax_messages(prob):
    cases = [
        dict(k=1, Hf=np.eye(M * XDIM)),
        dict(extra_cstrs=[prob["ec_soc"]], diff_cost_fn=lambda X, U: 0.0),
        dict(extra_cstrs=[prob["ec_soc"]], solver="LBFGS"),
        dict(u_soc_r=0.5, solver="CVX"),
        dict(u_soc_r=0.5, diff_cost_fn=lambda X, U: 0.0),
        dict(method="riccati", smooth_cstr="softplus"),
    ]
    args = [prob["p"][k] for k in KEYS]
    for settings in cases:
        with pytest.raises(NotImplementedError) as ej:
            j_affine(*args, **_kw(prob), settings=dict(settings))
        with pytest.raises(NotImplementedError) as et:
            t_affine(*args, **_kw(prob), settings=dict(settings), device="cpu")
        assert str(et.value) == str(ej.value)


def test_control_cones_take_the_condensed_cone_route(prob):
    """Without a method the cones (with the linear rows) take the condensed
    cone route, which follows the JAX package at `69d522d` (ROADMAP §3 R1,
    F5): held against the JAX Riccati route on the same subproblem (the
    program of the riccati_cones_linear_extras case above) and the port's
    own Riccati route, 1e-7."""
    args = [prob["p"][k] for k in KEYS]
    st = dict(TIGHT, u_soc_r=0.45, extra_cstrs=[prob["ec_lin"]])
    Xt, Ut, dt = t_affine(*args, **_kw(prob), settings=st, device="cpu")
    Xr, Ur, dr = t_affine(*args, **_kw(prob), settings=dict(st, method="riccati"),
                          device="cpu")
    Xj, Uj, dj = j_affine(*args, **_kw(prob), settings=dict(st, method="riccati"))
    assert "ipm_warm" in dt["solver_state"] and len(dt["solver_state"]["ipm_warm"]) == 6
    assert dt["ipm_converged"] and np.linalg.norm(Ut, axis=-1).max() <= 0.45 + 1e-7
    np.testing.assert_allclose(Ut, np.asarray(Uj), atol=1e-7)
    np.testing.assert_allclose(Ut, Ur, atol=1e-7)


def test_diff_cost_fn_takes_the_smooth_path(prob):
    """A ``diff_cost_fn`` (a torch callable here) goes to `barrier_solve_np`'s
    L-BFGS with the boxes logbarrier-smoothed at alpha 1e2, as in the JAX
    dispatcher: the same numbers as that call made directly. (The port's
    L-BFGS is not optax's, ROADMAP §3 F8: tests/test_torch_barrier.py holds
    it at the optimum.)"""
    from pmpc_tpu_torch.solvers.barrier import barrier_solve_np

    args = [prob["p"][k] for k in KEYS]
    cost = lambda X, U: 0.5 * (U ** 2).sum()
    kw = _kw(prob)
    st = dict(diff_cost_fn=cost, max_it=30)
    Xt, Ut, dt = t_affine(*args, **kw, settings=st, device="cpu")
    reg = tuple(kw[k] for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0", "slew_um1"))
    Xb, Ub, db = barrier_solve_np(tuple(args), reg, kw["u_l"], kw["u_u"], None, None, Nc=NC,
                                  method="logbarrier", alpha=1e2, beta=1.0, settings=st,
                                  extra_obj=cost, device="cpu")
    np.testing.assert_array_equal(Ut, Ub)
    assert dt["obj"] == db["obj"] and np.isfinite(dt["obj"])


@pytest.mark.parametrize("seed", range(101, 106))
def test_fuzz_consensus_qp_routes_against_the_oracle(seed, monkeypatch):
    monkeypatch.setattr(test_fuzz_dispatch, "affine_solve_np",
                        lambda *a, **k: t_affine(*a, **k, device="cpu"))
    test_fuzz_dispatch._run_case(seed)


def test_stage_u_cone_extras_take_structured_route(monkeypatch):
    """The port's twin of the JAX test of the same name (red at JAX HEAD,
    ROADMAP §3 R1): same instance, seed 33."""
    from test_extras import _u_norm_socs

    rng = np.random.default_rng(33)
    M_, N_, xdim, udim, Nc = 3, 8, 3, 2, 3
    p = oracle.random_problem(rng, M=M_, N=N_, xdim=xdim, udim=udim)
    umax = 0.55
    ec = _u_norm_socs(M_, N_, xdim, udim, Nc, umax)
    nc, nf = Nc * udim, (N_ - Nc) * udim
    n_full = nc + M_ * nf + M_ * N_ * xdim
    gl = np.zeros((1, n_full))
    gl[0, :udim] = 1.0
    ec_lin = (1, [], 0, gl, np.zeros((1, 0)), np.array([0.3]), np.zeros(n_full), np.zeros(0))
    args = [p[k] for k in KEYS]
    kw = dict(reg_x=np.full(M_, 1.0), reg_u=np.full(M_, 0.1), slew_reg=np.zeros(M_),
              slew_reg0=np.zeros(M_), slew_um1=np.zeros((M_, udim)),
              u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)
    st = dict(extra_cstrs=[ec, ec_lin], ipm_tol_exp=-10, ipm_iters=80)

    def boom(*a, **k):
        raise AssertionError("stage u-cone extras must not densify through the composed "
                             "cone path")

    with monkeypatch.context() as m:
        m.setattr(tcomp, "composed_cone_solve", boom)
        X, U, data = t_affine(*args, **kw, settings=st, device="cpu")
    assert data["ipm_converged"], data
    assert len(data["solver_state"]["ipm_warm"]) == 6  # cones and the row on the arrow IPM
    assert np.linalg.norm(U, axis=-1).max() <= umax + 1e-6
    assert U[:, 0, :].sum(axis=-1).max() <= 0.3 + 1e-6
    composed = dict(st, extras_structured=False)
    _, Uj, dj = j_affine(*args, **kw, settings=composed)
    _, Uc, dc = t_affine(*args, **kw, settings=composed, device="cpu")
    assert dj["ipm_converged"] and dc["ipm_converged"]
    np.testing.assert_allclose(U, np.asarray(Uj), atol=1e-6)
    np.testing.assert_allclose(U, Uc, atol=1e-6)
    # R2 (kept): a structured solve that reports ipm_failed is returned as
    # such, with no fallback to the composed program
    with monkeypatch.context() as m:
        m.setattr(tcomp, "composed_cone_solve", boom)
        _, _, bad = t_affine(*args, **kw, settings=dict(st, ipm_iters=1), device="cpu")
    assert not bad["ipm_converged"]
