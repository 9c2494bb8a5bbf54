"""`pmpc_tpu_torch.solvers.riccati_ipm` against the JAX package, f64, CPU.

The sweeps (factor, linear backward / forward, consensus solve, the hand
adjoint against `jax.grad`) to 1e-10 and the IPM (`riccati_ipm_solve_scp`,
linear extra rows included) to 1e-8 in X and U with equal iteration counts
and flags, each over B = 2 lanes of different `oracle.random_problem` data
against `jax.vmap` of the JAX function; the numpy frontend
`riccati_ipm_solve_np` against the JAX one to 1e-8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.solvers import riccati_ipm as jipm
from pmpc_tpu_torch.convert import warm_from_numpy
from pmpc_tpu_torch.solvers import riccati_ipm as tipm
from test_torch_riccati import B, KEYS, SHAPES, close, problem, stage_terms, tt

torch.set_num_threads(1)

XDIM, UDIM = 4, 2
KAPPA = 1e-7
# (M, N, Nc, slew): every shape plain, two of them slew-augmented
SWEEP_CASES = [s + (False,) for s in SHAPES] + [(3, 10, 3, True), (1, 12, 0, True)]


def _sweep_inputs(seed, M, N, Nc, slew):
    """Stage data (JAX arrays, (B, M, ...)) plus a weighted Rt and random
    linear terms for the sweeps."""
    p = problem(seed, M, N)
    x0, c, A, Bm, Qt, xt, Rt, ut = stage_terms(p, slew)
    rng = np.random.default_rng(seed + 1)
    Rt_eff = Rt + jnp.asarray(rng.uniform(0.0, 3.0, size=(B, M, N, UDIM, 1))) * jnp.eye(UDIM)
    nct = max(Nc * UDIM, 1)
    extra = dict(utf=rng.normal(size=(B, M, N, UDIM)), utc=rng.normal(size=(B, M, N, UDIM)),
                 wc=rng.uniform(0.1, 2.0, size=(B, nct)), theta_lin=rng.normal(size=(B, nct)))
    return (x0, c, A, Bm, Qt, xt, Rt_eff, ut), {k: jnp.asarray(v) for k, v in extra.items()}


def _jax_factor(A, Bm, Qt, Rt_eff, N, Nc, xdim):
    Es, free, _, maskc = jipm._selectors(N, Nc, UDIM, A.dtype)
    fac = jax.vmap(lambda a, b, q, r: jipm.riccati_factor(a, b, q, r, Es, free, xdim,
                                                          kappa=KAPPA))(A, Bm, Qt, Rt_eff)
    return fac, Es, free, maskc


@pytest.mark.parametrize("M,N,Nc,slew", SWEEP_CASES)
def test_factor_and_consensus_solve_match_vmapped_jax(M, N, Nc, slew):
    (x0, c, A, Bm, Qt, xt, Rt_eff, ut), ex = _sweep_inputs(40 + M + N, M, N, Nc, slew)
    xdim = x0.shape[-1]
    fac_r, Es, free, maskc_r = _jax_factor(A, Bm, Qt, Rt_eff, N, Nc, xdim)
    t = lambda a: tt(np.asarray(a))
    fac = tipm.riccati_factor(t(A), t(Bm), t(Qt), t(Rt_eff), Nc, xdim, kappa=KAPPA)
    for name in fac._fields:  # every field, the consensus stages' L included
        close(getattr(fac, name), getattr(fac_r, name))
    Es_t, free_t, nct, maskc = tipm._selectors(N, Nc, UDIM, torch.float64)
    close(Es_t, Es), close(free_t, free), close(maskc, maskc_r)

    # the linear backward sweep and the forward rollout against that factor
    p0_r, k_r = jax.vmap(jax.vmap(
        lambda Aa, Mn, L, Huy, b, c_, xt_, utf, utc: jipm._lin_backward_one(
            Aa, Mn, L, Huy, b, c_, xt_, utf, utc, Es, free, xdim)))(
        fac_r.Aa, fac_r.Mn, fac_r.L, fac_r.Huy, Bm, c, xt, ex["utf"], ex["utc"])
    p0, k = tipm._lin_backward(fac, t(Bm), t(c), t(xt), t(ex["utf"]), t(ex["utc"]), Nc)
    close(p0, p0_r), close(k, k_r)
    theta = ex["theta_lin"]
    X_r, U_r = jax.vmap(lambda th, *a: jax.vmap(
        lambda x0_, c_, A_, B_, K_, k_: jipm._forward_one(x0_, c_, A_, B_, K_, k_, Es, free, th)
    )(*a))(theta, x0, c, A, Bm, fac_r.K, k_r)
    X, U = tipm._forward(t(x0), t(c), t(A), t(Bm), fac.K, k, t(theta), Nc)
    close(X, X_r), close(U, U_r)

    # the whole solve: backward sweeps, theta Schur reduction, rollouts
    ref = jax.vmap(lambda f_, b, c_, x0_, xt_, utf, utc, wc, tl: jipm._consensus_solve(
        f_, b, c_, x0_, xt_, utf, utc, wc, tl, Es, free, maskc_r, xdim, KAPPA))(
        fac_r, Bm, c, x0, xt, ex["utf"], ex["utc"], ex["wc"], ex["theta_lin"])
    out = tipm._consensus_solve(fac, t(Bm), t(c), t(x0), t(xt), t(ex["utf"]), t(ex["utc"]),
                                t(ex["wc"]), t(ex["theta_lin"]), Nc, maskc, xdim, KAPPA)
    for a, b in zip(out, ref):
        close(a, b)
    if not Nc:  # the dead theta entry is pinned to 0
        assert out[0].shape == (B, 1) and (out[0] == 0).all()


@pytest.mark.parametrize("M,N,Nc,slew", SWEEP_CASES)
def test_hand_adjoint_matches_jax_grad(M, N, Nc, slew):
    (x0, c, A, Bm, Qt, xt, Rt, ut), _ = _sweep_inputs(60 + M + N, M, N, Nc, slew)
    rng = np.random.default_rng(M + N)
    nct, nfu = max(Nc * UDIM, 1), (N - Nc) * UDIM
    theta, uf = rng.normal(size=(B, nct)), rng.normal(size=(B, M, nfu))
    maskc_r = jipm._selectors(N, Nc, UDIM, jnp.float64)[3]
    gth_r, gf_r = jax.vmap(lambda *a: jipm._stage_obj_grad(*a, Nc, maskc_r))(
        jnp.asarray(theta), jnp.asarray(uf), x0, c, A, Bm, Qt, xt, Rt, ut)
    maskc = tipm._selectors(N, Nc, UDIM, torch.float64)[3]
    gth, gf = tipm._stage_obj_grad(tt(theta), tt(uf), *(tt(np.asarray(a)) for a in (
        x0, c, A, Bm, Qt, xt, Rt, ut)), Nc, maskc)
    close(gth, gth_r), close(gf, gf_r)


# ---- the IPM ----------------------------------------------------------------

def _solve_both(p, Nc, u_box=0.5, slew=False, x_l=None, x_u=None, warm=None,
                tol_dynamic=None, lanes=slice(None), ex_G=None, ex_h=None, **kw):
    """`riccati_ipm_solve_scp` of both packages on problem ``p`` (B, M, ...):
    ((X, U, stats) torch, (X, U, stats) JAX under `jax.vmap`). ``lanes``
    cuts the torch call to some lanes."""
    kw = dict(dict(iters=40, tol_exp=-10), **kw)
    shape = p["U_prev"].shape
    arrs = dict(u_l=np.full(shape, -u_box), u_u=np.full(shape, u_box))
    if slew:
        arrs.update({k: p[k] for k in ("slew_reg", "slew_reg0", "slew_um1")})
    if x_l is not None:
        arrs.update(x_l=x_l, x_u=x_u)
    if tol_dynamic is not None:
        arrs["tol_dynamic"] = np.asarray(tol_dynamic)
    if ex_G is not None:
        arrs.update(ex_G=ex_G, ex_h=ex_h)
    base = [p[k] for k in KEYS + ["reg_x", "reg_u"]]
    jwarm = None if warm is None else tuple(jnp.asarray(a) for a in warm)
    ref = jax.vmap(lambda a, d, w: jipm.riccati_ipm_solve_scp(*a, Nc=Nc, warm=w, **d, **kw))(
        [jnp.asarray(a) for a in base], {k: jnp.asarray(v) for k, v in arrs.items()}, jwarm)
    twarm = warm_from_numpy(warm, "cpu", torch.float64)
    if twarm is not None:
        twarm = tuple(a[lanes] for a in twarm)
    out = tipm.riccati_ipm_solve_scp(
        *(tt(a[lanes]) for a in base), Nc=Nc, warm=twarm,
        **{k: tt(v[lanes]) for k, v in arrs.items()}, **kw)
    return out, ref


def _hold(out, ref, lanes=slice(None), tol=1e-8):
    (X, U, st), (X_r, U_r, st_r) = out, ref
    close(X, np.asarray(X_r)[lanes], tol)
    close(U, np.asarray(U_r)[lanes], tol)
    for key in ("iters", "converged", "failed"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(st_r[key])[lanes])
    for key in ("theta", "uf", "s", "lam"):  # the warm tuple's layout
        assert st[key].shape == np.asarray(st_r[key])[lanes].shape


def _state_box(p, Nc, shrink=0.93, signed=False, **kw):
    """A box per lane from the u-box-only solve so that it binds but stays
    feasible (a fixed box can be infeasible against random dynamics):
    ``shrink`` times the largest |x| (the largest x with ``signed``)."""
    X0 = np.asarray(_solve_both(p, Nc, **kw)[1][0])
    hi = shrink * (X0 if signed else np.abs(X0)).max(axis=(1, 2, 3), keepdims=True)
    return np.broadcast_to(hi, X0.shape).copy()


@pytest.mark.parametrize("M,N,Nc", [(3, 10, 3), (1, 12, 0), (4, 12, 12)])
def test_control_boxes_match_vmapped_jax(M, N, Nc):
    out, ref = _solve_both(problem(3 + M + N, M, N), Nc)
    _hold(out, ref)
    assert out[2]["converged"].all() and not out[2]["failed"].any()
    assert ((out[1].abs() - 0.5).abs() < 1e-6).any()  # the bounds are active
    nct, nfu = max(Nc * UDIM, 1), (N - Nc) * UDIM
    assert out[2]["s"].shape == (B, 2 * nct + 2 * M * nfu)


@pytest.mark.parametrize("case", ["two_sided", "one_sided", "slew", "no_u_bounds"])
def test_state_boxes_match_vmapped_jax(case):
    M, N, Nc = (3, 10, 3) if case != "one_sided" else (2, 9, 0)
    p = problem(44, M, N)
    slew = case == "slew"
    u_box = np.inf if case == "no_u_bounds" else 0.6
    # (with no control bounds the box comes from a solve whose control box
    # never binds, or the freer states would not reach it)
    hi = _state_box(p, Nc, slew=slew, u_box=0.6 if u_box == 0.6 else 50.0,
                    signed=case == "one_sided")
    x_l = np.full_like(hi, -np.inf) if case == "one_sided" else -hi
    out, ref = _solve_both(p, Nc, u_box=u_box, slew=slew, x_l=x_l, x_u=hi, iters=60)
    _hold(out, ref)
    X = out[0]
    assert out[2]["converged"].all() and X.shape == (B, M, N, XDIM)
    hi_t = tt(hi)
    assert (X <= hi_t + 1e-5).all() and ((X - hi_t).abs() < 1e-4).any()  # binds
    if case == "no_u_bounds":
        assert out[1].abs().max() > 0.6
    # the state rows follow the control rows in the flat layout
    nct, nfu = max(Nc * UDIM, 1), (N - Nc) * UDIM
    assert out[2]["lam"].shape == (B, 2 * nct + 2 * M * nfu + 2 * M * N * XDIM)


def test_warm_start_from_a_jax_tuple_and_tol_dynamic():
    M, N, Nc = 3, 10, 3
    p = problem(77, M, N)
    hi = _state_box(p, Nc)
    cold, ref = _solve_both(p, Nc, x_l=-hi, x_u=hi, iters=60)
    st = ref[2]
    warm = tuple(np.asarray(st[k]) for k in ("theta", "uf", "s", "lam"))
    # a nearby problem, started from the JAX solver's point
    p2 = dict(p, x0=p["x0"] + 0.01)
    out_w, ref_w = _solve_both(p2, Nc, x_l=-hi, x_u=hi, warm=warm, iters=60)
    _hold(out_w, ref_w)
    out_c, _ = _solve_both(p2, Nc, x_l=-hi, x_u=hi, iters=60)
    assert (out_w[2]["iters"] < out_c[2]["iters"]).all()
    close(out_w[1], out_c[1].numpy(), 1e-6)
    # tol_dynamic per lane: the loose lane stops earlier
    out_t, ref_t = _solve_both(p2, Nc, x_l=-hi, x_u=hi, warm=warm, iters=60,
                               tol_dynamic=[1e-3, 1e-12])
    _hold(out_t, ref_t)
    assert out_t[2]["iters"][0] < out_t[2]["iters"][1]
    out_tau, ref_tau = _solve_both(p, Nc, tau=0.9, kappa=1e-9)
    _hold(out_tau, ref_tau)


def test_each_lane_of_a_batch_gets_its_own_single_lane_result():
    """One lane converges early (loose tolerance), the other runs into the
    iteration cap: each equals its own single-lane call."""
    M, N, Nc = 3, 10, 3
    p = problem(88, M, N)
    kw = dict(iters=9, tol_dynamic=[1e-2, 1e-14])
    out, ref = _solve_both(p, Nc, **kw)
    _hold(out, ref)
    it = out[2]["iters"]
    assert it[0] < 9 and it[1] == 9
    assert out[2]["converged"].tolist() == [True, False]
    assert not out[2]["failed"].any()  # the cap is not a failure
    for lane in (0, 1):
        one, _ = _solve_both(p, Nc, lanes=slice(lane, lane + 1), **kw)
        _hold(one, ref, lanes=slice(lane, lane + 1))
        for a, b in zip(one[:2], out[:2]):
            close(a[0], b[lane].numpy(), 1e-12)


def test_a_failed_lane_freezes_and_reports_failed_like_jax():
    """An indefinite control cost makes a stage block non-SPD in lane 1: its
    factor is NaN, the step is non-finite, the lane freezes on its start
    point and reports failed; lane 0 converges untouched."""
    M, N, Nc = 2, 8, 2
    p = problem(99, M, N)
    p["R"] = p["R"].copy()
    p["R"][1, 0, 5] = -50.0 * np.eye(UDIM)
    rng = np.random.default_rng(5)
    nct, nfu = Nc * UDIM, (N - Nc) * UDIM
    mtot = 2 * nct + 2 * M * nfu
    warm = (0.1 * rng.normal(size=(B, nct)), 0.1 * rng.normal(size=(B, M, nfu)),
            np.ones((B, mtot)), rng.uniform(0.1, 1.0, size=(B, mtot)))
    out, ref = _solve_both(p, Nc, warm=warm)
    for key in ("iters", "converged", "failed"):
        np.testing.assert_array_equal(out[2][key].numpy(), np.asarray(ref[2][key]))
    assert out[2]["failed"].tolist() == [False, True]
    assert out[2]["iters"][1] == 1
    close(out[2]["theta"][1], warm[0][1], 1e-15)  # frozen on the warm point
    close(out[1][0], np.asarray(ref[1])[0], 1e-8)
    assert torch.isfinite(out[1]).all()


def test_unported_options_raise_naming_the_roadmap():
    p = problem(1, 2, 6)
    base = [tt(p[k]) for k in KEYS + ["reg_x", "reg_u"]]
    box = [tt(np.full(p["U_prev"].shape, v)) for v in (-0.5, 0.5)]
    # the linear extra rows, the cones, the central-path stop and the numpy
    # frontend are ported (the rows: test_linear_extra_rows_* below; the
    # cones and mu_target: tests/test_torch_soc.py, tests/test_torch_ipm_options.py)
    n_full = 2 * 2 + 2 * 4 * 2 + 2 * 6 * 4
    for kw in (dict(u_soc_r=torch.ones(B, 2, 6)), dict(mu_target=0.1),
               dict(ex_G=torch.zeros(B, 1, n_full, dtype=torch.float64), ex_h=torch.ones(B, 1))):
        X, U, st = tipm.riccati_ipm_solve_scp(*base, *box, Nc=2, **kw)
        assert torch.isfinite(U).all() and st["converged"].all()
    assert callable(tipm.riccati_ipm_solve_np)
    # the associative-scan route is ported since (tests/test_torch_priccati.py):
    # it builds, and it runs the unbounded subproblem
    from pmpc_tpu_torch import torch_scp

    solver = torch_scp.build_scp_solver(lambda x, u: x + 0.1 * torch.cat([x[2:], u]),
                                        N=6, xdim=4, udim=2, M=2, method="priccati")
    data = torch_scp.make_scp_data(torch.ones(B, 2, 4, dtype=torch.float64),
                                   torch.eye(4, dtype=torch.float64).expand(B, 2, 6, 4, 4),
                                   1e-2 * torch.eye(2, dtype=torch.float64).expand(B, 2, 6, 2, 2))
    _, U, info = solver(data)
    assert torch.isfinite(U).all() and info["converged"].all()


def _extra_rows(p, Nc, seed):
    """Two linear rows per lane over the full layout [u_cons; u_free; x],
    (B, 3, n_full): the first consensus stage's control sum (or the first
    free stage's, Nc = 0) at most 0.3; a random row with 0.2 of room at zero
    controls, where the box holds; and an inactive row (h = +inf)."""
    Bn, M, N, xdim = p["f"].shape
    udim = p["fu"].shape[-1]
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    rng = np.random.default_rng(seed)
    G = np.zeros((Bn, 3, n_full))
    G[:, 0, :udim] = 1.0
    G[:, 1] = 0.5 * rng.normal(size=(Bn, n_full)) * (rng.uniform(size=(Bn, n_full)) < 0.4)
    G[:, 2] = rng.normal(size=(Bn, n_full))
    x, X0 = p["x0"], []
    for j in range(N):  # the linearized dynamics at zero controls
        x = p["f"][:, :, j] - np.einsum("bmij,bmj->bmi", p["fu"][:, :, j], p["U_prev"][:, :, j]) \
            + (np.einsum("bmij,bmj->bmi", p["fx"][:, :, j], x - p["X_prev"][:, :, j - 1])
               if j else 0.0)
        X0.append(x)
    X0 = np.stack(X0, 2).reshape(Bn, -1)
    h = np.stack([np.full(Bn, 0.3), (G[:, 1, nc + M * nf:] * X0).sum(-1) + 0.2,
                  np.full(Bn, np.inf)], -1)
    return G, h


def test_linear_extra_rows_match_vmapped_jax():
    """`riccati_ipm_solve_scp` with ``ex_G``/``ex_h`` against the JAX one under
    `jax.vmap`, 1e-8 with equal counts: Nc = 0 (the padded theta block),
    slew (the rows' state block is the original states, not the
    augmentation's tail) and state rows beside the extra rows in the flat
    layout. (Nc > 0: tests/test_torch_dispatch.py and chip_smoke.py phase 23.)"""
    M, N, Nc = 2, 8, 0
    p = problem(70, M, N)
    G, h = _extra_rows(p, Nc, seed=M + N)
    kw = dict(ex_G=G, ex_h=h, slew=True, iters=60, x_l=np.full(p["X_prev"].shape, -50.0),
              x_u=np.full(p["X_prev"].shape, 50.0))
    out, ref = _solve_both(p, Nc, **kw)
    _hold(out, ref)
    assert out[2]["converged"].all() and not out[2]["failed"].any()
    # the rows hold, and bind
    X, U = out[0].numpy(), out[1].numpy()
    z = np.concatenate([U[:, 0, :Nc].reshape(B, -1), U[:, :, Nc:].reshape(B, -1),
                        X.reshape(B, -1)], -1)
    rows = np.einsum("bln,bn->bl", G, z) - h
    assert (rows[:, :2] <= 1e-7).all() and (np.abs(rows[:, :2]) < 1e-6).any()
    assert out[2]["lam"].shape[-1] == np.asarray(ref[2]["lam"]).shape[-1]


def test_riccati_ipm_solve_np_wraps_the_core_and_reads_back_once(monkeypatch):
    """The numpy frontend on one problem with slew, a one-sided state box and
    linear rows is the core on that problem (`riccati_ipm_solve_scp` at
    B = 1, held against the JAX core above): X, U and the flags equal, the
    warm tuple kept on the device, X, U and the four scalars read back in
    ONE transfer; its warm tuple starts the next solve. (Against the JAX
    `riccati_ipm_solve_np`, a JAX warm tuple included:
    tests/test_torch_dispatch.py.)"""
    from pmpc_tpu_torch import utils as tutils

    M, N, Nc = 2, 8, 2
    p = problem(5, M, N)
    G, h = _extra_rows(p, Nc, seed=3)
    one = {k: v[0] for k, v in p.items()}
    base = tuple(one[k] for k in KEYS)
    reg = tuple(one[k] for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0", "slew_um1"))
    ub = np.full((M, N, UDIM), 0.5)
    kw = dict(x_u=np.full((M, N, XDIM), 50.0), ex_G=G[0], ex_h=h[0])
    st = dict(ipm_iters=60, ipm_tol_exp=-10)
    reads, real = [], tutils.to_host
    monkeypatch.setattr("pmpc_tpu_torch.solvers.riccati_ipm.to_host",
                        lambda ts: reads.append(len(ts)) or real(ts))
    Xt, Ut, dt = tipm.riccati_ipm_solve_np(base, reg, -ub, ub, Nc, settings=st, device="cpu",
                                           **kw)
    assert reads == [6]
    T = lambda a: tt(np.asarray(a))[None]
    Xc, Uc, sc = tipm.riccati_ipm_solve_scp(
        *(T(a) for a in base), T(reg[0]), T(reg[1]), T(-ub), T(ub), Nc=Nc, slew_reg=T(reg[2]),
        slew_reg0=T(reg[3]), slew_um1=T(reg[4]), x_l=T(np.full((M, N, XDIM), -np.inf)),
        x_u=T(kw["x_u"]), ex_G=T(G[0]), ex_h=T(h[0]), iters=60, tol_exp=-10, kappa=0.0)
    np.testing.assert_array_equal(Ut, Uc[0].numpy())
    np.testing.assert_array_equal(Xt, Xc[0].numpy())
    assert (dt["ipm_iters"], dt["ipm_converged"], dt["ipm_failed"]) == \
        (int(sc["iters"][0]), bool(sc["converged"][0]), bool(sc["failed"][0]))
    assert dt["ipm_converged"] and all(isinstance(a, torch.Tensor) for a in
                                       dt["solver_state"]["riccati_warm"])
    _, Uw, dw = tipm.riccati_ipm_solve_np(base, reg, -ub, ub, Nc, device="cpu",
                                          settings=dict(st, solver_state=dt["solver_state"]),
                                          **kw)
    close(Uw, Ut, 1e-8)
    assert dw["ipm_iters"] < dt["ipm_iters"]
