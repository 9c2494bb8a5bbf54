"""The per-stage control cones ||u_j|| <= r_j of the port against the JAX
package, f64, on the CPU: the SOC primitives (`solvers.coneipm`), the
condensed `ipm_core(has_soc)` and the Riccati `riccati_ipm_core` with
``soc_rc``/``soc_rf``, the fused `build_scp_solver(has_u_soc=True)` on both
routes, BASELINE config 3 and the warm tuple through `convert`.

The condensed cone path of the JAX package at HEAD differs from the port's
(ROADMAP §3 R1, F5: HEAD's ``tau`` 0.95 with cones and its ``stalled``
rule), so the port's condensed route is held against the JAX Riccati core
and the JAX composed dense cone route, which share the port's semantics;
the port's Riccati route is held against the JAX Riccati core iterate for
iterate."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle
from pmpc_tpu.jax_scp import build_scp_solver as jbuild
from pmpc_tpu.jax_scp import make_scp_data as jmake
from pmpc_tpu.solvers import coneipm as jcone
from pmpc_tpu.solvers import riccati_ipm as jripm
from pmpc_tpu.solvers.dispatch import affine_solve_np
from pmpc_tpu_torch import torch_scp
from pmpc_tpu_torch.convert import scp_data_from_numpy, warm_from_numpy
from pmpc_tpu_torch.dynamics import linearize
from pmpc_tpu_torch.flagship import SOC_R3, baseline_config, dubins, stack_varied
from pmpc_tpu_torch.solvers import coneipm as tcone
from pmpc_tpu_torch.solvers import ipm as tipm
from pmpc_tpu_torch.solvers import riccati_ipm as tripm
from pmpc_tpu_torch.solvers.reduced import assemble_condensed, recover_XU, solve_eq
from fixtures import unicycle_step
from test_extras import _u_norm_socs
from test_torch_riccati import B, KEYS, close, tt

torch.set_num_threads(1)

UDIM = 2
ZERO_SLEW = ("slew_reg", "slew_reg0", "slew_um1")


# ---- (a) the primitives -------------------------------------------------------

def _points(rng, n, p, margin):
    """n cone points (n, p): u0 = ||u1|| + margin."""
    u1 = rng.normal(size=(n, p - 1))
    return np.concatenate([(np.linalg.norm(u1, axis=-1) + margin)[:, None], u1], -1)


def _rel_close(a, b, tol=1e-12):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("p", [3, 5])
def test_soc_primitives_match_jax(p):
    rng = np.random.default_rng(p)
    n = 64
    # interior points, and points 1e-4 from the wall (the NT scaling there
    # is large but finite)
    for margin in (rng.uniform(0.1, 2.0, n), np.full(n, 1e-4)):
        s, z = _points(rng, n, p, margin), _points(rng, n, p, rng.uniform(0.1, 2.0, n))
        ref = jax.vmap(jcone._soc_W)(jnp.asarray(s), jnp.asarray(z))
        out = tcone._soc_W(tt(s), tt(z))
        for a, b in zip(out, ref):
            _rel_close(a, b)
        W, Winv, W2inv, lam = out
        eye = torch.eye(p, dtype=torch.float64)
        assert (W @ Winv - eye).abs().max() < 1e-9  # the scaling's own identities
        assert (tipm._mv(W, tt(z)) - tipm._mv(Winv, tt(s))).abs().max() < 1e-9
        u, v = rng.normal(size=(n, p)), rng.normal(size=(n, p))
        _rel_close(tcone._soc_prod(tt(u), tt(v)),
                   jax.vmap(jcone._soc_prod)(jnp.asarray(u), jnp.asarray(v)))
        _rel_close(tcone._soc_inv(tt(s)), jax.vmap(jcone._soc_inv)(jnp.asarray(s)))

    # step lengths: crossings from inside and near the wall, and rays that
    # never leave the cone (a direction inside the cone, a zero direction,
    # a step towards the axis), which give +inf exactly
    s = np.concatenate([_points(rng, n, p, rng.uniform(0.1, 2.0, n)),
                        _points(rng, n, p, np.full(n, 1e-6))])
    ds = rng.normal(size=s.shape)
    inside = _points(rng, 8, p, rng.uniform(0.1, 1.0, 8))
    ds[:8], ds[8:12], ds[12:16] = inside, 0.0, 0.0
    ds[12:16, 0] = 1.0
    ref = np.asarray(jax.vmap(jcone._soc_step_len)(jnp.asarray(s), jnp.asarray(ds)))
    out = tcone._soc_step_len(tt(s), tt(ds)).numpy()
    inf = np.isinf(ref)
    assert inf[:16].all() and not inf[16:].all()
    np.testing.assert_array_equal(np.isinf(out), inf)
    assert np.max(np.abs(out[~inf] - ref[~inf]) / np.maximum(1.0, ref[~inf])) < 1e-12
    after = s[~inf] + out[~inf, None] * ds[~inf]  # a finite step ends on the wall
    assert np.abs(after[:, 0] - np.linalg.norm(after[:, 1:], axis=-1)).max() < 1e-8


# ---- shared problem data ---------------------------------------------------

def dubins_problem(seed, M, N):
    """B SCP subproblems of the Dubins car, numpy (B, M, ...): the dynamics
    linearized along a rollout of random controls from x0 near ones, Q = I,
    R = 1e-2 I, references at 0, no slew. (On `oracle.random_problem` data
    the cone IPM crawls near its tolerance on both packages' routes, and
    routes that crawl part at the rounding level.)"""
    rng = np.random.default_rng(seed)
    x0 = np.ones((B, M, 4)) + 0.05 * rng.normal(size=(B, M, 4))
    U = 0.3 * rng.normal(size=(B, M, N, UDIM))
    x, Xs = tt(x0), []
    for j in range(N):
        x = dubins(x, tt(U[:, :, j]))
        Xs.append(x)
    X = torch.stack(Xs, 2)
    f, fx, fu = linearize(dubins, torch.cat([tt(x0)[:, :, None], X[:, :, :-1]], 2), tt(U))
    return dict(x0=x0, f=f.numpy(), fx=fx.numpy(), fu=fu.numpy(), X_prev=X.numpy(),
                U_prev=U, Q=np.tile(np.eye(4), (B, M, N, 1, 1)),
                R=np.tile(1e-2 * np.eye(UDIM), (B, M, N, 1, 1)),
                X_ref=np.zeros((B, M, N, 4)), U_ref=np.zeros((B, M, N, UDIM)),
                reg_x=np.ones((B, M)), reg_u=np.full((B, M), 0.1),
                slew_reg=np.zeros((B, M)), slew_reg0=np.zeros((B, M)),
                slew_um1=np.zeros((B, M, UDIM)))


def _radius(p, Nc, frac):
    """A cone radius per lane that binds: ``frac`` times the largest
    stage-control norm of the unconstrained solve."""
    cqp = _torch_cqp(p, Nc)
    _, U = recover_XU(cqp, *solve_eq(cqp), N=p["f"].shape[2])
    return frac * U.norm(dim=-1).amax((1, 2)).numpy()


def _torch_cqp(p, Nc):
    return assemble_condensed(*(tt(p[k]) for k in KEYS + ["reg_x", "reg_u", *ZERO_SLEW]),
                              Nc=Nc)


def _jax_riccati(p, Nc, r, u_box=np.inf, x_box=None, **kw):
    """`jax.vmap` of the JAX `riccati_ipm_solve_scp` with cones of radii
    r (B, M, N) (None: no cones) on problem ``p``: (X, U, stats)."""
    shape = p["U_prev"].shape
    arrs = dict(u_l=np.full(shape, -u_box), u_u=np.full(shape, u_box))
    if r is not None:
        arrs["u_soc_r"] = r
    if x_box is not None:
        arrs.update(x_l=-x_box, x_u=x_box)
    base = [jnp.asarray(p[k]) for k in KEYS + ["reg_x", "reg_u"]]
    return jax.vmap(lambda a, d: jripm.riccati_ipm_solve_scp(*a, Nc=Nc, **d, **kw))(
        base, {k: jnp.asarray(v) for k, v in arrs.items()})


def _torch_riccati(p, Nc, r, u_box=np.inf, x_box=None, **kw):
    shape = p["U_prev"].shape
    arrs = dict(u_l=np.full(shape, -u_box), u_u=np.full(shape, u_box))
    if r is not None:
        arrs["u_soc_r"] = r
    if x_box is not None:
        arrs.update(x_l=-x_box, x_u=x_box)
    return tripm.riccati_ipm_solve_scp(
        *(tt(p[k]) for k in KEYS + ["reg_x", "reg_u"]), Nc=Nc,
        **{k: tt(v) for k, v in arrs.items()}, **kw)


def _torch_condensed(p, Nc, r, u_box=np.inf, **kw):
    """The port's condensed `ipm_core` with cones: (U, stats)."""
    cqp = _torch_cqp(p, Nc)
    M, N = p["x0"].shape[1], p["f"].shape[2]
    nc = Nc * UDIM
    lo = torch.full((B, M, N * UDIM), -u_box, dtype=torch.float64)
    bounds = tipm.BoxBounds(lo[:, 0, :nc], -lo[:, 0, :nc], lo[:, :, nc:], -lo[:, :, nc:])
    uc, uf, st = tipm.ipm_core(cqp, bounds, has_u=bool(np.isfinite(u_box)),
                               socs=tipm.layout_socs(tt(r), Nc), has_soc=True, **kw)
    return recover_XU(cqp, uc, uf, N=N)[1], st


def _cone_ok(U, r, tol):
    return (U.norm(dim=-1) <= tt(r) + tol).all()


# ---- (b), (d), (g): the IPM cores -------------------------------------------

@pytest.mark.parametrize("M,N,Nc", [(3, 10, 3), (2, 8, 0)])
def test_condensed_soc_matches_the_jax_riccati_core(M, N, Nc):
    """Same Mehrotra algebra, another Newton solver: U to 1e-6."""
    p = dubins_problem(61 + M + N, M, N)
    r = np.broadcast_to(_radius(p, Nc, 0.7)[:, None, None], (B, M, N)).copy()
    kw = dict(iters=60, tol_exp=-9)
    U, st = _torch_condensed(p, Nc, r, **kw)
    _, U_r, st_r = _jax_riccati(p, Nc, r, **kw)
    print("IPM iterations: port condensed", st["iters"].tolist(),
          "JAX riccati", np.asarray(st_r["iters"]).tolist())
    assert st["converged"].all() and np.asarray(st_r["converged"]).all()
    assert not st["failed"].any()
    close(U, np.asarray(U_r), 1e-6)
    assert _cone_ok(U, r, 1e-6)
    assert ((U.norm(dim=-1) - tt(r)).abs() < 1e-6).any(dim=(1, 2)).all()  # binds
    np.testing.assert_array_equal(st["iters"].numpy(), np.asarray(st_r["iters"]))
    assert st["sq"].shape == st["zq"].shape == (B, Nc + M * (N - Nc), UDIM + 1)


@pytest.mark.parametrize("case", ["box", "state_box"])
def test_riccati_soc_matches_the_jax_core_iterate_for_iterate(case):
    M, N, Nc = 3, 10, 3
    p = dubins_problem(71, M, N)
    r = np.broadcast_to(_radius(p, Nc, 0.8)[:, None, None], (B, M, N)).copy()
    kw = dict(iters=60, tol_exp=-8, u_box=0.95 * r.max())
    if case == "state_box":
        X0 = np.asarray(_jax_riccati(p, Nc, r, **kw)[0])
        kw["x_box"] = np.broadcast_to(
            0.95 * np.abs(X0).max(axis=(1, 2, 3), keepdims=True), X0.shape).copy()
    X_r, U_r, st_r = _jax_riccati(p, Nc, r, **kw)
    X, U, st = _torch_riccati(p, Nc, r, **kw)
    print("IPM iterations: port", st["iters"].tolist(), "JAX", np.asarray(st_r["iters"]).tolist())
    close(X, np.asarray(X_r), 1e-8)
    close(U, np.asarray(U_r), 1e-8)
    for key in ("iters", "converged", "failed"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(st_r[key]))
    for key in ("sq", "zq"):
        close(st[key], np.asarray(st_r[key]), 1e-6)
    assert st["converged"].all()
    assert _cone_ok(U, r, 1e-6)
    if case == "state_box":
        assert (X.abs() <= tt(kw["x_box"]) + 1e-6).all()


def test_masked_cones_match_and_cost_nothing():
    """r = +inf on some stages (and on every stage of one particle): those
    cones sit at e and take no part; both port routes match the JAX core."""
    M, N, Nc = 3, 10, 3
    p = dubins_problem(91, M, N)
    r_lane = _radius(p, Nc, 0.4)
    r = np.broadcast_to(r_lane[:, None, None], (B, M, N)).copy()
    r[:, :, 1::3] = np.inf
    r[1, 2] = np.inf  # lane 1, particle 2: no cone at all on its free stages
    kw = dict(iters=60, tol_exp=-9)
    _, U_r, st_r = _jax_riccati(p, Nc, r, **kw)
    X, U_ric, st_ric = _torch_riccati(p, Nc, r, **kw)
    U_con, st_con = _torch_condensed(p, Nc, r, **kw)
    close(U_ric, np.asarray(U_r), 1e-8)
    np.testing.assert_array_equal(st_ric["iters"].numpy(), np.asarray(st_r["iters"]))
    close(U_con, np.asarray(U_r), 1e-6)
    assert st_con["converged"].all() and st_ric["converged"].all()
    live = np.isfinite(r)
    assert (U_ric.norm(dim=-1).numpy()[live] <= r[live] + 1e-6).all()
    over = U_ric.norm(dim=-1).numpy() > r_lane[:, None, None] + 1e-3
    assert over[~live].any() and not over[live].any()  # an uncut stage leaves the radius
    # a masked cone's point stays at the unit element
    nq = Nc + M * (N - Nc)
    rm = np.concatenate([r[:, 0, :Nc], r[:, :, Nc:].reshape(B, -1)], -1)
    e = np.zeros((nq, UDIM + 1))
    e[:, 0] = 1.0
    for st in (st_con, st_ric):
        assert (st["sq"].numpy()[~np.isfinite(rm)] == e[0]).all()


# ---- (c) the composed dense route -------------------------------------------

def test_condensed_soc_matches_the_jax_composed_dense_route():
    """The instance of test_soc_structured.py::
    test_structured_soc_matches_dense_cone_path (seed 21) at its 5e-5. The
    JAX dense cone program (`extra_cstrs` through the composed route) is
    the reference."""
    rng = np.random.default_rng(21)
    M, N, xdim, Nc, umax = 2, 6, 3, 2, 0.6
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=UDIM)
    common = dict(reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1), slew_reg=np.zeros(M),
                  slew_reg0=np.zeros(M), slew_um1=np.zeros((M, UDIM)),
                  u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)
    # extras_structured=False: the JAX dispatcher would otherwise detect the
    # stage cones and send them to its (red) structured route
    _, U_d, _ = affine_solve_np(*(p[k] for k in KEYS), **common, settings=dict(
        extra_cstrs=[_u_norm_socs(M, N, xdim, UDIM, Nc, umax)], extras_structured=False))
    one = {k: np.asarray(v)[None] for k, v in p.items()}
    one.update(reg_x=np.ones((1, M)), reg_u=np.full((1, M), 0.1))
    cqp = assemble_condensed(*(tt(one[k]) for k in KEYS + ["reg_x", "reg_u"]),
                             *(torch.zeros((1, M) + s, dtype=torch.float64)
                               for s in ((), (), (UDIM,))), Nc=Nc)
    inf_c = torch.full((1, Nc * UDIM), torch.inf, dtype=torch.float64)
    inf_f = torch.full((1, M, (N - Nc) * UDIM), torch.inf, dtype=torch.float64)
    socs = tipm.layout_socs(torch.full((1, M, N), umax, dtype=torch.float64), Nc)
    uc, uf, st = tipm.ipm_core(cqp, tipm.BoxBounds(-inf_c, inf_c, -inf_f, inf_f),
                               has_u=False, iters=40, tol_exp=-9, socs=socs, has_soc=True)
    U = recover_XU(cqp, uc, uf, N=N)[1][0].numpy()
    assert st["converged"].all() and not st["failed"].any()
    np.testing.assert_allclose(U, U_d, atol=5e-5)
    assert np.linalg.norm(U, axis=-1).max() <= umax + 1e-6
    assert np.ptp(U[:, :Nc, :], axis=0).max() < 1e-10


# ---- (e), (f), (h): the fused solver ----------------------------------------

def _fused_instance():
    """The instance of test_riccati_ipm.py::
    test_fused_riccati_u_soc_matches_condensed, stacked to B = 2 with x0
    varied from seed 82."""
    N, xdim, M = 10, 4, 3
    rng = np.random.default_rng(81)
    d = jmake(np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim)),
              np.tile(np.eye(xdim), (M, N, 1, 1)), np.tile(1e-2 * np.eye(UDIM), (M, N, 1, 1)),
              reg_x=1.0, reg_u=0.1, u_soc_r=0.5 * np.ones((M, N)))
    stack = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), d)
    x0 = np.asarray(stack.x0) + 0.05 * np.random.default_rng(82).normal(size=stack.x0.shape)
    return stack._replace(x0=jnp.asarray(x0))


FUSED_KW = dict(N=10, xdim=4, udim=UDIM, M=3, Nc=3, max_it=8, res_tol=1e-7,
                has_u_soc=True, ipm_iters=50, ipm_tol_exp=-6, collect_stats=True,
                adaptive_tol=False)


def test_fused_soc_on_both_routes_matches_the_vmapped_jax_riccati_solver():
    j_stack = _fused_instance()
    X_r, U_r, info_r = jax.vmap(jbuild(unicycle_step, method="riccati", **FUSED_KW))(j_stack)
    t_data = scp_data_from_numpy(j_stack, "cpu", torch.float64)
    assert t_data.u_soc_r.shape == (B, 3, 10)
    for method in ("riccati", "condensed"):
        X, U, info = torch_scp.build_scp_solver(dubins, method=method, **FUSED_KW)(t_data)
        close(U, np.asarray(U_r), 1e-7)
        close(X, np.asarray(X_r), 1e-7)
        assert (U.norm(dim=-1) <= 0.5 + 1e-7).all()
        stats, stats_r = info["scan_stats"], info_r["scan_stats"]
        assert not stats["ipm_failed"].any()
        if method == "riccati":
            np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(info_r["iters"]))
            np.testing.assert_array_equal(stats["ipm_iters"].numpy(),
                                          np.asarray(stats_r["ipm_iters"]))


def _config3_jax(B4):
    """BASELINE config 3 (`benchmarks/configs.py`) in the JAX package, f64,
    through its green route (method="riccati"), stacked as the bench does."""
    import __graft_entry__ as ge

    N, xdim = 20, 4
    d = jmake(np.ones((1, xdim)), np.tile(np.eye(xdim), (1, N, 1, 1)),
              np.tile(1e-2 * np.eye(UDIM), (1, N, 1, 1)), reg_x=1.0, reg_u=0.1,
              u_l=-np.ones((1, N, UDIM)), u_u=np.ones((1, N, UDIM)),
              u_soc_r=np.full((1, N), SOC_R3))
    solver = jbuild(ge._dubins, N=N, xdim=xdim, udim=UDIM, M=1, Nc=0, max_it=25,
                    res_tol=1e-3, accel="AA", has_u_bounds=True, has_u_soc=True,
                    method="riccati")
    stack = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B4,) + a.shape), d)
    x0 = np.asarray(stack.x0) + 0.02 * np.random.default_rng(1).normal(size=stack.x0.shape)
    return jax.vmap(solver)(stack._replace(x0=jnp.asarray(x0)))


def test_config3_cut_to_b4_is_feasible_and_matches_jax():
    B4 = 4
    X_r, U_r, info_r = _config3_jax(B4)
    for method in ("condensed", "riccati"):
        solver, data, B_full = baseline_config(3, torch.float64, device="cpu", method=method)
        assert B_full == 512 and data.u_soc_r.shape == (1, 20)
        X, U, info = solver(stack_varied(data, B4, scale=0.02))
        assert info["converged"].all()
        assert U.abs().max() <= 1 + 1e-6 and (U.norm(dim=-1) <= SOC_R3 + 1e-6).all()
        assert ((U.norm(dim=-1) - SOC_R3).abs() < 1e-4).any()  # the cone binds
        close(U, np.asarray(U_r), 1e-7)
        np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(info_r["iters"]))


def test_warm_tuple_with_cone_duals_through_convert():
    """The 6-long warm tuple of the JAX fused solver starts the port's, and
    the port's own state round-trips: same answer as JAX from the same
    state."""
    j_stack = _fused_instance()
    kw = dict(FUSED_KW, collect_stats=False, return_state=True, max_it=3)
    j_solver = jax.vmap(jbuild(unicycle_step, method="riccati", **kw))
    _, _, info_r = j_solver(j_stack)
    state = tuple(np.asarray(a) for a in info_r["solver_state"])
    assert len(state) == 6 and state[4].shape == (B, 3 + 3 * 7, 3)  # Nc + M (N - Nc) cones
    j_stack2 = j_stack._replace(x0=j_stack.x0 + 0.01)
    _, U2_r, info2_r = j_solver(j_stack2, tuple(map(jnp.asarray, state)))
    t_solver = torch_scp.build_scp_solver(dubins, method="riccati", **kw)
    t_data2 = scp_data_from_numpy(j_stack2, "cpu", torch.float64)
    _, U2, info2 = t_solver(t_data2, warm_from_numpy(state, "cpu", torch.float64))
    close(U2, np.asarray(U2_r), 1e-7)
    np.testing.assert_array_equal(info2["iters"].numpy(), np.asarray(info2_r["iters"]))
    assert len(info2["solver_state"]) == 6
    # the condensed route's own tuple carries (sq, zq) as well
    c_solver = torch_scp.build_scp_solver(dubins, method="condensed", **kw)
    _, _, info_c = c_solver(t_data2)
    sq, zq = info_c["solver_state"][4:]
    assert sq.shape == zq.shape == (B, 3 + 3 * 7, 3)
    _, U3, _ = c_solver(t_data2, info_c["solver_state"])
    assert (U3.norm(dim=-1) <= 0.5 + 1e-6).all()
    with pytest.raises(ValueError, match="4 or 6"):
        warm_from_numpy(state[:5], "cpu", torch.float64)


# ---- F7: config 3 in f32, the lanes whose IPM gives up -----------------------

F7_LANES = [79, 125, 160, 256, 395, 452]


def _f7_lanes():
    """Config 3 in f32 (B=512, `stack_varied(data, 512, scale=0.02)`) cut to
    `F7_LANES`: the JAX data and the port's."""
    N, xdim = 20, 4
    f32 = np.float32
    d = jmake(np.ones((1, xdim), f32), np.tile(np.eye(xdim, dtype=f32), (1, N, 1, 1)),
              np.tile((1e-2 * np.eye(UDIM)).astype(f32), (1, N, 1, 1)), reg_x=1.0, reg_u=0.1,
              u_l=-np.ones((1, N, UDIM), f32), u_u=np.ones((1, N, UDIM), f32),
              u_soc_r=np.full((1, N), SOC_R3, f32))
    stack = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (512,) + a.shape), d)
    x0 = np.asarray(stack.x0) + 0.02 * np.random.default_rng(1).normal(
        size=stack.x0.shape).astype(f32)
    cut = jax.tree.map(lambda a: a[np.array(F7_LANES)], stack._replace(x0=jnp.asarray(x0)))
    return cut, scp_data_from_numpy(cut, "cpu", torch.float32)


def _f7_jax_riccati(**kw):
    """The JAX fused solver of config 3, Riccati route (the port's cone
    semantics, F5)."""
    import __graft_entry__ as ge

    return jbuild(ge._dubins, N=20, xdim=4, udim=UDIM, M=1, Nc=0, max_it=25, res_tol=1e-3,
                  accel="AA", has_u_bounds=True, has_u_soc=True, method="riccati", **kw)


def test_f7_config3_f32_give_ups_are_shared_and_tau_095_clears_them():
    """ROADMAP §3 F7. BASELINE config 3 in f32 (B=512) cut to six lanes:
    256 and 452, where the port's condensed route gave up on the card and
    on the CPU, and 79, 125, 160 and 395, where `jax.vmap` of the JAX fused
    solver's Riccati route (the port's cone semantics, F5) gives up on the
    CPU. At the default fraction to the boundary (0.99) a lane gives up
    when one Mehrotra step at mu ~ 1e-6 lands within f32 rounding of a cone
    wall (mu jumps, then cone escapes and non-finite steps: four
    breakdowns); which lanes do so follows the last bit of each package's
    arithmetic, so those outcomes are printed, not held. At
    ``ipm_tau=0.95`` every lane converges on all three routes, with the
    same SCP iteration counts on this CPU (held to one iteration: f32
    residuals that end near res_tol may round either way elsewhere)."""
    cut, t_data = _f7_lanes()
    for tau in (None, 0.95):
        solver = _f7_jax_riccati(ipm_tau=tau)
        _, _, info_r = jax.vmap(solver)(cut)
        outs = {"JAX riccati": (np.asarray(info_r["converged"]), np.asarray(info_r["iters"]))}
        for method in ("condensed", "riccati"):
            s, _, _ = baseline_config(3, torch.float32, device="cpu", method=method, ipm_tau=tau)
            _, U, info = s(t_data)
            assert U.norm(dim=-1).max() <= SOC_R3 + 1e-4 and U.abs().max() <= 1 + 1e-5
            outs[f"port {method}"] = (info["converged"].numpy(), info["iters"].numpy())
        for name, (conv, its) in outs.items():
            print(f"tau {tau or 0.99}, lanes {F7_LANES}: {name} converged {conv.tolist()}, "
                  f"SCP iterations {its.tolist()}")
        if tau == 0.95:
            ref_conv, ref_its = outs["JAX riccati"]
            assert ref_conv.all()
            for conv, its in outs.values():
                np.testing.assert_array_equal(conv, ref_conv)
                assert np.abs(its - ref_its).max() <= 1, (its, ref_its)


def test_f18_a_given_up_lane_stalls_in_jax_and_retries_in_the_port():
    """ROADMAP §3 F18, the port's deliberate divergence from the JAX solver.
    Config 3 in f32 at the default fraction to the boundary (0.99) on F7's
    lanes, where the JAX Riccati route's IPM gives up on some lanes. A lane
    whose IPM gives up keeps its iterate in both packages, so its next round
    solves the same subproblem. The JAX solver starts that round from the
    warm start that gave up: it gives up again every round, and the lane
    ends unconverged at ``max_it``. The port with ``ipm_fresh_retry`` (the
    cone cell's setting) starts it from the same primal point with fresh
    slacks and multipliers (`torch_scp._fresh_duals`): a
    round after a give-up does not give up, and every lane converges on
    both of the port's routes. Which lanes give up follows each package's
    last bits (F7); that the JAX solver stalls after any give-up, and that
    the port recovers after any, is what is held."""
    cut, t_data = _f7_lanes()
    _, _, info = jax.vmap(_f7_jax_riccati(collect_stats=True))(cut)
    # the rounds a lane ran: a done lane's later rows repeat its last
    live = lambda its: np.arange(25)[None] < np.asarray(its)[:, None]
    failed = np.asarray(info["scan_stats"]["ipm_failed"]) & live(info["iters"])
    gave_up = failed.any(1)
    assert gave_up.any()
    for lane in np.flatnonzero(gave_up):  # after the first give-up, every round gives up
        assert failed[lane, failed[lane].argmax():].all(), failed[lane]
    np.testing.assert_array_equal(np.asarray(info["converged"]), ~gave_up)
    assert (np.asarray(info["iters"])[gave_up] == 25).all()
    for method in ("condensed", "riccati"):
        s, _, _ = baseline_config(3, torch.float32, device="cpu", method=method,
                                  collect_stats=True, ipm_fresh_retry=True)
        _, U, t_info = s(t_data)
        t_failed = t_info["scan_stats"]["ipm_failed"].numpy() & live(t_info["iters"])
        print(f"{method}: JAX gave up on lanes {np.flatnonzero(gave_up).tolist()}; the port's "
              f"give-ups (lane, round): {np.argwhere(t_failed).tolist()}")
        assert not (t_failed[:, 1:] & t_failed[:, :-1]).any()
        assert t_info["converged"].all()
        assert U.norm(dim=-1).max() <= SOC_R3 + 1e-4 and U.abs().max() <= 1 + 1e-5
