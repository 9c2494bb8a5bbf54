"""The composed cone program of the port (`solvers.compose`, `solvers.extras`,
`solvers.cvar`) against the JAX package, f64, on the CPU.

(a) `build_cone_program`'s (P, q, Gl, hl, Gq, hq) against the JAX
composer's, lane for lane, to 1e-12, for every symmetric feature: the CVaR
epigraph, boxes with one-sided infinite bounds, state boxes, control-norm
cones, user extras with auxiliary variables and ``c_left`` of either length,
the cross-particle terminal cost, squareplus smoothing; the exponential-cone
signatures raise.
(b) the serial host solve `composed_cone_solve` on tests/test_cvar.py's and
tests/test_compose.py's squareplus instances against the JAX one (which
`affine_solve_np` reaches): U to 1e-7, the same ``data`` keys, equal IPM
iteration counts, and a warm start from the JAX solve's ``solver_state``.
(c) ROADMAP §3 F5: tests/test_fuzz_socdetect.py's seed 801, which HEAD's
structured route fails (R1), through the port's composed route against the
JAX composed route (``extras_structured=False``).
(d) the numpy helpers (`_canon_extras`, `split_stage_u_cones`,
`particle_constants`) against their JAX-package originals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle
from pmpc_tpu.solvers import compose as jcomp
from pmpc_tpu.solvers import cvar as jcvar
from pmpc_tpu.solvers import extras as jext
from pmpc_tpu.solvers.dispatch import affine_solve_np
from pmpc_tpu.solvers.reduced import assemble_condensed as j_assemble
from pmpc_tpu.solvers.reduced import particle_H_q as j_particle_H_q
from pmpc_tpu_torch.convert import cone_warm_from_numpy, cone_warm_to_numpy
from pmpc_tpu_torch.solvers import compose as tcomp
from pmpc_tpu_torch.solvers import cvar as tcvar
from pmpc_tpu_torch.solvers import extras as text
from pmpc_tpu_torch.solvers.reduced import CondensedQP, assemble_condensed, particle_H_q
from test_fuzz_socdetect import _stage_cone_rows
from test_torch_riccati import KEYS, close, tt

torch.set_num_threads(1)

B = 2
REG = ("reg_x", "reg_u", "slew_reg", "slew_reg0", "slew_um1")
ARGS15 = KEYS + list(REG)


def _problems(seed, M, N, xdim=3, udim=2):
    """B stacked `oracle.random_problem`s with regularization (B, M, ...)."""
    rng = np.random.default_rng(seed)
    ps = [oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim) for _ in range(B)]
    p = {k: np.stack([q[k] for q in ps]) for k in KEYS}
    p.update(reg_x=np.ones((B, M)), reg_u=np.full((B, M), 0.1), slew_reg=np.zeros((B, M)),
             slew_reg0=np.zeros((B, M)), slew_um1=np.zeros((B, M, udim)))
    return p, rng


def _cqps(p, Nc, cvar):
    """(port CondensedQP (B, ...), [JAX CondensedQP per lane], port
    CvarParts or None, [JAX CvarParts] or None)."""
    M, udim = p["x0"].shape[1], p["fu"].shape[-1]
    nc = Nc * udim
    if not cvar:
        t = assemble_condensed(*(tt(p[k]) for k in ARGS15), Nc=Nc)
        js = [j_assemble(*(jnp.asarray(p[k][b]) for k in ARGS15), Nc=Nc) for b in range(B)]
        return t, js, None, None
    H, q, Ft, g = particle_H_q(*(tt(p[k]) for k in ARGS15))
    t = CondensedQP(H[:, :, :nc, :nc].sum(1), H[:, :, :nc, nc:], H[:, :, nc:, nc:],
                    q[:, :, :nc].sum(1), q[:, :, nc:], Ft, g, tt(p["U_prev"]).reshape(B, M, -1),
                    None, None, None, None)
    c_t = tcomp.particle_constants_t(g, *(tt(p[k]) for k in KEYS[4:10]), tt(p["reg_x"]),
                                     tt(p["reg_u"]), tt(p["slew_reg0"]), tt(p["slew_um1"]))
    cv_t = tcomp.CvarParts(H, q, c_t, 2.0, tcomp.COST_ANCHOR_EPS)
    js, cvs = [], []
    for b in range(B):
        args = [jnp.asarray(p[k][b]) for k in ARGS15]
        Hj, qj, Ftj, gj = jax.vmap(j_particle_H_q)(*args)
        js.append(jcomp.CondensedQP(Hcc=Hj[:, :nc, :nc].sum(0), Hcf=Hj[:, :nc, nc:],
                                    Hff=Hj[:, nc:, nc:], qc=qj[:, :nc].sum(0), qf=qj[:, nc:],
                                    Ft=Ftj, g=gj, w_prev=args[5].reshape(M, -1)))
        c_np = jcvar.particle_constants(np.asarray(gj), *(p[k][b] for k in KEYS[4:10]),
                                        p["reg_x"][b], p["reg_u"][b], p["slew_reg0"][b],
                                        p["slew_um1"][b])
        close(c_t[b], c_np, 1e-10)
        close(torch.from_numpy(tcvar.particle_constants(np.asarray(gj), *(
            p[k][b] for k in KEYS[4:10]), p["reg_x"][b], p["reg_u"][b], p["slew_reg0"][b],
            p["slew_um1"][b])), c_np, 1e-12)
        cvs.append(jcomp.CvarParts(Hj, qj, jnp.asarray(c_np), jnp.asarray(2.0),
                                   jnp.asarray(jcomp.COST_ANCHOR_EPS)))
    return t, js, cv_t, cvs


def _extras(rng, M, N, Nc, xdim, udim, c_left_len):
    """B user extras tuples of one signature: 2 linear rows, a 3-cone and a
    4-cone over controls and states, two auxiliary variables with costs,
    and a ``c_left`` of ``c_left_len`` entries."""
    nz = Nc * udim + M * (N - Nc) * udim
    n_full = nz + M * N * xdim
    out = []
    for _ in range(B):
        G = 0.3 * rng.normal(size=(2 + 3 + 4, n_full))
        h = np.concatenate([[1.0, 1.5], [2.0, 0.1, -0.1], [3.0, 0.2, 0.0, 0.1]])
        G_r = np.zeros((9, 2))
        G_r[0, 0], G_r[2, 1] = -1.0, -0.5
        out.append((2, [3, 4], 0, G, G_r, h, 0.01 * rng.normal(size=c_left_len),
                    np.array([1.0, 0.5])))
    return out, n_full


CASES = {
    # (seed, M, N, Nc, cvar, features)
    "cvar_boxes_usoc": (51, 3, 5, 5, True, ("ubox", "usoc")),
    "boxes_states_usoc_extras_hf": (52, 2, 6, 2, False, ("ubox_onesided", "xbox", "usoc",
                                                         "extras_full", "hf")),
    "extras_short_c_left_squareplus": (53, 2, 6, 2, False, ("ubox", "extras_nz",
                                                            "squareplus")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_cone_program_matches_jax(case):
    seed, M, N, Nc, cvar, feats = CASES[case]
    xdim, udim = 3, 2
    p, rng = _problems(seed, M, N, xdim, udim)
    t_cqp, j_cqps, t_cv, j_cvs = _cqps(p, Nc, cvar)
    ub = ul = xl = xu = r = None
    if "ubox" in feats or "ubox_onesided" in feats:
        ul, ub = -0.8 * np.ones((B, M, N, udim)), 0.7 * np.ones((B, M, N, udim))
        if "ubox_onesided" in feats:
            ul[:, :, ::2] = -np.inf
            ub[:, 1, 3] = np.inf
    if "xbox" in feats:
        xl, xu = -2.0 * np.ones((B, M, N, xdim)), 2.5 * np.ones((B, M, N, xdim))
        xl[:, 0, :, 1] = -np.inf
    if "usoc" in feats:
        r = np.full((B, M, N), 0.6)
        r[:, :, 1] = np.inf
    sig, ecs_t, ecs_j = (), (), [() for _ in range(B)]
    nz = Nc * udim + M * (N - Nc) * udim
    if any(f.startswith("extras") for f in feats):
        raw, n_full = _extras(rng, M, N, Nc, xdim, udim,
                              nz if "extras_nz" in feats else nz + M * N * xdim)
        canon = [text._canon_extras([e], n_full) for e in raw]
        sig = canon[0][0]
        assert all(c[0] == sig for c in canon) and sig == jext._canon_extras(raw[:1], n_full)[0]
        ecs_t = tuple(tuple(torch.from_numpy(np.stack([c[1][i][j] for c in canon]))
                            for j in range(5)) for i in range(len(sig)))
        ecs_j = [tuple(tuple(jnp.asarray(a) for a in ec) for ec in c[1]) for c in canon]
    Hf = None
    if "hf" in feats:
        Hf = 0.3 * np.eye(M * xdim)
    smooth = "squareplus" if "squareplus" in feats else ""
    kw = dict(smooth_alpha=20.0, smooth_beta=2.0) if smooth else {}
    H_t = q_t = None
    if Hf is not None:
        hf = 0.1 * np.ones((B, M * xdim))
        H_t, q_t = text.terminal_cross_cost(t_cqp, N=N, xdim=xdim, Hf=tt(Hf), hf=tt(hf))
    T = tcomp.build_cone_program(
        t_cqp, (N, udim, xdim), sig, ecs_t, (None if ul is None else tt(ul),
                                              None if ub is None else tt(ub)),
        (None if xl is None else tt(xl), None if xu is None else tt(xu)),
        smooth_method=smooth, u_soc_r=None if r is None else tt(r), H_extra=H_t,
        q_extra=q_t, cvar=t_cv, **kw)
    P, q, Gl, hl, blocks, Xmap, xoff, lay = T
    Gq, hq = tcomp.pad_socs(blocks, lay.nv, P.dtype, B=B)
    for b in range(B):
        H_j = q_j = None
        if Hf is not None:
            H_j, q_j = jext.terminal_cross_cost(j_cqps[b], N=N, xdim=xdim, Hf=Hf, hf=hf[b])
            close(H_t[b], H_j, 1e-12)
            close(q_t[b], q_j, 1e-12)
        jb = lambda a: None if a is None else jnp.asarray(a[b])
        Pj, qj, Glj, hlj, bj, Ge, he, Xmj, xoj, layj = jcomp.build_cone_program(
            j_cqps[b], (N, udim, xdim), sig, ecs_j[b], (jb(ul), jb(ub)), (jb(xl), jb(xu)),
            smooth_method=smooth, u_soc_r=jb(r), H_extra=H_j, q_extra=q_j,
            cvar=None if j_cvs is None else j_cvs[b], **kw)
        assert Ge.shape[0] == 0 and tuple(lay) == tuple(layj)
        Gqj, hqj = jcomp.pad_socs(bj, layj.nv, Pj.dtype)
        for a, aj in ((P, Pj), (q, qj), (Gl, Glj), (hl, hlj), (Gq, Gqj), (hq, hqj),
                      (Xmap, Xmj), (xoff, xoj)):
            close(a[b], aj, 1e-12)
    assert torch.isfinite(hl).all()  # infinite bounds were neutralized
    if cvar:
        assert lay.n_epi == M + 1 and hq.shape[-1] == Nc * udim + 2
    if smooth:
        assert lay.n_sm == 2 * nz


def test_exponential_cone_signatures_raise():
    p, rng = _problems(5, 2, 4)
    t_cqp = _cqps(p, 2, False)[0]
    with pytest.raises(NotImplementedError, match="ROADMAP §1.8, exponential cones"):
        tcomp.build_cone_program(t_cqp, (4, 2, 3), (), (), (None, None), (None, None),
                                 smooth_method="logbarrier")
    with pytest.raises(NotImplementedError, match="ROADMAP §1.8, exponential cones"):
        tcomp.build_cone_program(t_cqp, (4, 2, 3), ((0, (), 1, 0),), ((None,) * 5,),
                                 (None, None), (None, None))


# ---- (b) the serial solve -------------------------------------------------------

def _one(p):
    return {k: np.asarray(v)[None] for k, v in p.items()}


def _port_serial(p, Nc, settings, u_l=None, u_u=None, cvar_k=None, **kw):
    """The port's `composed_cone_solve` on one oracle problem ``p`` (M, ...)."""
    M, udim = p["x0"].shape[0], p["fu"].shape[-1]
    N, xdim = p["f"].shape[1:]
    one = _one(p)
    one.update(reg_x=np.ones((1, M)), reg_u=np.full((1, M), 0.1), slew_reg=np.zeros((1, M)),
               slew_reg0=np.zeros((1, M)), slew_um1=np.zeros((1, M, udim)))
    cvar = None
    if cvar_k is not None:
        nc = Nc * udim
        H, q, Ft, g = particle_H_q(*(tt(one[k]) for k in ARGS15))
        cqp = CondensedQP(H[:, :, :nc, :nc].sum(1), H[:, :, :nc, nc:], H[:, :, nc:, nc:],
                          q[:, :, :nc].sum(1), q[:, :, nc:], Ft, g,
                          tt(one["U_prev"]).reshape(1, M, -1), None, None, None, None)
        c = tcvar.particle_constants(g[0].numpy(), *(p[k] for k in KEYS[4:10]),
                                     np.ones(M), np.full(M, 0.1), np.zeros(M),
                                     np.zeros((M, udim)))
        cvar = tcomp.CvarParts(H, q, torch.from_numpy(c)[None], float(cvar_k),
                               tcomp.COST_ANCHOR_EPS)
    else:
        cqp = assemble_condensed(*(tt(one[k]) for k in ARGS15), Nc=Nc)
    return tcomp.composed_cone_solve(cqp, N, udim, xdim, u_l, u_u, None, None,
                                     settings.get("extra_cstrs", []), settings=settings,
                                     cvar=cvar, **kw)


def _jax_serial(p, Nc, settings, u_l=None, u_u=None):
    M, udim = p["x0"].shape[0], p["fu"].shape[-1]
    return affine_solve_np(*(p[k] for k in KEYS), reg_x=np.ones(M), reg_u=np.full(M, 0.1),
                           slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
                           slew_um1=np.zeros((M, udim)), u_l=u_l, u_u=u_u, x_l=None,
                           x_u=None, Nc=Nc, settings=dict(settings))


def _hold_serial(out_t, out_j):
    (X, U, d), (Xj, Uj, dj) = out_t, out_j
    np.testing.assert_allclose(U, Uj, atol=1e-7, rtol=0)
    np.testing.assert_allclose(X, Xj, atol=1e-7, rtol=0)
    assert set(d) == set(dj)
    assert d["ipm_iters"] == dj["ipm_iters"]
    assert d["ipm_converged"] and d["ipm_converged"] == dj["ipm_converged"]
    assert d["ipm_failed"] == dj["ipm_failed"]
    assert d["solver_state"]["cone_warm_key"] == dj["solver_state"]["cone_warm_key"]
    for a, aj in zip(d["solver_state"]["cone_warm"], dj["solver_state"]["cone_warm"]):
        assert a.shape == np.shape(aj)


def test_serial_cvar_instance_of_test_cvar():
    """tests/test_cvar.py::test_cvar_k1_minimizes_worst_particle's instance
    (seed 30, k = 1, full consensus), then a warm re-solve from the JAX
    solve's state with the SCP residual's forcing."""
    p = oracle.random_problem(np.random.default_rng(30), M=3, N=6, xdim=3, udim=2)
    out_j = _jax_serial(p, 6, dict(k=1))
    out_t = _port_serial(p, 6, dict(k=1), cvar_k=1)
    _hold_serial(out_t, out_j)
    close(torch.from_numpy(out_t[2]["ts"]), out_j[2]["ts"], 1e-7 * np.abs(out_j[2]["ts"]).max())
    assert out_t[2]["ts"].shape == (4,)
    # warm: the JAX state starts the port's solve (and its own round-trips)
    ss = dict(k=1, solver_state=out_j[2]["solver_state"], scp_residual=0.05)
    p2 = dict(p, x0=p["x0"] + 0.01)
    out_j2 = _jax_serial(p2, 6, ss)
    out_t2 = _port_serial(p2, 6, ss, cvar_k=1)
    _hold_serial(out_t2, out_j2)
    assert out_t2[2]["ipm_iters"] < out_t[2]["ipm_iters"]
    warm = cone_warm_from_numpy(out_t[2]["solver_state"]["cone_warm"], "cpu", torch.float64)
    assert len(warm) == 3 and warm[0].dtype == torch.float64
    for a, b in zip(cone_warm_to_numpy(warm), out_t[2]["solver_state"]["cone_warm"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="3 entries"):
        cone_warm_from_numpy(warm[:2], "cpu", torch.float64)


def test_serial_squareplus_instance_of_test_compose():
    """tests/test_compose.py::test_smooth_squareplus_with_extras_matches_oracle's
    instance (seed 41): box rows smoothed, the extras row exact."""
    M, N, xdim, udim, Nc = 2, 5, 3, 2, 2
    rng = np.random.default_rng(41)
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    n_full = Nc * udim + M * (N - Nc) * udim + M * N * xdim
    g = np.zeros(n_full)
    g[:udim] = 1.0
    ec = (1, [], 0, g[None, :], np.zeros((1, 0)), np.array([0.25]), np.zeros(n_full),
          np.zeros(0))
    ss = dict(extra_cstrs=[ec], smooth_cstr="squareplus", smooth_alpha=50.0, smooth_beta=4.0)
    box = dict(u_l=np.full((M, N, udim), -0.4), u_u=np.full((M, N, udim), 0.4))
    out_j = _jax_serial(p, Nc, ss, **box)
    out_t = _port_serial(p, Nc, ss, smooth_method="squareplus", smooth_alpha=50.0,
                         smooth_beta=4.0, **box)
    _hold_serial(out_t, out_j)
    assert out_t[2]["aux"].shape == (2 * (Nc * udim + M * (N - Nc) * udim),)


# ---- (c) F5: an R1 instance that enters through the extras -----------------------

def test_f5_fuzz_socdetect_seed_801_on_the_composed_route():
    """tests/test_fuzz_socdetect.py seed 801: stage cones written as extras.
    HEAD's structured route (the dispatcher's default) fails it (R1); the
    JAX composed route converges, and so does the port's, to 1e-7 of it."""
    seed = 801
    rng = np.random.default_rng(seed)
    M, N, xdim, udim = 2, 6, 3, 2
    Nc = int(rng.integers(0, 4))
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    scale = float(rng.choice([1.0, 1.0, 2.0, 0.5]))
    ec = _stage_cone_rows(M, N, xdim, udim, Nc, rng, n_cones=int(rng.integers(2, 7)),
                          scale=scale, lin_rows=int(rng.integers(0, 2)))
    ss = dict(extra_cstrs=[ec], extras_structured=False)
    out_j = _jax_serial(p, Nc, ss)
    out_t = _port_serial(p, Nc, ss)
    _hold_serial(out_t, out_j)
    print(f"seed 801: composed route converged in {out_t[2]['ipm_iters']} IPM iterations "
          f"(JAX {out_j[2]['ipm_iters']})")


# ---- (d) the numpy helpers ---------------------------------------------------------

def test_numpy_helpers_match_the_jax_package():
    rng = np.random.default_rng(3)
    M, N, xdim, udim, Nc = 2, 6, 3, 2, 2
    n_full = Nc * udim + M * (N - Nc) * udim + M * N * xdim
    ec = _stage_cone_rows(M, N, xdim, udim, Nc, rng, n_cones=4, scale=2.0, lin_rows=1)
    for a, b in zip(text._canon_extras([ec], n_full), jext._canon_extras([ec], n_full)):
        assert len(a) == len(b)
    sig, arr = text._canon_extras([ec], n_full)
    det_t = text.split_stage_u_cones(sig, arr, M, N, Nc, udim)
    det_j = jext.split_stage_u_cones(sig, arr, M, N, Nc, udim)
    for a, b in zip(det_t, det_j):
        np.testing.assert_array_equal(a, b)
    # a state-touching cone is declined by both
    G = np.zeros((3, n_full))
    G[1, -1] = -1.0
    bad = (0, [3], 0, G, np.zeros((3, 0)), np.array([1.0, 0, 0]), np.zeros(n_full), np.zeros(0))
    s2, a2 = text._canon_extras([bad], n_full)
    assert text.split_stage_u_cones(s2, a2, M, N, Nc, udim) is None
    assert jext.split_stage_u_cones(s2, a2, M, N, Nc, udim) is None
    # the ValueErrors, word for word
    for broken in ((2,) + bad[1:], bad[:7] + (np.ones(2),)):
        with pytest.raises(ValueError) as et:
            text._canon_extras([broken], n_full)
        with pytest.raises(ValueError) as ej:
            jext._canon_extras([broken], n_full)
        assert str(et.value) == str(ej.value)
