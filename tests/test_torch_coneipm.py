"""The dense symmetric-cone IPM of the port (`solvers.coneipm.cone_qp_solve`)
against the JAX package's, f64, on the CPU.

The port solves a batch (B, ...) in one call; the JAX solver takes one
program and runs once per lane. Every case holds v to 1e-8 and the IPM
iteration counts equal, lane for lane: a nonnegative + narrow-SOC program
(the diagonally scaled gram), a CVaR epigraph program whose cones are 32
wide (the constant J-gram), programs with only nonnegative rows, only cones
(each gets the neutral dummy of the other family) or neither (the Newton
shortcut), and a warm start from a previous solve. The per-lane early exit
is checked on a batch whose lanes need different counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pmpc_tpu.solvers import coneipm as jcone
from pmpc_tpu.solvers import compose as jcomp
from pmpc_tpu.solvers.reduced import particle_H_q as j_particle_H_q
from pmpc_tpu_torch.solvers import coneipm as tcone
from test_torch_riccati import close, tt
from test_torch_soc import dubins_problem

import jax

torch.set_num_threads(1)

TOL = 1e-8
FIELDS = ("P", "q", "Gl", "hl", "Gq", "hq")


def _random_program(seed, B, nv, ml, c, p):
    """B programs (numpy, (B, ...)): P SPD, nonnegative rows with h > 0
    (v = 0 strictly feasible), c cones of size p around v = 0."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, nv, nv))
    P = A @ np.swapaxes(A, -1, -2) / nv + 0.1 * np.eye(nv)
    q = 3.0 * rng.normal(size=(B, nv))
    Gl = rng.normal(size=(B, ml, nv))
    hl = rng.uniform(0.2, 1.0, size=(B, ml))
    Gq = 0.5 * rng.normal(size=(B, c, p, nv))
    hq = np.zeros((B, c, p))
    hq[..., 0] = rng.uniform(0.5, 1.5, size=(B, c))
    return dict(P=P, q=q, Gl=Gl, hl=hl, Gq=Gq, hq=hq)


def _solve_both(prog, warm=None, **kw):
    """The port's batched solve and the JAX solve of each lane: (port
    outputs, list of JAX outputs)."""
    out_t = tcone.cone_qp_solve(tcone.ConeLP(*(tt(prog[f]) for f in FIELDS)),
                                warm=None if warm is None else warm[0], **kw)
    B = prog["q"].shape[0]
    out_j = [jcone.cone_qp_solve(jcone.ConeLP(*(jnp.asarray(prog[f][b]) for f in FIELDS)),
                                 warm=None if warm is None else warm[1][b], **kw)
             for b in range(B)]
    return out_t, out_j


def _hold(out_t, out_j, scale=1.0):
    """v to TOL (times ``scale``), the padded shapes and the IPM counts."""
    v, s, z, st = out_t
    for b, (vj, sj, zj, stj) in enumerate(out_j):
        close(v[b], vj, TOL * scale)
        for a, aj in zip(s + z, sj + zj):
            assert a[b].shape == aj.shape
        assert int(st["iters"][b]) == int(stj["iters"]), (b, st["iters"], stj["iters"])
        assert bool(st["converged"][b]) == bool(stj["converged"])
    return [int(i) for i in st["iters"]]


KW = dict(iters=60, tol_exp=-10, kappa=1e-12)


def test_nonneg_and_narrow_soc():
    prog = _random_program(11, B=3, nv=9, ml=6, c=4, p=3)
    its = _hold(*_solve_both(prog, **KW))
    assert len(set(its)) > 1  # the lanes stop at different counts


def _cvar_program(seed):
    """The k-worst epigraph program of a Dubins subproblem (M = 2, N = 15,
    full consensus): two cones of size 32, so `pmax >= 32` takes the
    constant J-gram. Built by the JAX package's composer, per lane."""
    M, N, udim = 2, 15, 2
    p = dubins_problem(seed, M, N)
    B, nc = p["x0"].shape[0], N * udim
    progs = []
    for b in range(B):
        args = [jnp.asarray(p[k][b]) for k in ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q",
                                             "R", "X_ref", "U_ref", "reg_x", "reg_u",
                                             "slew_reg", "slew_reg0", "slew_um1")]
        H_per, q_per, Ft, g = jax.vmap(j_particle_H_q)(*args)
        cqp = jcomp.CondensedQP(Hcc=H_per.sum(0), Hcf=H_per[:, :nc, nc:], Hff=H_per[:, nc:, nc:],
                                qc=q_per.sum(0), qf=q_per[:, nc:], Ft=Ft, g=g,
                                w_prev=args[5].reshape(M, -1))
        c_per = jcomp.particle_constants_jnp(g, *args[4:10], args[10], args[11], args[13],
                                             args[14])
        cvar = jcomp.CvarParts(H_per=H_per, q_per=q_per, c_per=c_per, k=jnp.asarray(1.0),
                               eps=jnp.asarray(jcomp.COST_ANCHOR_EPS))
        P, q, Gl, hl, blocks, _, _, _, _, lay = jcomp.build_cone_program(
            cqp, (N, udim, 4), (), (), (None, None), (None, None), cvar=cvar)
        Gq, hq = jcomp.pad_socs(blocks, lay.nv, P.dtype)
        progs.append(dict(P=P, q=q, Gl=Gl, hl=hl, Gq=Gq, hq=hq))
    return {f: np.stack([np.asarray(pr[f]) for pr in progs]) for f in FIELDS}


def test_wide_cone_cvar_program_takes_the_j_gram():
    prog = _cvar_program(5)
    assert prog["hq"].shape[-1] == 32 and prog["Gl"].shape[1] == 2
    out_t, out_j = _solve_both(prog, iters=100, tol_exp=-9, kappa=1e-10)
    # the epigraph variables y, t are particle costs (~1e2 here): v is held
    # to 1e-8 relative to its largest entry
    _hold(out_t, out_j, scale=float(np.abs(out_t[0]).max()))
    assert out_t[3]["converged"].all()


@pytest.mark.parametrize("case", ["lp_only", "soc_only", "unconstrained"])
def test_empty_families(case):
    prog = _random_program(21, B=2, nv=7, ml=5, c=3, p=4)
    if case != "soc_only":  # no cones: the JAX solver adds a neutral dummy cone
        prog["Gq"], prog["hq"] = prog["Gq"][:, :0], prog["hq"][:, :0]
    if case != "lp_only":  # no rows: a neutral dummy row
        prog["Gl"], prog["hl"] = prog["Gl"][:, :0], prog["hl"][:, :0]
    out_t, out_j = _solve_both(prog, **KW)
    _hold(out_t, out_j)
    v, (sl, sq), (zl, zq), st = out_t
    if case == "unconstrained":  # the Newton shortcut: no iteration
        assert st["iters"].eq(0).all() and st["converged"].all()
        assert sl.shape == (2, 0) and sq.shape == (2, 0, 4)
        close(v, -np.linalg.solve(prog["P"], prog["q"][..., None])[..., 0], TOL)
    else:  # the padded shapes of the JAX solver
        assert sl.shape[1] >= 1 and sq.shape[1] >= 1
        assert st["converged"].all()


def test_warm_start_from_a_previous_solve():
    prog = _random_program(31, B=3, nv=8, ml=6, c=3, p=3)
    (v, s, z, _), out_j = _solve_both(prog, **KW)
    prog2 = dict(prog, hl=prog["hl"] + 0.05, hq=prog["hq"] * 1.05)
    warm_t = (v, z[0], z[1])
    warm_j = [(o[0], o[2][0], o[2][1]) for o in out_j]
    out_t2, out_j2 = _solve_both(prog2, warm=(warm_t, warm_j), **KW)
    its_warm = _hold(out_t2, out_j2)
    its_cold = _hold(*_solve_both(prog2, **KW))
    assert sum(its_warm) < sum(its_cold)


def _hold_trace(p_t, prog, kw, rel=None):
    """``debug_trace=True``: the fixed-length run against the JAX scan, lane by
    lane, key for key and entry for entry (the entries after a lane is done
    included: both compute them on the frozen state). mu, rp and rd to 1e-9
    times (1 + the key's largest entry); the step lengths a, a_aff and sigma
    to 1e-3: they are in [0, 1], and in the last steps and on a converged
    lane's frozen point (mu below its tolerance) they are ratios of
    quantities at the rounding level, where 1e-4 is too tight; bad equal.
    With ``rel``, mu, rp and rd are held entry for entry to ``rel`` times
    the JAX entry (plus 1e-11) instead. The returned point and counts equal
    the early-exit solve's exactly."""
    v, _, _, st = tcone.cone_qp_solve(p_t, debug_trace=True, **kw)
    v0, _, _, st0 = tcone.cone_qp_solve(p_t, **kw)
    assert torch.equal(v, v0) and torch.equal(st["iters"], st0["iters"])
    tr = st["trace"]
    assert set(tr) == {"mu", "a", "a_aff", "sigma", "rp", "rd", "bad"}
    for b in range(p_t.q.shape[0]):
        stj = jcone.cone_qp_solve(jcone.ConeLP(*(jnp.asarray(prog[f][b]) for f in FIELDS)),
                                  debug_trace=True, **kw)[3]
        assert set(stj["trace"]) == set(tr) and int(stj["iters"]) == int(st["iters"][b])
        for k, xj in stj["trace"].items():
            xj, x = np.asarray(xj), tr[k][b].numpy()
            assert x.shape == xj.shape == (kw["iters"],), k
            if k == "bad":
                assert (x == xj).all()
                continue
            if k in ("a", "a_aff", "sigma"):
                tol = 1e-3
            elif rel is None:
                tol = 1e-9 * (1 + np.abs(xj).max())
            else:
                tol = rel * np.abs(xj) + 1e-11
            assert (np.abs(x - xj) <= tol).all(), (b, k, np.abs(x - xj).max())
    return st


def test_options():
    prog = _random_program(41, B=2, nv=6, ml=4, c=2, p=3)
    p_t = tcone.ConeLP(*(tt(prog[f]) for f in FIELDS))
    # the trace runs past convergence: iters 30 > the lanes' 8
    st = _hold_trace(p_t, prog, dict(KW, iters=30))
    assert (st["iters"] < 30).all() and st["converged"].all()
    # a per-lane dynamic tolerance loosens lane 1 only
    tight = tcone.cone_qp_solve(p_t, **KW)[3]["iters"]
    per_lane = tcone.cone_qp_solve(p_t, tol_dynamic=torch.tensor([0.0, 1e-3]), **KW)[3]["iters"]
    assert per_lane[0] == tight[0] and per_lane[1] < tight[1]
    # the host-side helpers
    it, te, ka, tol_eff, tol_dyn, warm = tcone.cone_host_setup(
        {"scp_residual": 0.1}, torch.float64, "k", "cone_warm")
    assert (it, te, ka, tol_dyn, warm) == (100, -8, 1e-10, 1e-5, None) and tol_eff == 1e-5
    assert tcone.cone_host_setup({}, np.float32, "k", "w")[:3] == (35, -5, 1e-7)
    assert tcone.cone_host_stats(dict(mu=1.0, iters=7, converged=False), 1e-8)["ipm_failed"]


@pytest.mark.parametrize("case", ["lanes_stop_apart", "lp_only"])
def test_debug_trace(case):
    """The trace on a batch whose lanes converge at different counts (a done
    lane's entries run on while the others iterate), and on a program with no
    cones (the neutral dummy cone is traced like a real one). There lane 1's
    corrector step at iteration 4 is a ratio against a slack step that
    cancels, so the packages' later mu, rp and rd part at 1e-9 of the
    largest entry: that case holds them to 1e-5 of each entry."""
    prog = _random_program(11, B=3, nv=9, ml=6, c=4, p=3)
    if case == "lp_only":
        prog["Gq"], prog["hq"] = prog["Gq"][:, :0], prog["hq"][:, :0]
    p_t = tcone.ConeLP(*(tt(prog[f]) for f in FIELDS))
    st = _hold_trace(p_t, prog, dict(KW, iters=25), rel=1e-5 if case == "lp_only" else None)
    if case == "lanes_stop_apart":
        assert len(set(st["iters"].tolist())) > 1
