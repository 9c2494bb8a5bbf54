"""The box `ipm_core` (control bounds, state boxes) against
`jax.vmap(pmpc_tpu.solvers.ipm.ipm_core)`, f64, over B = 3 lanes with
different bounds and warm points."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.solvers import ipm as jipm
from pmpc_tpu_torch.convert import warm_from_numpy
from pmpc_tpu_torch.solvers import ipm as tipm
from pmpc_tpu_torch.solvers.reduced import solve_eq, z_to_w
from test_torch_reduced import jax_cqp, problem, torch_cqp

torch.set_num_threads(1)

B, M, N, NC, UDIM, XDIM = 3, 3, 6, 2, 2, 4
NCV, NF = NC * UDIM, (N - NC) * UDIM
MTOT = 2 * NCV + 2 * M * NF
KW = dict(iters=40, tol_exp=-9, kappa=0.0)


def _bounds(rng):
    """Per-lane bounds: tight, loose with absent entries, asymmetric."""
    lo = np.empty((B, M, N * UDIM))
    hi = np.empty((B, M, N * UDIM))
    lo[0], hi[0] = -0.3, 0.3
    lo[1], hi[1] = -1.0, 1.0
    lo[1, :, ::3], hi[1, :, 1::4] = -np.inf, np.inf
    lo[2] = -rng.uniform(0.1, 0.5, size=(M, N * UDIM))
    hi[2] = rng.uniform(0.5, 2.0, size=(M, N * UDIM))
    return lo, hi


def _warm(rng):
    uc = 0.05 * rng.normal(size=(B, NCV))
    uf = 0.05 * rng.normal(size=(B, M, NF))
    return (uc, uf, rng.uniform(0.5, 2.0, size=(B, MTOT)),
            rng.uniform(0.01, 1.0, size=(B, MTOT)))


def _solve_both(seed, warm_start, tol_dynamic):
    rng = np.random.default_rng(seed)
    p = problem(seed, B=B, M=M, N=N, xdim=XDIM, udim=UDIM)
    lo, hi = _bounds(rng)
    warm = _warm(rng) if warm_start else None
    tol_dyn = np.array([1e-3, 1e-6, 1e-9]) if tol_dynamic else None

    ref_cqp = jax_cqp(p, NC)
    inf_x = np.full((B, M, N * XDIM), np.inf)
    jb = jipm.BoxBounds(lo_c=jnp.asarray(lo[:, 0, :NCV]), hi_c=jnp.asarray(hi[:, 0, :NCV]),
                        lo_f=jnp.asarray(lo[:, :, NCV:]), hi_f=jnp.asarray(hi[:, :, NCV:]),
                        lo_x=jnp.asarray(-inf_x), hi_x=jnp.asarray(inf_x))

    def one(c, b, w, t):
        return jipm.ipm_core(c, b, has_u=True, has_x=False, warm=w,
                             tol_dynamic=t, **KW)

    jw = None if warm is None else tuple(map(jnp.asarray, warm))
    jt = None if tol_dyn is None else jnp.asarray(tol_dyn)
    ref = jax.vmap(one)(ref_cqp, jb, jw, jt)

    tb = tipm.BoxBounds(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        lo[:, 0, :NCV], hi[:, 0, :NCV], lo[:, :, NCV:], hi[:, :, NCV:])))
    out = tipm.ipm_core(
        torch_cqp(p, NC), tb, warm=warm_from_numpy(warm, "cpu", torch.float64),
        tol_dynamic=None if tol_dyn is None else torch.from_numpy(tol_dyn), **KW)
    return ref, out


@pytest.mark.parametrize("warm_start,tol_dynamic",
                         [(False, False), (True, False), (True, True), (False, True)])
def test_ipm_core_matches_vmapped_jax(warm_start, tol_dynamic):
    (uc_r, uf_r, st_r), (uc, uf, st) = _solve_both(10, warm_start, tol_dynamic)
    assert np.max(np.abs(uc.numpy() - np.asarray(uc_r))) < 1e-8
    assert np.max(np.abs(uf.numpy() - np.asarray(uf_r))) < 1e-8
    np.testing.assert_array_equal(st["iters"].numpy(), np.asarray(st_r["iters"]))
    np.testing.assert_array_equal(st["converged"].numpy(),
                                  np.asarray(st_r["converged"]))
    np.testing.assert_array_equal(st["failed"].numpy(), np.asarray(st_r["failed"]))
    assert st["converged"].all()
    if tol_dynamic:  # the loose lane stops earlier than the tight one
        assert st["iters"][0] < st["iters"][2]


def test_lane_alone_equals_lane_in_batch():
    rng = np.random.default_rng(20)
    p = problem(20, B=B, M=M, N=N, xdim=XDIM, udim=UDIM)
    lo, hi = _bounds(rng)
    warm = warm_from_numpy(_warm(rng), "cpu", torch.float64)
    tol_dyn = torch.tensor([1e-3, 1e-6, 1e-9], dtype=torch.float64)
    cqp = torch_cqp(p, NC)
    bounds = tipm.BoxBounds(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        lo[:, 0, :NCV], hi[:, 0, :NCV], lo[:, :, NCV:], hi[:, :, NCV:])))
    uc, uf, st = tipm.ipm_core(cqp, bounds, warm=warm, tol_dynamic=tol_dyn, **KW)
    for b in range(B):
        lane = lambda t: None if t is None else t[b:b + 1]
        uc1, uf1, st1 = tipm.ipm_core(
            type(cqp)(*map(lane, cqp)), tipm.BoxBounds(*map(lane, bounds)),
            warm=tuple(map(lane, warm)), tol_dynamic=lane(tol_dyn), **KW)
        assert st1["iters"].item() == st["iters"][b].item()
        assert (uc1[0] - uc[b]).abs().max() < 1e-12
        assert (uf1[0] - uf[b]).abs().max() < 1e-12


def test_unported_flags_raise():
    p = problem(0, B=1, M=2, N=4)
    cqp = torch_cqp(p, 1)
    inf_c = torch.full((1, 2), torch.inf, dtype=torch.float64)
    inf_f = torch.full((1, 2, 6), torch.inf, dtype=torch.float64)
    bounds = tipm.BoxBounds(-inf_c, inf_c, -inf_f, inf_f)
    # every flag of the JAX core is ported (tests/test_torch_soc.py,
    # tests/test_torch_ipm_options.py); a flag without its data is refused
    for kw, what in ((dict(has_soc=True), "socs"), (dict(has_ex=True), "extra rows")):
        with pytest.raises(ValueError, match=what):
            tipm.ipm_core(cqp, bounds, **kw)
    for kw in (dict(gondzio=1), dict(predictor=False), dict(mu_target=0.1)):
        uc, uf, st = tipm.ipm_core(cqp, bounds, **kw)
        assert torch.isfinite(uf).all() and st["converged"].all()


def _solve_both_xbox(seed, has_u, warm_start):
    """State boxes on every lane: a band around the states at u = 0 (strictly
    inside every control box, so the problem is strictly feasible), narrow
    enough that the unconstrained solution leaves it; absent on some rows."""
    rng = np.random.default_rng(seed)
    p = problem(seed, B=B, M=M, N=N, xdim=XDIM, udim=UDIM)
    lo, hi = _bounds(rng)
    ref_cqp, cqp = jax_cqp(p, NC), torch_cqp(p, NC)
    g = cqp.g.numpy()
    lo_x = g - rng.uniform(0.05, 1.0, size=g.shape)
    hi_x = g + rng.uniform(0.05, 1.0, size=g.shape)
    lo_x[:, :, ::5], hi_x[:, :, 2::7] = -np.inf, np.inf
    uc0, uf0 = solve_eq(cqp)
    x_free = ((cqp.Ft @ z_to_w(uc0, uf0)[..., None])[..., 0]).numpy() + g
    assert ((x_free < lo_x) | (x_free > hi_x)).reshape(B, -1).any(-1).all()
    warm = None
    if warm_start:
        mtot = MTOT + 2 * M * N * XDIM
        warm = _warm(rng)[:2] + (rng.uniform(0.5, 2.0, size=(B, mtot)),
                                 rng.uniform(0.01, 1.0, size=(B, mtot)))
    kw = dict(KW, iters=60, has_u=has_u, has_x=True)

    jb = jipm.BoxBounds(*map(jnp.asarray, (
        lo[:, 0, :NCV], hi[:, 0, :NCV], lo[:, :, NCV:], hi[:, :, NCV:], lo_x, hi_x)))
    jw = None if warm is None else tuple(map(jnp.asarray, warm))
    ref = jax.vmap(lambda c, b, w: jipm.ipm_core(c, b, warm=w, **kw))(
        ref_cqp, jb, jw)
    tb = tipm.BoxBounds(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        lo[:, 0, :NCV], hi[:, 0, :NCV], lo[:, :, NCV:], hi[:, :, NCV:], lo_x, hi_x)))
    out = tipm.ipm_core(cqp, tb, warm=warm_from_numpy(warm, "cpu", torch.float64),
                        **kw)
    x = ((cqp.Ft @ z_to_w(out[0], out[1])[..., None])[..., 0] + cqp.g).numpy()
    return ref, out, (x, lo_x, hi_x, lo, hi)


@pytest.mark.parametrize("has_u,warm_start",
                         [(True, False), (True, True), (False, False), (False, True)])
def test_ipm_core_state_boxes_match_vmapped_jax(has_u, warm_start):
    (uc_r, uf_r, st_r), (uc, uf, st), (x, lo_x, hi_x, lo, hi) = \
        _solve_both_xbox(30, has_u, warm_start)
    assert np.max(np.abs(uc.numpy() - np.asarray(uc_r))) < 1e-8
    assert np.max(np.abs(uf.numpy() - np.asarray(uf_r))) < 1e-8
    np.testing.assert_array_equal(st["iters"].numpy(), np.asarray(st_r["iters"]))
    np.testing.assert_array_equal(st["converged"].numpy(),
                                  np.asarray(st_r["converged"]))
    np.testing.assert_array_equal(st["failed"].numpy(), np.asarray(st_r["failed"]))
    assert st["s"].shape == np.asarray(st_r["s"]).shape
    assert st["converged"].all()
    assert (x >= lo_x - 1e-6).all() and (x <= hi_x + 1e-6).all()
    u = z_to_w(uc, uf).numpy()
    in_box = (u >= lo - 1e-6).all() and (u <= hi + 1e-6).all()
    if has_u:
        assert in_box
    else:  # the control bounds in `bounds` are ignored
        assert not in_box
