"""The box-only `ipm_core` against `jax.vmap(pmpc_tpu.solvers.ipm.ipm_core)`,
f64, over B = 3 lanes with different bounds and warm points."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.solvers import ipm as jipm
from pmpc_tpu_torch.convert import warm_from_numpy
from pmpc_tpu_torch.solvers import ipm as tipm
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
        lane = lambda t: t[b:b + 1]
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
    for kw in (dict(has_x=True), dict(has_soc=True), dict(gondzio=1),
               dict(predictor=False), dict(mu_target=0.1), dict(has_ex=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tipm.ipm_core(cqp, bounds, **kw)
