"""The rest of the IPM's options against the JAX package, f64, on the CPU:
linear extra rows (`ExtraRows`, `map_extras_rows`), the single-solve mode
(``predictor=False``), Gondzio correctors (``gondzio=2``) and the central-path
stop (``mu_target > 0``) of the condensed `ipm_core` against `jax.vmap` of
the JAX `ipm_core`; ``mu_target > 0`` of the Riccati core (with and without
cones) against the JAX `riccati_ipm_core`; and the `build_scp_solver` flags
``ipm_gondzio``, ``ipm_predictor`` and ``mu_target`` against the JAX fused
solver. None of these JAX paths is on the cone route that ROADMAP §3 R1
describes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.jax_scp import build_scp_solver as jbuild
from pmpc_tpu.jax_scp import make_scp_data as jmake
from pmpc_tpu.solvers import ipm as jipm
from pmpc_tpu_torch import torch_scp
from pmpc_tpu_torch.convert import scp_data_from_numpy
from pmpc_tpu_torch.flagship import dubins
from pmpc_tpu_torch.solvers import ipm as tipm
from pmpc_tpu_torch.solvers.reduced import z_to_w
from fixtures import unicycle_step
from test_torch_ipm import B, M, MTOT, N, NC, NCV, NF, UDIM, XDIM, _bounds
from test_torch_reduced import jax_cqp, problem, torch_cqp
from test_torch_soc import B as B2, _jax_riccati, _radius, _torch_riccati, dubins_problem

torch.set_num_threads(1)

KW = dict(iters=40, tol_exp=-9, kappa=0.0)
N_FULL = NCV + M * NF + M * N * XDIM


def _extra_rows(rng, cqp):
    """l = 5 rows over [u_cons; u_free; x]: two restate control upper
    bounds of particle 0 (u <= 0.2), two are dense over controls and
    states, one is inactive (h = +inf). u = 0 is strictly feasible."""
    l = 5
    G = np.zeros((B, l, N_FULL))
    G[:, 0, NCV + 1] = G[:, 1, NCV + 4] = 1.0
    G[:, 2:4] = rng.normal(size=(B, 2, N_FULL)) / np.sqrt(N_FULL)
    x_at_0 = cqp.g.reshape(B, -1).numpy()  # the states at u = 0
    h = np.full((B, l), 0.2)
    h[:, 2:4] = (G[:, 2:4, NCV + M * NF:] * x_at_0[:, None]).sum(-1) \
        + rng.uniform(0.05, 0.2, size=(B, 2))
    h[:, 4] = np.inf
    G[:, 4] = rng.normal(size=(B, N_FULL))
    return G, h


def _both(kw, extras=False, seed=10):
    rng = np.random.default_rng(seed)
    p = problem(seed, B=B, M=M, N=N, xdim=XDIM, udim=UDIM)
    lo, hi = _bounds(rng)
    ref_cqp, cqp = jax_cqp(p, NC), torch_cqp(p, NC)
    inf_x = np.full((B, M, N * XDIM), np.inf)
    jb = jipm.BoxBounds(*map(jnp.asarray, (lo[:, 0, :NCV], hi[:, 0, :NCV], lo[:, :, NCV:],
                                           hi[:, :, NCV:], -inf_x, inf_x)))
    tb = tipm.BoxBounds(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        lo[:, 0, :NCV], hi[:, 0, :NCV], lo[:, :, NCV:], hi[:, :, NCV:])))
    kw = dict(KW, **kw)
    if not extras:
        ref = jax.vmap(lambda c, b: jipm.ipm_core(c, b, has_u=True, has_x=False, **kw))(
            ref_cqp, jb)
        return ref, tipm.ipm_core(cqp, tb, **kw), None
    G, h = _extra_rows(rng, cqp)
    jex = jax.vmap(lambda c, g, h_: jipm.map_extras_rows(c, g, h_, NCV, NF, M, N * XDIM))(
        ref_cqp, jnp.asarray(G), jnp.asarray(h))
    tex = tipm.map_extras_rows(cqp, torch.from_numpy(G), torch.from_numpy(h))
    for a, b in zip(tex, jex):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    ref = jax.vmap(lambda c, b, e: jipm.ipm_core(c, b, has_u=True, has_x=False, ex=e,
                                                 has_ex=True, **kw))(ref_cqp, jb, jex)
    out = tipm.ipm_core(cqp, tb, ex=tex, has_ex=True, **kw)
    return ref, out, (cqp, G, h)


def _hold(ref, out, tol=1e-8):
    (uc_r, uf_r, st_r), (uc, uf, st) = ref, out
    assert np.max(np.abs(uc.numpy() - np.asarray(uc_r))) < tol
    assert np.max(np.abs(uf.numpy() - np.asarray(uf_r))) < tol
    for key in ("iters", "converged", "failed"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(st_r[key]))
    assert st["s"].shape == np.asarray(st_r["s"]).shape
    print("IPM iterations", st["iters"].tolist())


def test_extra_rows_match_vmapped_jax_and_hold():
    ref, out, (cqp, G, h) = _both({}, extras=True)
    _hold(ref, out)
    uc, uf, st = out
    assert st["converged"].all() and st["s"].shape == (B, MTOT + 5)
    w = z_to_w(uc, uf)  # (B, M, NU)
    x = ((cqp.Ft @ w[..., None])[..., 0] + cqp.g).reshape(B, -1)
    z = torch.cat([uc, uf.reshape(B, -1), x], -1).numpy()
    rows = (G * z[:, None]).sum(-1)
    assert (rows[:, :4] <= h[:, :4] + 1e-7).all()
    assert (np.abs(rows[:, :4] - h[:, :4]) < 1e-6).any()  # a row binds


@pytest.mark.parametrize("option", ["predictor_false", "gondzio2", "mu_target"])
def test_condensed_options_match_vmapped_jax(option):
    kw = {"predictor_false": dict(predictor=False), "gondzio2": dict(gondzio=2),
          "mu_target": dict(mu_target=1e-3)}[option]
    ref, out, _ = _both(kw)
    _hold(ref, out)
    st = out[2]
    assert st["converged"].all()
    if option == "mu_target":  # stopped on the central path, not at the solution
        assert (st["mu"] > 5e-4).all() and (st["mu"] < 1.05e-3).all()


@pytest.mark.parametrize("cones", [False, True])
def test_riccati_mu_target_matches_the_jax_core(cones):
    M_, N_, Nc = 3, 10, 3
    p = dubins_problem(5, M_, N_)
    r = np.broadcast_to(_radius(p, Nc, 0.7)[:, None, None], (B2, M_, N_)).copy() \
        if cones else None
    kw = dict(iters=40, tol_exp=-9, mu_target=1e-3, u_box=0.8)
    X_r, U_r, st_r = _jax_riccati(p, Nc, r, **kw)
    X, U, st = _torch_riccati(p, Nc, r, **kw)
    assert np.max(np.abs(U.numpy() - np.asarray(U_r))) < 1e-8
    assert np.max(np.abs(X.numpy() - np.asarray(X_r))) < 1e-8
    for key in ("iters", "converged", "failed"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(st_r[key]))
    assert st["converged"].all() and (st["mu"] > 5e-4).all()


@pytest.mark.parametrize("option", [dict(ipm_gondzio=2), dict(ipm_predictor=False),
                                    dict(mu_target=1e-3)])
def test_build_scp_solver_flags_match_the_vmapped_jax_fused_solver(option):
    Mb, Nb, Ncb = 4, 8, 2
    rng = np.random.default_rng(3)
    d = jmake(np.ones((Mb, 4)) + 0.05 * rng.normal(size=(Mb, 4)),
              np.tile(np.eye(4), (Mb, Nb, 1, 1)), np.tile(1e-2 * np.eye(2), (Mb, Nb, 1, 1)),
              reg_x=1.0, reg_u=0.1, u_l=-np.ones((Mb, Nb, 2)), u_u=np.ones((Mb, Nb, 2)))
    stack = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (2,) + a.shape), d)
    stack = stack._replace(x0=stack.x0 + jnp.asarray(0.05 * rng.normal(size=stack.x0.shape)))
    kw = dict(N=Nb, xdim=4, udim=2, M=Mb, Nc=Ncb, max_it=6, res_tol=1e-6,
              has_u_bounds=True, ipm_iters=30, collect_stats=True, **option)
    X_r, U_r, info_r = jax.vmap(jbuild(unicycle_step, **kw))(stack)
    X, U, info = torch_scp.build_scp_solver(dubins, **kw)(
        scp_data_from_numpy(stack, "cpu", torch.float64))
    assert np.max(np.abs(U.numpy() - np.asarray(U_r))) < 1e-8
    np.testing.assert_array_equal(info["scan_stats"]["ipm_iters"].numpy(),
                                  np.asarray(info_r["scan_stats"]["ipm_iters"]))
    assert U.abs().max() <= 1 + 1e-8
