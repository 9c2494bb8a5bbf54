"""`pmpc_tpu_torch.solvers.reduced` against `pmpc_tpu.solvers.reduced`, f64.

The JAX functions take one (M, ...) problem and are mapped over the B
scenarios with `jax.vmap`; the port takes the (B, M, ...) batch."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.solvers import reduced as jred
from pmpc_tpu_torch.solvers import reduced as tred

torch.set_num_threads(1)

ARGS = ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref",
        "reg_x", "reg_u", "slew_reg", "slew_reg0", "slew_um1")


def problem(seed, B=2, M=3, N=6, xdim=4, udim=2):
    """A random batch of linearized problems, numpy f64, (B, M, ...)."""
    rng = np.random.default_rng(seed)
    lead = (B, M)
    G = rng.normal(size=lead + (N, xdim, xdim))
    H = rng.normal(size=lead + (N, udim, udim))
    return dict(
        x0=rng.normal(size=lead + (xdim,)),
        f=rng.normal(size=lead + (N, xdim)),
        fx=np.eye(xdim) + 0.1 * rng.normal(size=lead + (N, xdim, xdim)),
        fu=rng.normal(size=lead + (N, xdim, udim)),
        X_prev=rng.normal(size=lead + (N, xdim)),
        U_prev=0.3 * rng.normal(size=lead + (N, udim)),
        Q=G @ np.swapaxes(G, -1, -2) / xdim + np.eye(xdim),
        R=0.1 * (H @ np.swapaxes(H, -1, -2) / udim + np.eye(udim)),
        X_ref=rng.normal(size=lead + (N, xdim)),
        U_ref=2.0 * rng.normal(size=lead + (N, udim)),
        reg_x=rng.uniform(0.5, 1.5, size=lead),
        reg_u=rng.uniform(0.05, 0.2, size=lead),
        slew_reg=rng.uniform(0.0, 0.5, size=lead),
        slew_reg0=rng.uniform(0.0, 0.5, size=lead),
        slew_um1=rng.normal(size=lead + (udim,)),
    )


def to_torch(p):
    return {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in p.items()}


def jax_cqp(p, Nc, weights=None, scale_slew_target=True):
    fn = partial(jred.assemble_condensed, Nc=Nc,
                 scale_slew_target=scale_slew_target)
    args = [jnp.asarray(p[k]) for k in ARGS]
    if weights is None:
        return jax.vmap(lambda *a: fn(*a))(*args)
    return jax.vmap(lambda w, *a: fn(*a, weights=w))(jnp.asarray(weights), *args)


def torch_cqp(p, Nc, weights=None, scale_slew_target=True):
    t = to_torch(p)
    return tred.assemble_condensed(
        *(t[k] for k in ARGS), Nc=Nc,
        weights=None if weights is None else torch.from_numpy(weights),
        scale_slew_target=scale_slew_target)


def _close(a, b, tol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:  # an absent block (nc = 0 or nf = 0): the shape is the check
        return
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("weighted,scale_slew_target",
                         [(False, True), (True, True), (True, False)])
def test_assemble_condensed_matches_jax(weighted, scale_slew_target):
    p = problem(0)
    weights = np.random.default_rng(1).uniform(0.2, 1.0, size=(2, 3)) \
        if weighted else None
    ref = jax_cqp(p, 2, weights, scale_slew_target)
    out = torch_cqp(p, 2, weights, scale_slew_target)
    for name in tred.CondensedQP._fields:
        _close(getattr(out, name), getattr(ref, name))


def test_arrow_factor_diag_apply_and_recover_match_jax():
    p = problem(2)
    Nc, N = 2, 6
    ref, out = jax_cqp(p, Nc), torch_cqp(p, Nc)
    rng = np.random.default_rng(3)
    B, M, nc, nf = 2, 3, out.nc, out.nf
    wc, wf = rng.uniform(0.1, 5.0, size=(B, nc)), rng.uniform(0.1, 5.0, size=(B, M, nf))
    bc, bf = rng.normal(size=(B, nc)), rng.normal(size=(B, M, nf))

    def jax_solve(Hcc, Hcf, Hff, wc_, wf_, bc_, bf_):
        F = jred.arrow_factor_diag(Hcc, Hcf, Hff, wc_, wf_, jitter=1e-7)
        return jred.arrow_apply(F, bc_, bf_)

    uc_ref, uf_ref = jax.vmap(jax_solve)(ref.Hcc, ref.Hcf, ref.Hff, *map(
        jnp.asarray, (wc, wf, bc, bf)))
    F = tred.arrow_factor_diag(out.Hcc, out.Hcf, out.Hff, *map(
        torch.from_numpy, (wc, wf)), jitter=1e-7)
    uc, uf = tred.arrow_apply(F, *map(torch.from_numpy, (bc, bf)))
    _close(uc, uc_ref)
    _close(uf, uf_ref)
    # the solve is against K = H + diag([wc; wf]) + jitter I
    Hz_c, Hz_f = tred.H_apply_factored(out, uc, uf)
    _close(Hz_c + (torch.from_numpy(wc) + 1e-7) * uc, bc)
    _close(Hz_f + (torch.from_numpy(wf) + 1e-7) * uf, bf)

    X_ref, U_ref = jax.vmap(partial(jred.recover_XU, N=N))(
        ref, jnp.asarray(uc_ref), jnp.asarray(uf_ref))
    X, U = tred.recover_XU(out, uc, uf, N=N)
    _close(X, X_ref)
    _close(U, U_ref)


def test_cold_arrow_factor_matches_jax():
    p = problem(4)
    ref, out = jax_cqp(p, 2), torch_cqp(p, 2)
    uc_ref, uf_ref = jax.vmap(lambda c: jred.arrow_apply(
        jred.arrow_factor(c.Hcc, c.Hcf, c.Hff), -c.qc, -c.qf))(ref)
    uc, uf = tred.arrow_apply(tred.arrow_factor(out.Hcc, out.Hcf, out.Hff),
                              -out.qc, -out.qf)
    _close(uc, uc_ref)
    _close(uf, uf_ref)


@pytest.mark.parametrize("M,Nc", [(3, 2), (1, 0), (3, 6)])
def test_solve_eq_and_arrow_branches_match_jax(M, Nc):
    """The unconstrained solve with its two refinement rounds; (1, 0) is the
    single-particle layout (nc = 0), (3, 6) the all-consensus one (nf = 0)."""
    p = problem(5, M=M)
    ref, out = jax_cqp(p, Nc), torch_cqp(p, Nc)
    uc_ref, uf_ref = jax.vmap(jred.solve_eq)(ref)
    uc, uf = tred.solve_eq(out)
    assert uc.shape == (2, Nc * 2) and uf.shape == (2, M, (6 - Nc) * 2)
    _close(uc, uc_ref)
    _close(uf, uf_ref)
    # the solution is the stationary point: H z + q = 0, in factored form
    Hc, Hf = tred.H_apply_factored(out, uc, uf)
    _close(Hc + out.qc, np.zeros_like(out.qc))
    _close(Hf + out.qf, np.zeros_like(out.qf))
    # one factor/apply pair without refinement against the JAX pair
    rng = np.random.default_rng(6)
    bc, bf = rng.normal(size=uc.shape), rng.normal(size=uf.shape)
    yc_ref, yf_ref = jax.vmap(lambda c, a, b: jred.arrow_apply(
        jred.arrow_factor(c.Hcc, c.Hcf, c.Hff, jitter=1e-7), a, b))(
            ref, jnp.asarray(bc), jnp.asarray(bf))
    yc, yf = tred.arrow_apply(
        tred.arrow_factor(out.Hcc, out.Hcf, out.Hff, jitter=1e-7),
        torch.from_numpy(bc), torch.from_numpy(bf))
    _close(yc, yc_ref)
    _close(yf, yf_ref)


def _arrow_system(seed, M, nc, nf):
    """A seeded arrow system, numpy f64: SPD per-particle blocks and a
    consensus block large enough that the whole matrix is SPD."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, nf, nf))
    Hff = A @ np.swapaxes(A, -1, -2) / max(nf, 1) + np.eye(nf)
    Hcf = 0.3 * rng.normal(size=(M, nc, nf))
    C = rng.normal(size=(nc, nc))
    Hcc = C @ C.T / max(nc, 1) + (1.0 + 0.1 * M * nf) * np.eye(nc)
    return Hcc, Hcf, Hff, rng.normal(size=nc), rng.normal(size=(M, nf))


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
@pytest.mark.parametrize("M,nc,nf", [(4, 3, 7), (1, 0, 9), (3, 5, 0)])
def test_solve_arrow_matches_jax(M, nc, nf, jitter):
    """`solve_arrow` on one system against the JAX function (1e-10), then on
    a (2,)-batch of systems (leading axes) lane by lane, and the solution
    against numpy's dense solve of the assembled matrix."""
    sys_ = _arrow_system(7, M, nc, nf)
    uc_j, uf_j = jred.solve_arrow(*map(jnp.asarray, sys_), jitter=jitter)
    uc, uf = tred.solve_arrow(*map(torch.from_numpy, sys_), jitter=jitter)
    assert uc.shape == (nc,) and uf.shape == (M, nf)
    _close(uc, uc_j)
    _close(uf, uf_j)
    Hcc, Hcf, Hff, qc, qf = sys_
    K = np.zeros((nc + M * nf,) * 2)
    K[:nc, :nc] = Hcc
    for i in range(M):
        f = slice(nc + i * nf, nc + (i + 1) * nf)
        K[:nc, f], K[f, :nc], K[f, f] = Hcf[i], Hcf[i].T, Hff[i]
    z = np.linalg.solve(K + jitter * np.eye(len(K)), -np.concatenate([qc, qf.reshape(-1)]))
    _close(np.concatenate([uc.numpy(), uf.numpy().reshape(-1)]), z, 1e-9)
    two = [sys_, _arrow_system(8, M, nc, nf)]
    ucb, ufb = tred.solve_arrow(*(torch.from_numpy(np.stack(a)) for a in zip(*two)),
                                jitter=jitter)
    for b, s in enumerate(two):
        ucj, ufj = jred.solve_arrow(*map(jnp.asarray, s), jitter=jitter)
        _close(ucb[b], ucj)
        _close(ufb[b], ufj)
