"""`pmpc_tpu_torch.solvers.riccati` and the Cholesky helpers of
`pmpc_tpu_torch.ops.linalg` against the JAX package, f64, on the CPU.

Inputs come from `oracle.random_problem` with a numpy seed. Every function
runs with a leading B = 2 of different data and is held against `jax.vmap`
(over B, and over the particles where the JAX function takes one) of its
twin: 1e-12 for the Cholesky helpers, 1e-10 for the sweeps."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle
from pmpc_tpu.ops import linalg as jlinalg
from pmpc_tpu.solvers import riccati as jric
from pmpc_tpu_torch.ops import linalg as tlinalg
from pmpc_tpu_torch.solvers import riccati as tric

torch.set_num_threads(1)

B = 2
SHAPES = [(3, 10, 3), (2, 8, 0), (1, 12, 0), (4, 12, 12)]  # (M, N, Nc)
KEYS = ["x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref"]
TOL = 1e-10


def problem(seed, M, N, xdim=4, udim=2):
    """B stacked `oracle.random_problem`s plus per-particle regularization
    and slew terms: a dict of (B, M, ...) numpy arrays."""
    rng = np.random.default_rng(seed)
    ps = [oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim) for _ in range(B)]
    p = {k: np.stack([q[k] for q in ps]) for k in KEYS}
    p["reg_x"] = rng.uniform(0.5, 1.5, size=(B, M))
    p["reg_u"] = rng.uniform(0.05, 0.2, size=(B, M))
    p["slew_reg"] = rng.uniform(0.1, 0.5, size=(B, M))
    p["slew_reg0"] = rng.uniform(0.1, 0.5, size=(B, M))
    p["slew_um1"] = 0.1 * rng.normal(size=(B, M, udim))
    return p


def tt(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b), initial=0.0) < tol


def vmap2(fn):
    return jax.vmap(jax.vmap(fn))


def stage_terms(p, slew):
    """JAX stage data of problem ``p`` (B, M, ...), slew-augmented or not:
    (x0, c, A, B, Qt, xt, Rt, ut)."""
    args = [jnp.asarray(p[k]) for k in KEYS + ["reg_x", "reg_u"]]
    c, Qt, xt, Rt, ut = vmap2(jric._scp_stage_terms)(*args)
    x0, A, Bm = jnp.asarray(p["x0"]), jnp.asarray(p["fx"]), jnp.asarray(p["fu"])
    if slew:
        x0, c, A, Bm, Qt, xt = vmap2(jric.augment_slew_stages)(
            x0, c, A, Bm, Qt, xt, *(jnp.asarray(p[k]) for k in
                                    ("slew_reg", "slew_reg0", "slew_um1")))
    return x0, c, A, Bm, Qt, xt, Rt, ut


def test_cholesky_helpers_match_jax_and_give_nan_not_an_exception():
    rng = np.random.default_rng(0)
    G = rng.normal(size=(5, 3, 4, 4))
    A = G @ np.swapaxes(G, -1, -2) + 0.5 * np.eye(4)
    b, Bm = rng.normal(size=(5, 3, 4)), rng.normal(size=(5, 3, 4, 6))
    L = tlinalg.cholesky_factor(tt(A), jitter=1e-3)
    close(L, jlinalg.cholesky_factor(jnp.asarray(A), jitter=1e-3), 1e-12)
    close(tlinalg.cholesky_solve(L, tt(b)),
          jlinalg.cholesky_solve(jnp.asarray(L.numpy()), jnp.asarray(b)), 1e-12)
    close(tlinalg.cholesky_solve(L, tt(Bm)),
          jlinalg.cholesky_solve(jnp.asarray(L.numpy()), jnp.asarray(Bm)), 1e-12)
    close(tlinalg.psd_solve(tt(A), tt(b)), jlinalg.psd_solve(jnp.asarray(A), jnp.asarray(b)),
          1e-12)
    # a block that is not SPD, and one with a NaN entry, are all NaN; their
    # neighbours are untouched
    A[1, 2] = -np.eye(4)
    A[3, 0, 2, 1] = np.nan
    L = tlinalg.cholesky_factor(tt(A))
    ref = np.asarray(jlinalg.cholesky_factor(jnp.asarray(A)))
    assert torch.isnan(L[1, 2]).all() and torch.isnan(L[3, 0]).all()
    # (jnp.linalg.cholesky fills the lower triangle with NaN)
    assert np.isnan(ref[1, 2][np.tril_indices(4)]).all()
    ok = ~torch.isnan(L).flatten(-2).any(-1)
    assert ok.sum() == 13
    close(L[ok], ref[ok.numpy()], 1e-12)
    assert torch.isnan(tlinalg.psd_solve(tt(A), tt(b))[1, 2]).all()


def test_riccati_solve_scp_matches_vmapped_jax():
    p = problem(70, M=3, N=12)
    ref = vmap2(jric.riccati_solve_scp)(*(jnp.asarray(p[k]) for k in KEYS + ["reg_x", "reg_u"]))
    sol = tric.riccati_solve_scp(*(tt(p[k]) for k in KEYS + ["reg_x", "reg_u"]))
    for a, b in zip(sol, ref):
        close(a, b)
    # a float regularization broadcasts
    ref = vmap2(lambda *a: jric.riccati_solve_scp(*a, 1.0, 0.1))(
        *(jnp.asarray(p[k]) for k in KEYS))
    close(tric.riccati_solve_scp(*(tt(p[k]) for k in KEYS), 1.0, 0.1).U, ref.U)


@pytest.mark.parametrize("M,N,Nc", SHAPES)
def test_stage_terms_and_slew_augmentation_match_vmapped_jax(M, N, Nc):
    p = problem(7 + M + N, M, N)
    t = tric._scp_stage_terms(*(tt(p[k]) for k in KEYS + ["reg_x", "reg_u"]))
    x0, c, A, Bm, Qt, xt, Rt, ut = stage_terms(p, slew=False)
    for a, b in zip(t, (c, Qt, xt, Rt, ut)):
        close(a, b)
    aug = tric.augment_slew_stages(
        tt(p["x0"]), t[0], tt(p["fx"]), tt(p["fu"]), t[1], t[2],
        *(tt(p[k]) for k in ("slew_reg", "slew_reg0", "slew_um1")))
    ref = stage_terms(p, slew=True)
    for a, b in zip(aug, ref[:6]):
        close(a, b, 1e-12)
    assert aug[2].shape == (B, M, N, 8, 8)


@pytest.mark.parametrize("slew", [False, True])
@pytest.mark.parametrize("M,N,Nc", SHAPES)
def test_theta_backward_matches_vmapped_jax(M, N, Nc, slew):
    p = problem(11 + M + N, M, N)
    terms = stage_terms(p, slew)
    S_r, s_r, (K_r, k_r, _, _) = vmap2(
        lambda *a: jric._theta_backward(*a, Nc=Nc))(*terms)
    S, s, (K, k) = tric._theta_backward(*(tt(np.asarray(a)) for a in terms), Nc)
    close(S, S_r)
    close(s, s_r)
    close(K, K_r)
    close(k, k_r)


@pytest.mark.parametrize("slew", [False, True])
@pytest.mark.parametrize("M,N,Nc", SHAPES)
def test_riccati_consensus_solve_matches_vmapped_jax(M, N, Nc, slew):
    p = problem(23 + M + N, M, N)
    keys = KEYS + ["reg_x", "reg_u"]
    skw = {k: p[k] for k in ("slew_reg", "slew_reg0", "slew_um1")} if slew else {}
    X_r, U_r = jax.vmap(lambda a, kw: jric.riccati_consensus_solve(*a, Nc=Nc, **kw))(
        [jnp.asarray(p[k]) for k in keys], {k: jnp.asarray(v) for k, v in skw.items()})
    X, U = tric.riccati_consensus_solve(*(tt(p[k]) for k in keys), Nc=Nc,
                                        **{k: tt(v) for k, v in skw.items()})
    close(X, X_r)
    close(U, U_r)
    assert X.shape == (B, M, N, 4)
    if Nc:  # the consensus block is shared by the particles of a lane
        assert (U[:, :, :Nc] - U[:, :1, :Nc]).abs().max() < 1e-12
    # one lane alone gives its lane of the batch: no cross-lane reduction
    X1, U1 = tric.riccati_consensus_solve(*(tt(p[k][1]) for k in keys), Nc=Nc,
                                          **{k: tt(v[1]) for k, v in skw.items()})
    close(U1, U_r[1])
