"""`pmpc_tpu_torch.dynamics` against `pmpc_tpu.dynamics`, f64, to 1e-12."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from fixtures import unicycle_step
from pmpc_tpu import dynamics as jdyn
from pmpc_tpu_torch import dynamics as tdyn
from pmpc_tpu_torch.flagship import dubins

torch.set_num_threads(1)

TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


def _linear_problem(rng, lead, N=7, xdim=4, udim=2):
    fx = np.eye(xdim) + 0.1 * rng.normal(size=lead + (N, xdim, xdim))
    return dict(
        x0=rng.normal(size=lead + (xdim,)),
        f=rng.normal(size=lead + (N, xdim)),
        fx=fx,
        fu=rng.normal(size=lead + (N, xdim, udim)),
        X_prev=rng.normal(size=lead + (N, xdim)),
        U_prev=rng.normal(size=lead + (N, udim)),
    )


def test_linearize_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 3, 5, 4))
    U = rng.normal(size=(2, 3, 5, 2))
    U[0, :, :, 1] *= 0.05  # |turn| small: the Taylor branch
    ref = jdyn.linearize(unicycle_step, jnp.asarray(X), jnp.asarray(U))
    out = tdyn.linearize(dubins, _t(X), _t(U))
    for a, b in zip(out, ref):
        _close(a, b)


def test_linearize_with_params_matches_jax_and_keeps_f32():
    """Per-particle (v_scale, w_scale, T): mapped with the particles, as
    `jax_scp.linearize_particles` maps them, and not differentiated."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2, 3, 5, 4))
    U = rng.normal(size=(2, 3, 5, 2))
    P = np.stack([rng.uniform(0.5, 1.5, size=(2, 3)), rng.uniform(0.5, 1.5, size=(2, 3)),
                  rng.uniform(0.1, 0.4, size=(2, 3))], -1)

    def one(x, u, p):
        return jdyn.linearize(
            lambda x_, u_: unicycle_step(x_, u_, (p[0], p[1], p[2])), x, u)

    ref = jax.vmap(jax.vmap(one))(jnp.asarray(X), jnp.asarray(U), jnp.asarray(P))
    dyn = lambda x, u, p: dubins(x, u, (p[0], p[1], p[2]))
    out = tdyn.linearize(dyn, _t(X), _t(U), _t(P))
    for a, b in zip(out, ref):
        _close(a, b)
    out32 = tdyn.linearize(dyn, _t(X).float(), _t(U).float(), _t(P).float())
    for a, b in zip(out32, ref):
        assert a.dtype == torch.float32
        _close(a.double(), b, tol=1e-5)


def test_condense_matches_jax():
    p = _linear_problem(np.random.default_rng(1), (2, 3))
    Ft_ref, ft_ref = jdyn.condense(**{k: jnp.asarray(v) for k, v in p.items()})
    Ft, ft = tdyn.condense(**{k: _t(v) for k, v in p.items()})
    _close(Ft, Ft_ref)
    _close(ft, ft_ref)


def test_rollout_matches_jax_and_condense():
    p = _linear_problem(np.random.default_rng(2), ())
    U = np.random.default_rng(3).normal(size=p["U_prev"].shape)
    X_ref = jdyn.rollout(*(jnp.asarray(p[k]) for k in p), jnp.asarray(U))
    X = tdyn.rollout(*(_t(p[k]) for k in p), _t(U))
    _close(X, X_ref)
    # the condensed map reproduces the rollout
    Ft, ft = tdyn.condense(**{k: _t(v) for k, v in p.items()})
    x = Ft @ (_t(U) - _t(p["U_prev"])).reshape(-1) + ft
    _close(x.reshape(X.shape), X_ref)
