"""`pmpc_tpu_torch.dynamics` against `pmpc_tpu.dynamics`, f64, to 1e-12."""

import numpy as np
import torch

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
