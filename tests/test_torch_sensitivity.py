"""`pmpc_tpu_torch.sensitivity` against `pmpc_tpu.sensitivity`, f64, on the
CPU: the rollouts, the smoothed objective's gradient (`optimality_residual`)
and the feedback gains (`sensitivity_L`, every t of `all_sensitivity_L`) on
tests/test_sensitivity.py's instances to 1e-8 (the unicycle: the fixtures'
JAX step and the port's `flagship.dubins`); the gains against finite
differences of re-solved optima (tests/test_sensitivity_fd.py's check,
5e-4), the optima found by the port's own Newton on the smoothed objective;
and an f32 problem gives f32 gains (ROADMAP §3 F2)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import unicycle_step
from pmpc_tpu import sensitivity as js
from pmpc_tpu_torch import sensitivity as ts
from pmpc_tpu_torch.flagship import dubins
from test_sensitivity import _solve_smooth

torch.set_num_threads(1)

N, XDIM, UDIM = 6, 4, 2
TOL = 1e-8


def _problems(box=2.0, alpha=20.0, reg=0.0, slew=0.0):
    """(JAX SensProblem, port SensProblem) of one instance."""
    arrs = dict(x0=np.ones(XDIM), Q=np.tile(np.eye(XDIM), (N, 1, 1)),
                R=np.tile(0.1 * np.eye(UDIM), (N, 1, 1)),
                X_ref=np.zeros((N, XDIM)), U_ref=np.zeros((N, UDIM)))
    b = None if box is None else box * np.ones((N, UDIM))
    jp = js.SensProblem(**{k: jnp.asarray(v) for k, v in arrs.items()},
                        reg_x=jnp.asarray(reg), reg_u=jnp.asarray(reg),
                        u_l=None if b is None else jnp.asarray(-b),
                        u_u=None if b is None else jnp.asarray(b),
                        slew_reg=jnp.asarray(slew), smooth_alpha=jnp.asarray(alpha))
    tp = ts.SensProblem(**{k: torch.from_numpy(v) for k, v in arrs.items()},
                        reg_x=reg, reg_u=reg,
                        u_l=None if b is None else torch.from_numpy(-b),
                        u_u=None if b is None else torch.from_numpy(b),
                        slew_reg=slew, smooth_alpha=alpha)
    return jp, tp


def _newton_smooth(prob, U0, iters=40):
    """The smoothed objective's optimum by damped Newton from a strictly
    feasible U0, polished to machine precision."""
    mask, X_hist = torch.zeros(N, dtype=U0.dtype), torch.zeros((N, XDIM), dtype=U0.dtype)
    obj = lambda U: ts._smooth_objective(dubins, prob, U, prob.x0, X_hist, mask)
    grad = torch.func.grad(obj)
    U = U0.clone()
    for _ in range(iters):
        g = grad(U).reshape(-1)
        if g.abs().max() < 1e-13:
            break
        H = torch.func.jacrev(grad)(U).reshape(N * UDIM, N * UDIM)
        step = torch.linalg.solve(H, g).reshape(N, UDIM)
        t, J0 = 1.0, obj(U)
        while t > 1e-8 and not bool(obj(U - t * step) <= J0 + 1e-12 * abs(float(J0))):
            t *= 0.5
        U = U - t * step
    return U


def test_rollouts_and_residual_match_jax():
    rng = np.random.default_rng(0)
    U = rng.normal(size=(N, UDIM)) * 0.3
    X_hist = rng.normal(size=(N, XDIM))
    mask = np.array([1.0, 1.0, 0.0, 0.0, 0.0, 0.0])
    x0 = np.ones(XDIM)
    Xj = np.asarray(js.masked_rollout(unicycle_step, jnp.asarray(x0), jnp.asarray(U),
                                      jnp.asarray(X_hist), jnp.asarray(mask)))
    Xt = ts.masked_rollout(dubins, torch.from_numpy(x0), torch.from_numpy(U),
                           torch.from_numpy(X_hist), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=1e-12, rtol=0)
    np.testing.assert_allclose(Xt[:2], X_hist[:2], atol=0)
    np.testing.assert_allclose(
        ts.nonlinear_rollout(dubins, torch.from_numpy(x0), torch.from_numpy(U)).numpy(),
        np.asarray(js.nonlinear_rollout(unicycle_step, jnp.asarray(x0), jnp.asarray(U))),
        atol=1e-12, rtol=0)
    for kw, t in ((dict(), 0), (dict(reg=0.1, slew=0.3), 0), (dict(box=None), 2)):
        jp, tp = _problems(**kw)
        r_j = np.asarray(js.optimality_residual(unicycle_step, jp, jnp.asarray(U), t=t,
                                                X_hist=jnp.asarray(X_hist)))
        r_t = ts.optimality_residual(dubins, tp, torch.from_numpy(U), t=t,
                                     X_hist=torch.from_numpy(X_hist)).numpy()
        np.testing.assert_allclose(r_t, r_j, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [0, 3])
def test_sensitivity_L_matches_jax_at_the_optimum(t):
    """tests/test_sensitivity.py::test_optimality_residual_zero_at_optimum's
    problem (box +-1, alpha 50) at the JAX package's optimum."""
    jp, tp = _problems(box=1.0, alpha=50.0)
    U_j = _solve_smooth(unicycle_step, jp, N, UDIM)
    U = torch.from_numpy(np.array(U_j))
    assert ts.optimality_residual(dubins, tp, U).abs().max() < 1e-6
    X_j = js.nonlinear_rollout(unicycle_step, jp.x0, U_j)
    X = ts.nonlinear_rollout(dubins, tp.x0, U)
    L_j = np.asarray(js.sensitivity_L(unicycle_step, jp, U_j, X_j, t=t))
    L = ts.sensitivity_L(dubins, tp, U, X, t=t)
    assert L.shape == (N, UDIM, XDIM) and L.dtype == torch.float64
    np.testing.assert_allclose(L.numpy(), L_j, atol=TOL, rtol=0)


def test_all_sensitivity_L_and_f32():
    """tests/test_sensitivity.py::test_all_sensitivity_L_shapes's instance
    (unbounded, regs 0.1, alpha 20): every t's gain is `sensitivity_L`'s,
    held against JAX at the first and the last t (one JAX compile per t);
    the same in f32 gives f32 gains within f32 rounding of the f64 ones."""
    jp, tp = _problems(box=None, reg=0.1)
    U = torch.zeros((N, UDIM), dtype=torch.float64)
    X = ts.nonlinear_rollout(dubins, tp.x0, U)
    Ls = ts.all_sensitivity_L(dubins, tp, U, X)
    assert len(Ls) == N
    for t in range(N):
        assert torch.equal(Ls[t], ts.sensitivity_L(dubins, tp, U, X, t=t))
    for t in (0, N - 1):
        L_j = js.sensitivity_L(unicycle_step, jp, jnp.asarray(U.numpy()),
                               jnp.asarray(X.numpy()), t=t)
        np.testing.assert_allclose(Ls[t].numpy(), np.asarray(L_j), atol=TOL, rtol=0)
    t32 = ts.SensProblem(*(a.float() if isinstance(a, torch.Tensor) else a for a in tp))
    L32 = ts.sensitivity_L(dubins, t32, U.float(), X.float(), t=2)
    assert L32.dtype == torch.float32
    np.testing.assert_allclose(L32.double().numpy(), Ls[2].numpy(), atol=1e-4, rtol=0)


def test_sensitivity_L_matches_finite_difference():
    """dU*/dx0 from the implicit function theorem against re-solving at
    x0 +- eps e_k (tests/test_sensitivity_fd.py's instance: box +-2,
    alpha 20), every optimum by the port's Newton."""
    _, tp = _problems(box=2.0, alpha=20.0)
    U0 = torch.zeros((N, UDIM), dtype=torch.float64)
    U_star = _newton_smooth(tp, U0)
    assert ts.optimality_residual(dubins, tp, U_star).abs().max() < 1e-10
    X_star = ts.nonlinear_rollout(dubins, tp.x0, U_star)
    L = ts.sensitivity_L(dubins, tp, U_star, X_star, t=0).numpy()
    eps = 1e-5
    for k in range(XDIM):
        dx = torch.zeros(XDIM, dtype=torch.float64)
        dx[k] = eps
        Up = _newton_smooth(tp._replace(x0=tp.x0 + dx), U_star)
        Um = _newton_smooth(tp._replace(x0=tp.x0 - dx), U_star)
        fd = ((Up - Um) / (2 * eps)).numpy()
        np.testing.assert_allclose(L[:, :, k], fd, atol=5e-4, err_msg=f"x0 component {k}")
