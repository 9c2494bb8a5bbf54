"""Solution sensitivities and optimality residuals of the smoothed MPC problem.

Twin of ``pmpc_tpu/sensitivity.py`` (parity with the reference's
``pmpc/experimental/jax/root.py``), on `torch.func`:

- `optimality_residual`: the stationarity residual of the condensed problem
  with smoothed (logbarrier) boxes and optional slew cost, over the controls
  only (the states eliminated through the rollout),
- `masked_rollout`: a rollout pinning its first ``t`` steps to a recorded
  history,
- `sensitivity_L` / `all_sensitivity_L`: the feedback gains
  ``L_t = dU*/dx_{t-1}`` by the implicit function theorem on the optimality
  map, ``L = -(dr/dU)^{-1} (dr/dx)``, both Jacobians by reverse mode over
  the reverse-mode gradient.

Every function takes ONE particle's (N, ...) tensors and runs where they
lie; the JAX scans are Python loops over N.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .utils import matmul_precision_scope


class SensProblem(NamedTuple):
    """Problem data for sensitivity analysis (single particle, (N, ...) tensors)."""

    x0: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    X_ref: torch.Tensor
    U_ref: torch.Tensor
    # these regs are REF-anchored extra weight in the smoothed objective,
    # NOT the SCP prox (anchored at the previous iterate, whose gradient
    # vanishes at the converged fixed point; the reference's
    # linear_optimality, root.py:88-142, carries no reg terms at all).
    # Leave them 0 when analyzing a converged SCP solution.
    reg_x: float = 0.0
    reg_u: float = 0.0
    u_l: Optional[torch.Tensor] = None
    u_u: Optional[torch.Tensor] = None
    x_l: Optional[torch.Tensor] = None
    x_u: Optional[torch.Tensor] = None
    slew_reg: float = 0.0
    smooth_alpha: float = 100.0


def nonlinear_rollout(dynamics: Callable, x0, U):
    """Roll the true nonlinear dynamics: X[j] = f(X[j-1], U[j])."""
    x, xs = x0, []
    for j in range(U.shape[0]):
        x = dynamics(x, U[j])
        xs.append(x)
    return torch.stack(xs)


def masked_rollout(dynamics: Callable, x0, U, X_hist, mask):
    """Rollout where steps with ``mask[j]=1`` are pinned to ``X_hist[j]``.

    mask: (N,) 1.0 = use history, 0.0 = roll dynamics. Gradients do not flow
    through pinned steps (``experimental/jax/dynamics.py:42-57``)."""
    x, xs = x0, []
    for j in range(U.shape[0]):
        m = mask[j]
        x = m * X_hist[j] + (1.0 - m) * dynamics(x, U[j])
        xs.append(x)
    return torch.stack(xs)


def _smooth_objective(dynamics, prob: SensProblem, U, x_start, X_hist, mask):
    """Tracking cost + prox + logbarrier boxes over a (masked) rollout."""
    X = masked_rollout(dynamics, x_start, U, X_hist, mask)
    dX = X - prob.X_ref
    dU = U - prob.U_ref
    J = 0.5 * (dX * torch.einsum("nij,nj->ni", prob.Q, dX)).sum()
    J = J + 0.5 * (dU * torch.einsum("nij,nj->ni", prob.R, dU)).sum()
    J = J + 0.5 * prob.reg_u * (dU * dU).sum() + 0.5 * prob.reg_x * (dX * dX).sum()
    if prob.slew_reg is not None:
        J = J + 0.5 * prob.slew_reg * ((U[1:] - U[:-1]) ** 2).sum()
    alpha = prob.smooth_alpha

    def barrier(y):  # y < 0 feasible
        return -torch.log(torch.clamp(-alpha * y, min=1e-30)) / alpha

    if prob.u_l is not None:
        J = J + barrier(prob.u_l - U).sum()
    if prob.u_u is not None:
        J = J + barrier(U - prob.u_u).sum()
    if prob.x_l is not None:
        J = J + barrier(prob.x_l - X).sum()
    if prob.x_u is not None:
        J = J + barrier(X - prob.x_u).sum()
    return J


def _mask(N: int, t: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(N, device=like.device) < t).to(like.dtype)


def optimality_residual(dynamics, prob: SensProblem, U, t: int = 0, X_hist=None):
    """Gradient of the smoothed objective w.r.t. U with the first ``t`` steps of
    the rollout pinned to history (t=0: plain condensed stationarity)."""
    N = U.shape[0]
    mask = _mask(N, t, U)
    X_hist = X_hist if X_hist is not None else U.new_zeros((N, prob.x0.shape[0]))

    def obj(Uv):
        return _smooth_objective(dynamics, prob, Uv, prob.x0, X_hist, mask)

    return torch.func.grad(obj)(U)


def sensitivity_L(dynamics, prob: SensProblem, U_star, X_star, t: int = 0):
    """Feedback gain L = dU*/dx at step ``t``: how the optimal control sequence
    responds to a perturbation of the state entering step ``t`` (x_{t-1};
    t=0 gives dU*/dx0), holding the recorded history before ``t`` fixed.

    Implicit function theorem on r(U, x) = grad_U J_masked(U, x):
        L = -(dr/dU)^{-1} dr/dx,  shape (N, udim, xdim), U_star's dtype.
    The solve carries a 1e-9 ridge and runs at full f32 matmul precision."""
    N, udim = U_star.shape
    xdim = prob.x0.shape[0]
    dt = U_star.dtype
    mask = _mask(N, t, U_star)

    def resid(Uv, x):
        def obj(Uq):
            # the state entering step t is x: for t=0 that is x0; for t>0 the
            # pinned history provides steps < t and x replaces X_hist[t-1]
            if t > 0:
                X_hist = torch.cat([X_star[:t - 1], x[None], X_star[t:]])
                x_start = prob.x0
            else:
                X_hist, x_start = torch.zeros_like(X_star), x
            return _smooth_objective(dynamics, prob, Uq, x_start, X_hist, mask)

        return torch.func.grad(obj)(Uv).reshape(-1)

    x_at = X_star[t - 1] if t > 0 else prob.x0
    with matmul_precision_scope():
        # reverse over reverse, where the JAX function takes jacfwd: torch's
        # forward mode promotes the tangents of python-float arithmetic on
        # 0-dim tensors to f64 (ROADMAP §3 F2), which breaks f32 dynamics
        K = torch.func.jacrev(resid, argnums=0)(U_star, x_at).reshape(N * udim, N * udim)
        g = torch.func.jacrev(resid, argnums=1)(U_star, x_at).reshape(N * udim, xdim)
        eye = torch.eye(N * udim, dtype=dt, device=U_star.device)
        L = -torch.linalg.solve(K + 1e-9 * eye, g)
    return L.reshape(N, udim, xdim)


def all_sensitivity_L(dynamics, prob: SensProblem, U_star, X_star):
    """Gains for every step: a list of (N, udim, xdim) tensors, entry t =
    dU*/dx_{t-1} (``root.py:163-171``)."""
    return [sensitivity_L(dynamics, prob, U_star, X_star, t=t)
            for t in range(U_star.shape[0])]
