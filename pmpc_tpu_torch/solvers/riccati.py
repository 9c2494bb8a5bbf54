"""Riccati-sweep LQR solver: the O(N) stage-structured alternative to
condensation.

Twin of ``pmpc_tpu/solvers/riccati.py``. The condensed path materializes the
O(N^2) sensitivity ``Ft``; the backward/forward Riccati recursion solves the
same equality-constrained problem in O(N) with tiny per-stage matmuls.

Cost semantics match the condensed assembly without slew:
    sum_j 0.5 x_j'Qt_j x_j - xt_j'x_j + 0.5 u_j'Rt_j u_j - ut_j'u_j
    s.t.  x_j = c_j + A_j x_{j-1} + B_j u_j,   x_0 given,
with Qt = Q + reg_x I, xt = Q X_ref + reg_x X_prev (etc.).

The JAX functions take one particle and are mapped with ``jax.vmap``; here
every function takes arbitrary leading batch dims (``c`` is (..., N, xdim))
and the horizon is a Python loop whose body is a few batched matmuls.
`riccati_consensus_solve` takes (..., M, ...) arrays: the consensus
reduction is the sum over the particle axis, the last leading one. Consensus
(shared first-Nc controls) is the theta-parameterized sweep; slew coupling is
the `augment_slew_stages` state augmentation (carry (u_j, u_{j-1}) in the
stage state).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import psd_solve
from ..particles import psum
from ..utils import full_matmul_precision


class LQRSolution(NamedTuple):
    X: torch.Tensor  # (..., N, xdim)
    U: torch.Tensor  # (..., N, udim)
    K: torch.Tensor  # (..., N, udim, xdim) feedback gains (u_j = K_j x_{j-1} + k_j)
    k: torch.Tensor  # (..., N, udim)


def _flat(a: torch.Tensor, keep: int) -> torch.Tensor:
    """Fold every leading dim but the last ``keep`` into one batch axis."""
    lead = a.shape[:a.ndim - keep]
    return a.reshape((math.prod(lead),) + a.shape[a.ndim - keep:])


@full_matmul_precision
def riccati_solve(x0, c, A, B, Qt, xt, Rt, ut) -> LQRSolution:
    """Solve the affine-dynamics tracking LQR by a backward and a forward
    sweep.

    Args:
        x0: (..., xdim) initial state.
        c: (..., N, xdim) affine dynamics offsets.
        A: (..., N, xdim, xdim), B: (..., N, xdim, udim).
        Qt: (..., N, xdim, xdim) state Hessians; xt: (..., N, xdim) state
            linear targets (cost 0.5 x'Qt x - xt'x).
        Rt: (..., N, udim, udim); ut: (..., N, udim) (cost 0.5 u'Rt u - ut'u).
    """
    lead, (N, xdim) = c.shape[:-2], c.shape[-2:]
    udim = B.shape[-1]
    x0, c, xt, ut = _flat(x0, 1), _flat(c, 2), _flat(xt, 2), _flat(ut, 2)
    A, B, Qt, Rt = _flat(A, 3), _flat(B, 3), _flat(Qt, 3), _flat(Rt, 3)
    nb = c.shape[0]
    P = c.new_zeros((nb, xdim, xdim))  # value of stages j+1.. as 0.5 x'Px + p'x
    p = c.new_zeros((nb, xdim, 1))
    Ks, ks = [None] * N, [None] * N
    for j in reversed(range(N)):
        A_j, B_j = A[:, j], B[:, j]
        M = Qt[:, j] + P
        Mc_m = M @ c[:, j, :, None] + (p - xt[:, j, :, None])
        BtM = B_j.mT @ M
        BtMA = BtM @ A_j
        rhs = torch.cat([BtMA, B_j.mT @ Mc_m - ut[:, j, :, None]], dim=-1)
        sol = psd_solve(Rt[:, j] + BtM @ B_j, rhs)  # (udim, xdim+1)
        Ks[j], ks[j] = -sol[..., :xdim], -sol[..., xdim:]
        P = (A_j.mT @ M) @ A_j + BtMA.mT @ Ks[j]
        P = 0.5 * (P + P.mT)
        p = A_j.mT @ Mc_m + BtMA.mT @ ks[j]
    K, k = torch.stack(Ks, dim=1), torch.stack(ks, dim=1)[..., 0]
    x, Xs, Us = x0[..., None], [], []
    for j in range(N):
        u = K[:, j] @ x + k[:, j, :, None]
        x = c[:, j, :, None] + A[:, j] @ x + B[:, j] @ u
        Xs.append(x)
        Us.append(u)
    X, U = torch.stack(Xs, dim=1)[..., 0], torch.stack(Us, dim=1)[..., 0]
    return LQRSolution(X=X.reshape(lead + (N, xdim)), U=U.reshape(lead + (N, udim)),
                       K=K.reshape(lead + (N, udim, xdim)),
                       k=k.reshape(lead + (N, udim)))


def riccati_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                      reg_x, reg_u) -> LQRSolution:
    """Riccati solve of one SCP subproblem per leading index (reference cost
    semantics; affine dynamics from the linearization convention
    x_j = f_j + fx_j (x_{j-1} - xlin_{j-1}) + fu_j (u_j - U_prev_j))."""
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev,
                                         Q, R, X_ref, U_ref, reg_x, reg_u)
    return riccati_solve(x0, c, fx, fu, Qt, xt, Rt, ut)


def _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                     reg_x, reg_u):
    """Affine dynamics offsets + per-stage cost terms of one SCP subproblem.
    ``reg_x``/``reg_u`` are floats or (...,) tensors, one per leading index."""
    mv = lambda A_, v: (A_ @ v[..., None])[..., 0]
    xlin = torch.cat([x0[..., None, :], X_prev[..., :-1, :]], dim=-2)
    c = f - mv(fx, xlin) - mv(fu, U_prev)
    xdim, udim = x0.shape[-1], U_prev.shape[-1]
    reg_x = torch.as_tensor(reg_x, dtype=f.dtype, device=f.device)
    reg_u = torch.as_tensor(reg_u, dtype=f.dtype, device=f.device)
    rx, ru = reg_x[..., None, None], reg_u[..., None, None]
    Qt = Q + rx[..., None] * torch.eye(xdim, dtype=f.dtype, device=f.device)
    Rt = R + ru[..., None] * torch.eye(udim, dtype=f.dtype, device=f.device)
    xt = mv(Q, X_ref) + rx * X_prev
    ut = mv(R, U_ref) + ru * U_prev
    return c, Qt, xt, Rt, ut


def augment_slew_stages(x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1):
    """Carry (u_j, u_{j-1}) in the stage state so slew coupling becomes a
    pure per-stage STATE cost: the O(N) route to the tridiagonal slew
    coupling, which the condensed path encodes densely and the plain stage
    sweep cannot express.

    Augmented state x~_j = [x_j; u_j; u_{j-1}] with dynamics

        x~_j = A~_j x~_{j-1} + B~_j u_j + c~_j,
        A~ = [[A,0,0],[0,0,0],[0,I,0]],  B~ = [B; I; 0],  c~ = [c; 0; 0],

    and per-stage state cost 0.5 w_j ||u_j - u_{j-1}||^2 with w_0 = slew_reg0
    (anchor ``slew_um1`` enters through x~_{-1} = [x0; slew_um1; 0]) and
    w_j = slew_reg for j >= 1. ``slew_reg``/``slew_reg0`` (...,),
    ``slew_um1`` (..., udim).

    Returns (x0_a, c_a, A_a, B_a, Qt_a, xt_a) with xdim_a = xdim + 2 udim."""
    lead, (N, xdim) = c.shape[:-2], c.shape[-2:]
    udim = B.shape[-1]
    na = xdim + 2 * udim
    o1, o2 = xdim + udim, xdim + 2 * udim
    eye_u = torch.eye(udim, dtype=c.dtype, device=c.device)
    A_a = c.new_zeros(lead + (N, na, na))
    A_a[..., :xdim, :xdim] = A
    A_a[..., o1:, xdim:o1] = eye_u
    B_a = c.new_zeros(lead + (N, na, udim))
    B_a[..., :xdim, :] = B
    B_a[..., xdim:o1, :] = eye_u
    c_a = c.new_zeros(lead + (N, na))
    c_a[..., :xdim] = c
    w = slew_reg[..., None].expand(lead + (N,)).clone()  # (..., N)
    w[..., 0] = slew_reg0
    wI = w[..., None, None] * eye_u
    Qt_a = c.new_zeros(lead + (N, na, na))
    Qt_a[..., :xdim, :xdim] = Qt
    Qt_a[..., xdim:o1, xdim:o1] = wI
    Qt_a[..., o1:o2, o1:o2] = wI
    Qt_a[..., xdim:o1, o1:o2] = -wI
    Qt_a[..., o1:o2, xdim:o1] = -wI
    xt_a = c.new_zeros(lead + (N, na))
    xt_a[..., :xdim] = xt
    x0_a = torch.cat([x0, slew_um1, torch.zeros_like(slew_um1)], dim=-1)
    return x0_a, c_a, A_a, B_a, Qt_a, xt_a


def _theta_backward(x0, c, A, B, Qt, xt, Rt, ut, Nc: int):
    """Backward sweep of every particle with the first ``Nc`` stage controls
    treated as a shared PARAMETER vector theta (nc = Nc*udim entries).

    The value function of stages j.. is carried as a quadratic in the
    augmented variable (x, theta):

        V_j(x, th) = 0.5 [x; th]' P [x; th] + p' [x; th] + const,

    free stages (j >= Nc) eliminate u_j as usual; consensus stages substitute
    u_j = E_j th (E_j selects block j of theta). Returns the theta-quadratic
    at the root (0.5 th'S th + s'th, both including x0's contribution) plus
    the per-stage gains of the free stages (K over [x; th], zero on the
    consensus stages). The cross-particle consensus reduction is the SUM of
    (S, s) over particles.
    """
    lead, (N, xdim) = c.shape[:-2], c.shape[-2:]
    udim = B.shape[-1]
    nc = Nc * udim
    na = xdim + nc
    x0, c, xt, ut = _flat(x0, 1), _flat(c, 2), _flat(xt, 2), _flat(ut, 2)
    A, B, Qt, Rt = _flat(A, 3), _flat(B, 3), _flat(Qt, 3), _flat(Rt, 3)
    nb = c.shape[0]
    # augmented dynamics [x_j; th] = Aa [x_{j-1}; th] + Ba u_j + ca, every
    # stage at once: consensus stages route their control through theta
    Aa = c.new_zeros((nb, N, na, na))
    Aa[..., :xdim, :xdim] = A
    Aa[..., xdim:, xdim:] = torch.eye(nc, dtype=c.dtype, device=c.device)
    for j in range(Nc):
        Aa[:, j, :xdim, xdim + j * udim:xdim + (j + 1) * udim] = B[:, j]
    Ba = torch.cat([B, c.new_zeros((nb, N, nc, udim))], dim=-2)
    ca = torch.cat([c, c.new_zeros((nb, N, nc))], dim=-1)[..., None]

    P = c.new_zeros((nb, na, na))  # quadratic over [x_j; theta] (stages j+1..)
    p = c.new_zeros((nb, na, 1))
    Ks = [c.new_zeros((nb, udim, na))] * N
    ks = [c.new_zeros((nb, udim, 1))] * N
    for j in reversed(range(N)):
        Aa_j, Ba_j = Aa[:, j], Ba[:, j]
        # fold stage j's costs into the next-state value: the state cost is
        # on x_j, and theta passes through unchanged, so a consensus stage's
        # control cost lands exactly on its block of theta
        Mn, mn = P.clone(), p.clone()
        Mn[:, :xdim, :xdim] += Qt[:, j]
        mn[:, :xdim] -= xt[:, j, :, None]
        if j < Nc:
            blk = slice(xdim + j * udim, xdim + (j + 1) * udim)
            Mn[:, blk, blk] += Rt[:, j]
            mn[:, blk] -= ut[:, j, :, None]
        # substitute [x_j; th] = Aa y + Ba u + ca  (y = [x_{j-1}; th])
        MA = Mn @ Aa_j
        Mc_m = Mn @ ca[:, j] + mn
        Pyy = Aa_j.mT @ MA
        py = Aa_j.mT @ Mc_m
        if j >= Nc:  # free stage: eliminate u
            Huy = Ba_j.mT @ MA
            hu = Ba_j.mT @ Mc_m - ut[:, j, :, None]
            sol = psd_solve(Rt[:, j] + Ba_j.mT @ (Mn @ Ba_j),
                            torch.cat([Huy, hu], dim=-1))
            Ks[j], ks[j] = -sol[..., :na], -sol[..., na:]
            Pyy = Pyy + Huy.mT @ Ks[j]
            py = py + Huy.mT @ ks[j]
        P = 0.5 * (Pyy + Pyy.mT)
        p = py
    # root: V(x0, th) -> quadratic in theta
    S = P[:, xdim:, xdim:]
    s = (p[:, xdim:] + P[:, xdim:, :xdim] @ x0[..., None])[..., 0]
    K = torch.stack(Ks, dim=1).reshape(lead + (N, udim, na))
    k = torch.stack(ks, dim=1)[..., 0].reshape(lead + (N, udim))
    return S.reshape(lead + (nc, nc)), s.reshape(lead + (nc,)), (K, k)


def _theta_forward(x0, c, A, B, theta, gains, Nc: int):
    """Roll out every particle given theta (broadcast against the leading
    dims) and the free-stage gains."""
    K, k = gains
    lead, (N, xdim) = c.shape[:-2], c.shape[-2:]
    udim = B.shape[-1]
    theta = _flat(theta.expand(lead + theta.shape[-1:]), 1)
    x0, c, k = _flat(x0, 1), _flat(c, 2), _flat(k, 2)
    A, B, K = _flat(A, 3), _flat(B, 3), _flat(K, 3)
    x, th = x0[..., None], theta[..., None]
    Xs, Us = [], []
    for j in range(N):
        if j >= Nc:
            u = K[:, j] @ torch.cat([x, th], dim=-2) + k[:, j, :, None]
        else:
            u = th[:, j * udim:(j + 1) * udim]
        x = c[:, j, :, None] + A[:, j] @ x + B[:, j] @ u
        Xs.append(x)
        Us.append(u)
    X, U = torch.stack(Xs, dim=1)[..., 0], torch.stack(Us, dim=1)[..., 0]
    return X.reshape(lead + (N, xdim)), U.reshape(lead + (N, udim))


@full_matmul_precision
def riccati_consensus_solve(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                            reg_x, reg_u, Nc: int,
                            slew_reg=None, slew_reg0=None, slew_um1=None):
    """O(N) consensus solve of the joint M-particle SCP subproblem (eq-only).

    All inputs (..., M, ...): the last leading axis is the particle axis. The
    consensus system over theta (the shared first-Nc controls) is the SUM
    over particles of the per-particle theta-quadratics: the Schur complement
    of the arrow system, computed without ever materializing the O(N^2)
    condensed ``Ft``. Slew coupling (optional (..., M) ``slew_reg`` /
    ``slew_reg0`` and (..., M, udim) ``slew_um1``) goes through
    `augment_slew_stages`. Returns (X (..., M, N, xdim), U (..., M, N, udim)).
    """
    xdim = x0.shape[-1]
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev,
                                         Q, R, X_ref, U_ref, reg_x, reg_u)
    A, B, x0s = fx, fu, x0
    if slew_reg is not None:
        x0s, c, A, B, Qt, xt = augment_slew_stages(
            x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1)
    S, s, gains = _theta_backward(x0s, c, A, B, Qt, xt, Rt, ut, Nc)
    # consensus reduction: sum the theta-quadratics over particles
    S_tot, s_tot = psum(S.sum(dim=-3)), psum(s.sum(dim=-2))
    theta = -psd_solve(S_tot, s_tot) if S_tot.shape[-1] else s_tot
    X, U = _theta_forward(x0s, c, A, B, theta[..., None, :], gains, Nc)
    return X[..., :xdim], U
