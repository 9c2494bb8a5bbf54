"""Parallel-in-time Riccati sweeps: the stage-structured solve in O(log N)
combine depth.

Twin of ``pmpc_tpu/solvers/priccati.py``. `riccati.py` solves the
stage-structured SCP subproblem by sequential sweeps, O(N) tiny products in
a chain. This module solves the same problems by associative scans over the
stage axis: the backward value recursion is a suffix product of
conditional value-function elements, all stages at once in each of
ceil(log2 N) + 1 rounds; the gains and the affine forward rollout are then
stage-parallel.

The conditional cost of steering y_{j-1} -> y_j through stage j is an
element e = (A, b, C, eta, J) in the dual form

    g(y, z) = max_l [ l'(z - A y - b) - 1/2 l'C l ] + 1/2 y'J y - eta'y,

with C = Ba R^{-1} Ba' (C = 0 on a stage without a free control), and
elements compose associatively under (e_i (*) e_j)(y, z) = min_w e_i(y, w)
+ e_j(w, z) (`_combine`). The suffix product s_j = e_j (*) ... (*) e_T gives
every value-to-go: V(y_j) = 1/2 y'J y - eta'y of s_{j+1}. Stage costs land
on the arrival state, as in `riccati.py`, so element j carries stage j-1's
arrival cost as its departure quadratic and one terminal element carries
stage N-1's. Consensus (the shared first-Nc controls) uses the
theta-augmented state y = [x; theta] of `riccati._theta_backward`: the root
suffix quadratic's theta block is the particle's consensus Schur complement,
summed over the particles (`particles.psum`).

The JAX module scans with ``lax.associative_scan``. Here the scan is
written out (`_scan`): Hillis-Steele doubling over the stage axis, each
round one batched `_combine` of every element with the one 2^k stages
away, so log2 N rounds of batched dense work whatever the batch. Its
pairing differs from XLA's, so results agree to rounding, not bit for bit.
The two solves of a combine (with I + C_i J_j and its transpose) are
`torch.linalg.solve`, as the JAX module uses ``jnp.linalg.solve``; no
Cholesky kernel of ``ops/chol_inv`` runs on this route. Every function takes
arbitrary leading batch dims; the stage axis is the one the JAX function
has first.
"""

from __future__ import annotations

import torch

from ..ops.linalg import psd_solve
from ..particles import psum
from ..utils import full_matmul_precision
from .riccati import LQRSolution, _scp_stage_terms


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _combine(ei, ej):
    """Associative combination of value-function elements (earlier, later),
    batched over leading axes: T = I + C_i J_j, and

        A   = A_j T^{-1} A_i
        b   = A_j T^{-1} (b_i + C_i eta_j) + b_j
        C   = A_j T^{-1} C_i A_j' + C_j
        eta = A_i' T^{-T} (eta_j - J_j b_i) + eta_i
        J   = A_i' T^{-T} J_j A_i + J_i."""
    A_i, b_i, C_i, eta_i, J_i = ei
    A_j, b_j, C_j, eta_j, J_j = ej
    na = A_i.shape[-1]
    eye = torch.eye(na, dtype=A_i.dtype, device=A_i.device)
    T = eye + C_i @ J_j
    # one batched solve against [A_i | b_i + C_i eta_j | C_i]
    rhs = torch.cat([A_i, (b_i + _mv(C_i, eta_j))[..., None], C_i], -1)
    sol = torch.linalg.solve(T, rhs)
    TA, Tb, TC = sol[..., :na], sol[..., na], sol[..., na + 1:]
    A = A_j @ TA
    b = _mv(A_j, Tb) + b_j
    C = A_j @ TC @ A_j.mT + C_j
    C = 0.5 * (C + C.mT)
    # the transposed system: (I + J_j C_i)^{-1} [eta_j - J_j b_i | J_j A_i]
    rhs2 = torch.cat([(eta_j - _mv(J_j, b_i))[..., None], J_j @ A_i], -1)
    sol2 = torch.linalg.solve(T.mT, rhs2)
    eta = _mv(A_i.mT, sol2[..., 0]) + eta_i
    J = A_i.mT @ sol2[..., 1:] + J_i
    J = 0.5 * (J + J.mT)
    return A, b, C, eta, J


def _affine_combine(ei, ej):
    """Composition of affine maps x -> F x + d (earlier, later)."""
    F_i, d_i = ei
    F_j, d_j = ej
    return F_j @ F_i, _mv(F_j, d_i) + d_j


def _scan(fn, elems, reverse: bool = False):
    """Inclusive associative scan over dim 0 of a tuple of tensors, by
    Hillis-Steele doubling: after the round of distance d every entry holds
    the product of the 2d entries ending (starting, with ``reverse``) at it.
    ``fn(earlier, later)``. Forward: out_i = e_0 (*) ... (*) e_i; reverse:
    out_i = e_i (*) ... (*) e_{n-1}."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        if reverse:
            head = fn(tuple(e[:-d] for e in elems), tuple(e[d:] for e in elems))
            elems = tuple(torch.cat([h, e[n - d:]], 0) for h, e in zip(head, elems))
        else:
            tail = fn(tuple(e[:-d] for e in elems), tuple(e[d:] for e in elems))
            elems = tuple(torch.cat([e[:d], t], 0) for t, e in zip(tail, elems))
        d *= 2
    return elems


def affine_scan_rollout(F, d, x0):
    """x_j of x_j = F_j x_{j-1} + d_j from x0, by an O(log N) prefix scan.
    F (..., N, xdim, xdim), d (..., N, xdim), x0 (..., xdim)."""
    Fc, dc = _scan(_affine_combine, (F.movedim(-3, 0), d.movedim(-2, 0)))
    return (_mv(Fc, x0) + dc).movedim(0, -2)


def _theta_parallel_value(x0, c, A, B, Qt, xt, Rt, ut, Nc: int):
    """Suffix value functions of every theta-augmented particle, in parallel.
    Stage data (..., N, ...). Returns (S (..., nct, nct), s (..., nct), aux):
    (S, s) the root theta-quadratic (the consensus Schur complement, as
    `riccati._theta_backward` gives it), ``aux`` what the gains and the
    rollout need."""
    lead, (N, xdim) = c.shape[:-2], c.shape[-2:]
    udim = B.shape[-1]
    dt, dev = c.dtype, c.device
    nc = Nc * udim
    nct = max(nc, 1)  # a dummy theta entry when Nc == 0
    na = xdim + nct
    Es = torch.zeros((N, udim, nct), dtype=dt, device=dev)  # stage selectors
    if Nc:
        Es[:Nc, :, :nc] = torch.eye(nc, dtype=dt, device=dev).reshape(Nc, udim, nc)
    w = (torch.arange(N, device=dev) >= Nc).to(dt)[:, None, None]  # free stages
    maskc = (torch.arange(nct, device=dev) < nc).to(dt)

    Aa = c.new_zeros(lead + (N, na, na))
    Aa[..., :xdim, :xdim] = A
    Aa[..., xdim:, xdim:] = torch.eye(nct, dtype=dt, device=dev)
    Aa[..., :xdim, xdim:] += (1.0 - w) * (B @ Es)
    ca = torch.cat([c, c.new_zeros(lead + (N, nct))], -1)
    Ma = c.new_zeros(lead + (N, na, na))
    Ma[..., :xdim, :xdim] = Qt
    Ma[..., xdim:, xdim:] += (1.0 - w) * (Es.mT @ Rt @ Es)
    ma = torch.cat([xt, (1.0 - w[..., 0]) * _mv(Es.mT, ut)], -1)

    # the free stage's control eliminated through C = Ba R^-1 Ba'
    BRB = B @ psd_solve(Rt, B.mT)
    C_e = c.new_zeros(lead + (N, na, na))
    C_e[..., :xdim, :xdim] = w * BRB
    b_e = ca.clone()
    b_e[..., :xdim] += w[..., 0] * _mv(B, psd_solve(Rt, ut[..., None])[..., 0])
    zq, zl = c.new_zeros(lead + (1, na, na)), c.new_zeros(lead + (1, na))
    # element j departs with stage j-1's arrival cost; one terminal element
    elems = (torch.cat([Aa, zq], -3), torch.cat([b_e, zl], -2), torch.cat([C_e, zq], -3),
             torch.cat([zl, ma], -2), torch.cat([zq, Ma], -3))
    moved = tuple(e.movedim(-3 if e.ndim == len(lead) + 3 else -2, 0) for e in elems)
    _, _, _, eta_s, J_s = _scan(_combine, moved, reverse=True)
    eta_s, J_s = eta_s.movedim(0, -2), J_s.movedim(0, -3)

    P = J_s[..., 1:, :, :]  # value-to-go after arriving at y_j
    p = -eta_s[..., 1:, :]
    J0, eta0 = J_s[..., 0, :, :], eta_s[..., 0, :]
    S = J0[..., xdim:, xdim:]
    s = -eta0[..., xdim:] + _mv(J0[..., xdim:, :xdim], x0)

    # the free stages' gains (zero on the consensus stages)
    BtP = B.mT @ P[..., :xdim, :]  # (..., N, udim, na)
    Hu = Rt + BtP[..., :xdim] @ B
    rhs = torch.cat([BtP @ Aa, (_mv(BtP, ca) + _mv(B.mT, p[..., :xdim]) - ut)[..., None]], -1)
    sol = psd_solve(Hu, rhs)
    K = -w * sol[..., :na]
    k = -w[..., 0] * sol[..., na]
    return S, s, dict(K=K, k=k, Es=Es, w=w, maskc=maskc)


def _theta_parallel_forward(x0, c, A, B, theta, aux):
    """The rollout given theta (..., nct): an affine prefix scan in x."""
    K, k, Es, w = aux["K"], aux["k"], aux["Es"], aux["w"]
    xdim = x0.shape[-1]
    # u_j = w (Kx x_{j-1} + Kth theta + k) + (1 - w) E theta
    Kx = K[..., :xdim]
    th = theta[..., None, :]
    u_aff = _mv(K[..., xdim:], th) + k + (1.0 - w[..., 0]) * _mv(Es, th)
    F = A + w * (B @ Kx)
    d = c + _mv(B, u_aff)
    X = affine_scan_rollout(F, d, x0)
    Xm1 = torch.cat([x0[..., None, :], X[..., :-1, :]], -2)
    U = w[..., 0] * _mv(Kx, Xm1) + u_aff
    return X, U


@full_matmul_precision
def priccati_consensus_solve(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                             reg_x, reg_u, Nc: int):
    """Parallel-in-time twin of `riccati.riccati_consensus_solve`: the joint
    M-particle eq-only SCP subproblem in O(log N) depth. Arrays (..., M, ...),
    the particle axis the last leading one. Returns (X (..., M, N, xdim),
    U (..., M, N, udim))."""
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev,
                                         Q, R, X_ref, U_ref, reg_x, reg_u)
    S, s, aux = _theta_parallel_value(x0, c, fx, fu, Qt, xt, Rt, ut, Nc)
    maskc = aux["maskc"]
    eye = torch.eye(maskc.shape[0], dtype=S.dtype, device=S.device)
    S_tot = psum(S.sum(-3)) * maskc[:, None] * maskc[None, :] + (1.0 - maskc) * eye
    s_tot = psum(s.sum(-2)) * maskc
    theta = -psd_solve(S_tot, s_tot[..., None])[..., 0]
    return _theta_parallel_forward(x0, c, fx, fu, theta[..., None, :], aux)


@full_matmul_precision
def priccati_solve(x0, c, A, B, Qt, xt, Rt, ut) -> LQRSolution:
    """Parallel-in-time twin of `riccati.riccati_solve` (one particle a
    leading index; the same stage-cost convention and outputs)."""
    _, _, aux = _theta_parallel_value(x0, c, A, B, Qt, xt, Rt, ut, Nc=0)
    theta = c.new_zeros(c.shape[:-2] + (aux["Es"].shape[-1],))
    X, U = _theta_parallel_forward(x0, c, A, B, theta, aux)
    return LQRSolution(X=X, U=U, K=aux["K"][..., :x0.shape[-1]], k=aux["k"])


def priccati_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                       reg_x, reg_u) -> LQRSolution:
    """Parallel twin of `riccati.riccati_solve_scp`."""
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev,
                                         Q, R, X_ref, U_ref, reg_x, reg_u)
    return priccati_solve(x0, c, fx, fu, Qt, xt, Rt, ut)
