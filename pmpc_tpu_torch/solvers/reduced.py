"""Condensed consensus QP: assembly, the arrow factor/solve, and recovery.

Twin of ``pmpc_tpu/solvers/reduced.py``. States are eliminated through the
condensed dynamics map ``vec(X_i) = Ft_i vec(U_i - U_prev_i) + ft_i``, so the
decision variable per scenario is ``z = [u_cons (Nc*udim); u_free_1; ...;
u_free_M]`` and the Hessian has ARROW structure: a consensus block coupled to
M per-particle free blocks.

Every function here works on an explicit leading scenario axis B (the JAX
package maps a single problem with ``jax.vmap``): particle arrays are
``(B, M, ...)``, consensus arrays ``(B, nc, ...)``. Each sum over the
particle axis goes through `particles.psum`, so the same code runs a
problem whose particles are spread over the ranks of a particle group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..dynamics import condense
from ..ops.linalg import spd_apply, spd_factor, spd_factor_diag
from ..particles import psum


class CondensedQP(NamedTuple):
    """A batch of joint (M-particle) condensed QPs. Shapes: nc=Nc*udim,
    nf=(N-Nc)*udim, NU=N*udim, NX=N*xdim.

    The factored pieces (Qt/Rt/slew) are kept beside the explicit Hessian
    blocks: the explicit H has condition ~kappa(Ft)^2, while the factored
    product Ft'(Qt(Ft w)) + Rt w + slew terms stays at O(kappa eps), which
    keeps f32 residuals accurate."""

    Hcc: torch.Tensor  # (B, nc, nc)   consensus block (summed over particles)
    Hcf: torch.Tensor  # (B, M, nc, nf) consensus-to-free coupling
    Hff: torch.Tensor  # (B, M, nf, nf) per-particle free blocks
    qc: torch.Tensor  # (B, nc)
    qf: torch.Tensor  # (B, M, nf)
    Ft: torch.Tensor  # (B, M, NX, NU) condensed dynamics sensitivity
    g: torch.Tensor  # (B, M, NX)     x = Ft @ w + g  (w = vec(U))
    w_prev: torch.Tensor  # (B, M, NU)
    Qt: torch.Tensor  # (B, M, N, xdim, xdim) state Hessian blocks
    Rt: torch.Tensor  # (B, M, N, udim, udim) control Hessian blocks
    sl_reg: torch.Tensor  # (B, M) slew coupling weight
    sl_reg0: torch.Tensor  # (B, M) first-control slew weight

    @property
    def M(self) -> int:
        return self.Hff.shape[-3]

    @property
    def nc(self) -> int:
        return self.Hcc.shape[-1]

    @property
    def nf(self) -> int:
        return self.Hff.shape[-1]


def _slew_T(N: int, dtype, device) -> torch.Tensor:
    """Time-coupling matrix of sum_{j<N-1} ||u_{j+1} - u_j||^2 (without udim kron)."""
    T = 2.0 * torch.eye(N, dtype=dtype, device=device)
    T = T - torch.diag(torch.ones(N - 1, dtype=dtype, device=device), 1) \
        - torch.diag(torch.ones(N - 1, dtype=dtype, device=device), -1)
    T[0, 0] -= 1.0
    T[N - 1, N - 1] -= 1.0
    return T


def particle_H_q(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                 reg_x, reg_u, slew_reg, slew_reg0, slew_um1):
    """Reduced Hessian/linear term per particle over w = vec(U) (NU = N*udim).

    Takes arbitrary leading batch dims (f: (..., N, xdim), reg_x: (...),
    slew_um1: (..., udim)). Returns (H (..., NU, NU), q (..., NU), Ft, g) with
    x = Ft @ w + g."""
    N, xdim = f.shape[-2:]
    udim = fu.shape[-1]
    batch = f.shape[:-2]
    dt, dev = f.dtype, f.device
    NU = N * udim
    Ft, ft = condense(x0, f, fx, fu, X_prev, U_prev)
    w_prev = U_prev.reshape(batch + (NU,))
    g = ft - (Ft @ w_prev[..., None])[..., 0]

    eye_x = torch.eye(xdim, dtype=dt, device=dev)
    eye_u = torch.eye(udim, dtype=dt, device=dev)
    ex = lambda a: a[..., None, None, None]  # (...,) -> broadcast over (N,d,d)
    Qt = Q + ex(reg_x) * eye_x  # (..., N, xdim, xdim)
    Rt = R + ex(reg_u) * eye_u
    xt = (torch.einsum("...nij,...nj->...ni", Q, X_ref)
          + reg_x[..., None, None] * X_prev).reshape(batch + (-1,))  # (..., NX)
    ut = (torch.einsum("...nij,...nj->...ni", R, U_ref)
          + reg_u[..., None, None] * U_prev).reshape(batch + (-1,))  # (..., NU)

    Ft_r = Ft.reshape(batch + (N, xdim, NU))
    QtFt = (Qt @ Ft_r).reshape(batch + (N * xdim, NU))
    H = Ft.mT @ QtFt
    # blockdiag(Rt) by broadcast-masking
    onehot = torch.eye(N, dtype=dt, device=dev)
    D = onehot[:, None, :, None] * Rt[..., :, :, None, :]
    H = H + D.reshape(batch + (NU, NU))
    S = torch.kron(_slew_T(N, dt, dev), eye_u)  # constant (NU, NU)
    E00 = torch.zeros((NU, NU), dtype=dt, device=dev)
    E00[:udim, :udim] = eye_u
    H = H + slew_reg[..., None, None] * S + slew_reg0[..., None, None] * E00

    Qg = (Qt @ g.reshape(batch + (N, xdim, 1))).reshape(batch + (-1,))
    q = ((Qg - xt)[..., None, :] @ Ft)[..., 0, :] - ut
    um1_pad = torch.cat(
        [slew_um1, torch.zeros(batch + (NU - udim,), dtype=dt, device=dev)], dim=-1)
    q = q - slew_reg0[..., None] * um1_pad
    return H, q, Ft, g


def assemble_condensed(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                       reg_x, reg_u, slew_reg, slew_reg0, slew_um1,
                       Nc: int, weights: Optional[torch.Tensor] = None,
                       scale_slew_target: bool = True) -> CondensedQP:
    """Assemble the batch of joint M-particle condensed QPs with consensus
    horizon ``Nc``.

    Arrays carry (B, M) leading axes (x0: (B,M,xdim), f: (B,M,N,xdim), ...,
    reg_x/reg_u/slew_reg/slew_reg0: (B,M), slew_um1: (B,M,udim)).
    ``weights`` (optional, (B,M)) rescales per-particle costs like
    ``PMPC.jl/src/main.jl:96-112`` (normalized to sum to 1 per scenario);
    ``scale_slew_target`` also scales the slew anchor ``slew_um1``, as the
    reference does (``main.jl:107``).
    """
    udim = fu.shape[-1]
    if weights is not None:
        w = weights / psum(weights.sum(dim=-1, keepdim=True))
        wq = w[..., None, None, None]
        Q, R = Q * wq, R * wq
        reg_x, reg_u = reg_x * w, reg_u * w
        slew_reg, slew_reg0 = slew_reg * w, slew_reg0 * w
        if scale_slew_target:
            slew_um1 = slew_um1 * w[..., None]

    H, q, Ft, g = particle_H_q(
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
        reg_x, reg_u, slew_reg, slew_reg0, slew_um1,
    )
    nc = Nc * udim
    Hcc = psum(H[..., :nc, :nc].sum(dim=-3))
    Hcf = H[..., :nc, nc:].contiguous()
    Hff = H[..., nc:, nc:].contiguous()  # the kernel's loop-invariant input
    qc = psum(q[..., :nc].sum(dim=-2))
    qf = q[..., nc:]
    w_prev = U_prev.reshape(U_prev.shape[:-2] + (-1,))
    xdim = f.shape[-1]
    eye_x = torch.eye(xdim, dtype=f.dtype, device=f.device)
    eye_u = torch.eye(udim, dtype=f.dtype, device=f.device)
    Qt = Q + reg_x[..., None, None, None] * eye_x
    Rt = R + reg_u[..., None, None, None] * eye_u
    return CondensedQP(Hcc, Hcf, Hff, qc, qf, Ft, g, w_prev,
                       Qt=Qt, Rt=Rt, sl_reg=slew_reg, sl_reg0=slew_reg0)


def update_condensed_linear(cqp: CondensedQP, X_prev, U_prev, Q, R, X_ref, U_ref,
                            reg_x, reg_u, slew_reg0, slew_um1) -> CondensedQP:
    """Refresh the prox/ref cost terms (q) of a batch of condensed QPs for a
    new prox centre, keeping the affine map ``x = Ft w + g`` and every
    Hessian block: the stale-Jacobian SCP sub-iteration's assembly (one Ft'
    product in place of the linearization and the condensation). The map is
    anchored at the old linearization point and holds for any w, so only the
    centres reg_x X_prev / reg_u U_prev move. At the SCP fixed point the
    stale subproblem equals the fresh one. Arrays (B, M, ...), as
    `assemble_condensed` takes them (without particle weights)."""
    lead = cqp.g.shape[:-1]
    N = cqp.Qt.shape[-3]
    nc = cqp.nc
    xt = (torch.einsum("...nij,...nj->...ni", Q, X_ref)
          + reg_x[..., None, None] * X_prev).reshape(lead + (-1,))
    ut = (torch.einsum("...nij,...nj->...ni", R, U_ref)
          + reg_u[..., None, None] * U_prev).reshape(lead + (-1,))
    Qg = (cqp.Qt @ cqp.g.reshape(lead + (N, -1, 1))).reshape(lead + (-1,))
    q = ((Qg - xt)[..., None, :] @ cqp.Ft)[..., 0, :] - ut
    udim = cqp.Rt.shape[-1]
    um1_pad = torch.cat([slew_um1, slew_um1.new_zeros(lead + (q.shape[-1] - udim,))], -1)
    q = q - slew_reg0[..., None] * um1_pad
    return cqp._replace(qc=psum(q[..., :nc].sum(dim=-2)), qf=q[..., nc:])


def H_apply_factored(cqp: CondensedQP, uc: torch.Tensor, uf: torch.Tensor):
    """(H z)_c, (H z)_f in FACTORED form: Ft'(Qt(Ft w)) + Rt w + slew.
    uc (B, nc), uf (B, M, nf)."""
    N, xdim = cqp.Qt.shape[-3], cqp.Qt.shape[-1]
    udim = cqp.Rt.shape[-1]
    nc = cqp.nc
    w = z_to_w(uc, uf)  # (B, M, NU)
    lead = w.shape[:-1]
    Ftw = (cqp.Ft @ w[..., None])[..., 0]  # (B, M, NX)
    QFtw = (cqp.Qt @ Ftw.reshape(lead + (N, xdim, 1))).reshape(lead + (-1,))
    Hw = (QFtw[..., None, :] @ cqp.Ft)[..., 0, :]  # (B, M, NU)
    U = w.reshape(lead + (N, udim))
    Hw = Hw + (cqp.Rt @ U[..., None]).reshape(lead + (-1,))
    # slew coupling: sl_reg * (T kron I) w + sl_reg0 on the first block
    d = U[..., 1:, :] - U[..., :-1, :]  # (B, M, N-1, udim)
    Sw = torch.zeros_like(U)
    Sw[..., :-1, :] -= d
    Sw[..., 1:, :] += d
    Hw = Hw + cqp.sl_reg[..., None] * Sw.reshape(lead + (-1,))
    Hw[..., :udim] += cqp.sl_reg0[..., None] * U[..., 0, :]
    return psum(Hw[..., :nc].sum(dim=-2)), Hw[..., nc:]


class ArrowFactors(NamedTuple):
    """Factorization of the arrow-structured SPD system."""

    Lff: torch.Tensor  # (B, M, nf, nf) inverse Cholesky of per-particle blocks
    W: torch.Tensor  # (B, M, nf, nc)  Hff^{-1} Hcf'
    LS: torch.Tensor  # (B, nc, nc)    inverse Cholesky of the consensus Schur
    Hcf: torch.Tensor  # (B, M, nc, nf) kept for rhs reduction


def _schur(Kcc, Hcf, Lff, jitter):
    W = spd_apply(Lff, Hcf.mT)  # (B, M, nf, nc)
    S = Kcc - psum((Hcf @ W).sum(dim=-3))
    return ArrowFactors(Lff, W, spd_factor(S, jitter=jitter), Hcf)


def arrow_factor(Hcc, Hcf, Hff, jitter: float = 0.0) -> ArrowFactors:
    """Factor the arrow system (per-particle SPD factor + consensus Schur)."""
    nc, nf = Hcc.shape[-1], Hff.shape[-1]
    if nf == 0:
        LS = spd_factor(Hcc, jitter=jitter) if nc > 0 else Hcc
        return ArrowFactors(Hff, torch.zeros_like(Hcf.mT), LS, Hcf)
    Lff = spd_factor(Hff, jitter=jitter)
    if nc == 0:
        return ArrowFactors(Lff, torch.zeros_like(Hcf.mT), Hcc, Hcf)
    return _schur(Hcc, Hcf, Lff, jitter)


def arrow_factor_diag(Hcc, Hcf, Hff, wc, wf, jitter: float = 0.0) -> ArrowFactors:
    """`arrow_factor` of the box-IPM Newton system K = H + diag([wc; wf]):
    the weights only touch the block diagonals (Kcf = Hcf), so the
    loop-invariant Hff goes to the diagonal-adding factor as it is.
    wc (B, nc), wf (B, M, nf)."""
    nc, nf = Hcc.shape[-1], Hff.shape[-1]
    Kcc = Hcc + torch.diag_embed(wc) if nc > 0 else Hcc
    if nf == 0:
        LS = spd_factor(Kcc, jitter=jitter) if nc > 0 else Kcc
        return ArrowFactors(Hff, torch.zeros_like(Hcf.mT), LS, Hcf)
    Lff = spd_factor_diag(Hff, wf, jitter=jitter)
    if nc == 0:
        return ArrowFactors(Lff, torch.zeros_like(Hcf.mT), Hcc, Hcf)
    return _schur(Kcc, Hcf, Lff, jitter)


def arrow_apply(F: ArrowFactors, bc, bf):
    """Solve the factored arrow system K [uc; uf] = [bc; bf];
    bc (B, nc), bf (B, M, nf)."""
    nc, nf = F.Hcf.shape[-2], F.Hcf.shape[-1]
    if nf == 0:
        return (spd_apply(F.LS, bc) if nc > 0 else bc), bf
    if nc == 0:
        return bc, spd_apply(F.Lff, bf)
    y = spd_apply(F.Lff, bf)  # (B, M, nf)
    rhs = bc - psum((F.Hcf @ y[..., None])[..., 0].sum(dim=-2))
    uc = spd_apply(F.LS, rhs)
    uf = y - (F.W @ uc[..., None, :, None])[..., 0]
    return uc, uf


def solve_eq(cqp: CondensedQP, refine: int = 2):
    """Solve the unconstrained condensed QPs. Returns (uc (B, nc), uf (B, M, nf)).

    ``refine`` rounds of iterative refinement with FACTORED-form residuals
    recover O(kappa(Ft) eps) accuracy from the O(kappa^2 eps) explicit-H
    factorization (essential in float32)."""
    F = arrow_factor(cqp.Hcc, cqp.Hcf, cqp.Hff)
    uc, uf = arrow_apply(F, -cqp.qc, -cqp.qf)
    for _ in range(refine):
        Hc, Hf = H_apply_factored(cqp, uc, uf)
        duc, duf = arrow_apply(F, -(cqp.qc + Hc), -(cqp.qf + Hf))
        uc, uf = uc + duc, uf + duf
    return uc, uf


def z_to_w(uc: torch.Tensor, uf: torch.Tensor) -> torch.Tensor:
    """Per-particle stacked control vectors w_i = [uc; uf_i]:
    uc (..., nc), uf (..., M, nf) -> (..., M, NU)."""
    ucb = uc[..., None, :].expand(uf.shape[:-1] + uc.shape[-1:])
    return torch.cat([ucb, uf], dim=-1)


def recover_XU(cqp: CondensedQP, uc: torch.Tensor, uf: torch.Tensor, N: int):
    """(X (B,M,N,xdim), U (B,M,N,udim)) from the consensus solution."""
    w = z_to_w(uc, uf)  # (B, M, NU)
    x = (cqp.Ft @ w[..., None])[..., 0] + cqp.g  # (B, M, NX)
    lead = w.shape[:-1]
    return (x.reshape(lead + (N, x.shape[-1] // N)),
            w.reshape(lead + (N, w.shape[-1] // N)))
