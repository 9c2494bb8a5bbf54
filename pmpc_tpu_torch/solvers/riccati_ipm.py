"""Stage-structured (Riccati) box-constrained IPM: the O(N) long-horizon path.

Twin of ``pmpc_tpu/solvers/riccati_ipm.py``: control boxes, state boxes
(also under the slew augmentation, where the box sees only the first ``nxb``
entries of the stage state), per-stage control-norm cones (``soc_rc`` /
``soc_rf``), linear extra rows (``ex_*``), ``mu_target > 0``, warm start,
``tol_dynamic``, ``tau``, ``kappa``, and the numpy frontend of the host SCP
loop (`riccati_ipm_solve_np`).

The condensed IPM (`ipm.py`) materializes the O(N^2) sensitivity ``Ft`` and
factors (Nf udim)^2 dense blocks per particle. This module runs the SAME
Mehrotra predictor-corrector box IPM but solves every Newton system with a
theta-parameterized Riccati sweep, never building ``Ft``:

- the QP stays in stage form (states implicit through the dynamics chain);
- control-box barrier weights are diagonal in control space: ``diag(w_j)``
  is added to the free stages' ``Rt_j`` and ``diag(w_c)`` to the consensus
  Schur complement at the root;
- state-box barrier weights are diagonal in state space and land on the
  first ``nxb`` diagonal entries of ``Qt_j``; the state rows' primal values
  and directions come from the forward rollouts, their multiplier pulls from
  a backward adjoint sweep;
- gradients are taken in FACTORED form, by a rollout and its adjoint (the
  JAX package differentiates the rollout with ``jax.grad``; here the adjoint
  recursion is written out, `_stage_obj_grad`);
- consensus (shared first-Nc controls) is the sum over particles of the
  per-particle theta-quadratics;
- a cone's NT scaling is a dense (udim x udim) block in control space: a
  free stage's lands on its ``Rt_j``, a consensus stage's on its block of
  the theta Schur complement, so the cones cost no sweep;
- linear extra rows reduce, by one adjoint sweep over all rows at once, to
  constant dense rows over (theta, u_free) plus a shift of h by the
  zero-control rollout, and border the Newton system: the l rows' solves
  are the columns of one more backward and forward sweep an iteration, their
  l x l Schur complement one small factor, and a direction's correction by
  the rows' dual step is a product with those columns (no further sweep).

The JAX core takes one scenario of (M, ...) arrays under ``jax.vmap``; here
the scenario axis B is explicit, every stage array is (B, M, N, ...), every
reduction of the IPM is per lane (over all dims but B), and tol, mu, done,
ok, iters, failed and the step lengths are (B,) tensors. The horizon is a
Python loop whose body is a few batched matmuls on the flat (B*M, ...)
batch; a sweep holds no host sync. What does not change within a subproblem
(the augmented transitions, the consensus stages' control cost) is built
once per call, the factor of an iteration serves its predictor and its
corrector, and sweeps that the JAX code runs twice on the same numbers run
once: the rollout of the iterate serves the slacks and the gradient, the
forward sweep of a Newton solve gives the state rows' directions, the
objective's adjoint and the multipliers' pull are one sweep, and the
predictor's right-hand side rides that sweep as a second column. One IPM
iteration with state boxes is 8 sweeps: rollout, adjoint, factor, then a
linear backward and a forward sweep for the predictor, an adjoint for the
corrector's right-hand side, and the corrector's backward and forward sweep.
Under a particle group (`particles.particle_scope`) the particle axis holds
this rank's particles, and the theta sums and the IPM's reductions are
completed over the group, as in `ipm.ipm_core`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.linalg import cholesky_factor, cholesky_solve, spd_apply, spd_factor
from ..particles import group as particle_group, pany, pfirst, pmax, psum, split_max, \
    split_min, split_sum
from ..utils import default_device, full_matmul_precision, lane_where, to_host
from .coneipm import _soc_W, _soc_inv, _soc_prod, _soc_shift, _soc_step_len
from .ipm import _block_diag, _mv
from .riccati import _flat, _scp_stage_terms, augment_slew_stages


class RiccatiFactor(NamedTuple):
    """Stored factorization of one stage-structured Newton matrix, batched
    over the leading (..., M) axes; ``P0`` is the root value quadratic over
    the augmented variable y0 = [x0; theta]."""

    Aa: torch.Tensor  # (..., N, na, na) augmented transitions [[A, B E],[0, I]]
    Mn: torch.Tensor  # (..., N, na, na) cost-to-go + stage cost quadratic
    L: torch.Tensor  # (..., N, udim, udim) chol(Huu) (unused on consensus stages)
    K: torch.Tensor  # (..., N, udim, na) feedback gains (zeroed on consensus stages)
    Huy: torch.Tensor  # (..., N, udim, na) cross terms (zeroed on consensus stages)
    P0: torch.Tensor  # (..., na, na)


class RIPMState(NamedTuple):
    theta: torch.Tensor  # (B, nct)
    uf: torch.Tensor  # (B, M, nfu)
    s: torch.Tensor  # (B, mtot) slacks [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi]
    lam: torch.Tensor  # (B, mtot)
    sq: torch.Tensor  # (B, nq, 1 + udim) cone slacks ((B, 1, 1) zeros without cones)
    zq: torch.Tensor  # (B, nq, 1 + udim) cone multipliers
    mu: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) bool
    ok: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32
    badc: torch.Tensor  # (B,) int32 consecutive breakdowns (the cone retry counter)
    failed: torch.Tensor  # (B,) bool: froze on a bad (non-finite or diverged)
    #                       step without converging


def _selectors(N: int, Nc: int, udim: int, dtype, device=None):
    """Consensus selectors E_j (u_j = E_j theta for j < Nc), the free-stage
    mask, and the live-entry mask of theta. ``nct = max(nc, 1)``: the theta
    block is padded to one dead entry when Nc == 0, masked out everywhere,
    so that the warm tuple has the JAX package's layout."""
    nc = Nc * udim
    nct = max(nc, 1)
    Es = torch.zeros((N, udim, nct), dtype=dtype, device=device)
    if Nc:
        Es[:Nc] = torch.eye(nc, dtype=dtype, device=device).reshape(Nc, udim, nc)
    free = (torch.arange(N, device=device) >= Nc).to(dtype)
    maskc = (torch.arange(nct, device=device) < nc).to(dtype)
    return Es, free, nct, maskc


def _blk(j: int, xdim: int, udim: int) -> slice:
    """The entries of y = [x; theta] that hold consensus stage j's control."""
    return slice(xdim + j * udim, xdim + (j + 1) * udim)


# ---- sweeps over the flat batch: arrays (nb, N, ...), vectors as columns ----

def _augment(A, B, Nc: int, nct: int):
    """Augmented transitions of every stage, [x_j; th] = Aa [x_{j-1}; th] +
    Ba u_j with a consensus stage's control routed through theta, and
    W = [Ba | Aa], whose congruence W' Mn W holds every block the factor
    sweep needs. Constant within a subproblem."""
    nb, N, xdim, udim = B.shape
    na = xdim + nct
    Aa = A.new_zeros((nb, N, na, na))
    Aa[..., :xdim, :xdim] = A
    Aa[..., xdim:, xdim:] = torch.eye(nct, dtype=A.dtype, device=A.device)
    for j in range(Nc):
        Aa[:, j, :xdim, _blk(j, xdim, udim)] = B[:, j]
    Ba = torch.cat([B, A.new_zeros((nb, N, nct, udim))], dim=-2)
    return Aa, torch.cat([Ba, Aa], dim=-1)


def _stage_cost(Qt, Rt, Nc: int, nct: int):
    """Stage cost on y_j = [x_j; theta]: Qt on x; a consensus stage's control
    cost lands on its block of theta."""
    nb, N, xdim, _ = Qt.shape
    udim = Rt.shape[-1]
    na = xdim + nct
    Qa = Qt.new_zeros((nb, N, na, na))
    Qa[..., :xdim, :xdim] = Qt
    for j in range(Nc):
        b = _blk(j, xdim, udim)
        Qa[:, j, b, b] = Rt[:, j]
    return Qa


def _factor(W, Qa, Rk, Nc: int):
    """Backward quadratic sweep: factor the stage-structured Hessian (the
    barrier weights already folded into ``Qa`` and ``Rk``, the jitter into
    ``Rk``). RHS-independent, reused for every linear solve against this
    Newton matrix. Returns (Mn, L, K, Huy, P0)."""
    nb, N, na = Qa.shape[:3]
    udim = Rk.shape[-1]
    P = Qa.new_zeros((nb, na, na))
    Mn, L, Ks, Huy = [None] * N, [None] * N, [None] * N, [None] * N
    for j in reversed(range(N)):
        Mn[j] = P + Qa[:, j]
        W_j = W[:, j]
        # [[B'MB, B'MA], [A'MB, A'MA]] over the augmented variable
        G = W_j.mT @ (Mn[j] @ W_j)
        L[j] = cholesky_factor(Rk[:, j] + G[:, :udim, :udim])
        Huy[j] = G[:, :udim, udim:]
        Ks[j] = torch.cholesky_solve(Huy[j], L[j])  # -K_j
        if j >= Nc:
            P = torch.baddbmm(G[:, udim:, udim:], Huy[j].mT, Ks[j], alpha=-1.0)
        else:
            # consensus stage: its control is not eliminated. The products
            # with 0 keep what the JAX sweep's weight w_j = 0 keeps: a NaN
            Ks[j], Huy[j] = 0.0 * Ks[j], 0.0 * Huy[j]
            P = G[:, udim:, udim:] - Huy[j].mT @ Ks[j]
        P = 0.5 * (P + P.mT)
    return (torch.stack(Mn, 1), torch.stack(L, 1), -torch.stack(Ks, 1),
            torch.stack(Huy, 1), P)


def _lin_backward_flat(Aa, Mn, L, Huy, B, utf, Nc: int, c=None, xt=None, utc=None):
    """Backward LINEAR sweep against a stored factor.

    Stage linear terms enter the objective as ``- xt_j' x_j - ut_j' u_j``;
    ``utf`` (nb, N - Nc, udim, k) applies to the eliminated (free) stage
    controls, ``utc`` (nb, N, udim, 1) to the consensus-stage controls
    (routed onto the theta block); ``c`` is the dynamics offset. None stands
    for zeros, as in every Newton solve. The k columns of ``utf`` are k
    right-hand sides. Returns (p0 (nb, na, k), k (nb, N, udim, k), zero on
    the consensus stages)."""
    nb, N, xdim, udim = B.shape
    ncol = utf.shape[-1]
    p = Aa.new_zeros((nb, Aa.shape[-1], ncol))
    ks = [Aa.new_zeros((nb, udim, ncol))] * N
    for j in reversed(range(N)):
        if xt is not None or (utc is not None and j < Nc):
            p = p.clone()
            if xt is not None:
                p[:, :xdim] -= xt[:, j]
            if utc is not None and j < Nc:
                p[:, _blk(j, xdim, udim)] -= utc[:, j]
        if c is not None:
            p = torch.baddbmm(p, Mn[:, j, :, :xdim], c[:, j])
        if j >= Nc:
            # k_j = -Huu^-1 hu, hu = B'(M c + m)_x - utf_j
            ks[j] = torch.cholesky_solve(
                torch.baddbmm(utf[:, j - Nc], B[:, j].mT, p[:, :xdim], alpha=-1.0),
                L[:, j])
            p = torch.baddbmm(Aa[:, j].mT @ p, Huy[:, j].mT, ks[j])
        else:
            p = Aa[:, j].mT @ p
    return p, torch.stack(ks, 1)


def _forward_flat(A, B, K, k, theta, Nc: int, x0=None, c=None):
    """Forward rollout given theta (nb, nct, k) and the stage gains: X
    (nb, N, xdim, k), U (nb, N, udim, k), one column per right-hand side.
    ``x0``/``c`` None: zeros."""
    nb, N, xdim, udim = B.shape
    kk = k + K[..., xdim:] @ theta[:, None]  # the gains' theta part, every stage
    x = A.new_zeros((nb, xdim, theta.shape[-1])) if x0 is None else x0
    Xs, Us = [None] * N, [None] * N
    for j in range(N):
        if j >= Nc:
            Us[j] = torch.baddbmm(kk[:, j], K[:, j, :, :xdim], x)
        else:
            Us[j] = theta[:, j * udim:(j + 1) * udim]
        Ax = A[:, j] @ x if c is None else torch.baddbmm(c[:, j], A[:, j], x)
        x = Xs[j] = torch.baddbmm(Ax, B[:, j], Us[j])
    return torch.stack(Xs, 1), torch.stack(Us, 1)


def _rollout_flat(x0, c, A, B, U):
    """States x_j = c_j + A_j x_{j-1} + B_j u_j for given stage controls
    (nb, N, udim, 1)."""
    cBu = B @ U + c
    x, Xs = x0, [None] * A.shape[1]
    for j in range(A.shape[1]):
        x = Xs[j] = torch.baddbmm(cBu[:, j], A[:, j], x)
    return torch.stack(Xs, 1)


def _adjoint_flat(A, B, V):
    """Gradient w.r.t. the stage controls of sum_j v_j' x_j, one result per
    column of V (nb, N, xdim, k): p_j = v_j + A_{j+1}' p_{j+1}, g_j = B_j' p_j."""
    N = A.shape[1]
    ps = [None] * N
    p = ps[N - 1] = V[:, N - 1]
    for j in reversed(range(N - 1)):
        p = ps[j] = torch.baddbmm(V[:, j], A[:, j + 1].mT, p)
    return B.mT @ torch.stack(ps, 1)


def _stage_U(theta, uf, Nc: int, udim: int, maskc):
    """Full (B, M, N, udim) stage controls from the reduced variables
    theta (B, nct), uf (B, M, nfu)."""
    Bn, M = uf.shape[:2]
    Uc = (theta * maskc)[:, None, :Nc * udim].reshape(Bn, 1, Nc, udim)
    return torch.cat([Uc.expand(Bn, M, Nc, udim), uf.reshape(Bn, M, uf.shape[-1] // udim, udim)], dim=2)


def _pull_cols(gU, Bn: int, M: int, Nc: int, nct: int):
    """Stage-control gradients (B*M, N, udim, k) -> (theta part (B, nct, k),
    summed over the particles; free part (B, M, nfu, k))."""
    N, udim, k = gU.shape[1:]
    g = gU.reshape(Bn, M, N, udim, k)
    gth = g.new_zeros((Bn, nct, k))
    if Nc:
        gth[:, :Nc * udim] = psum(g[:, :, :Nc].sum(1)).reshape(Bn, Nc * udim, k)
    return gth, g[:, :, Nc:].reshape(Bn, M, (N - Nc) * udim, k)


def _pull(gU, Bn: int, M: int, Nc: int, nct: int):
    """`_pull_cols` of one column: (theta part (B, nct), free part (B, M, nfu))."""
    gth, gf = _pull_cols(gU, Bn, M, Nc, nct)
    return gth[..., 0], gf[..., 0]


# ---- the same sweeps over (..., M, N, ...) arrays, one call each ----

def riccati_factor(A, B, Qt, Rt_eff, Nc: int, xdim: int,
                   kappa: float = 0.0) -> RiccatiFactor:
    """Backward quadratic sweep of every particle. ``Nc`` stands for the
    JAX function's selectors and free-stage mask."""
    lead = A.shape[:-3]
    udim = B.shape[-1]
    nct = max(Nc * udim, 1)
    Aa, W = _augment(_flat(A, 3), _flat(B, 3), Nc, nct)
    Rk = _flat(Rt_eff, 3) + kappa * torch.eye(udim, dtype=A.dtype, device=A.device)
    out = (Aa,) + _factor(W, _stage_cost(_flat(Qt, 3), _flat(Rt_eff, 3), Nc, nct), Rk, Nc)
    return RiccatiFactor(*(a.reshape(lead + a.shape[1:]) for a in out))


def _lin_backward(fac: RiccatiFactor, B, c, xt, utf, utc, Nc: int):
    """Backward linear sweep of every particle against a stored factor: c,
    xt (..., N, xdim), utf, utc (..., N, udim) as the JAX function takes
    them (``utf`` is read on the free stages only). Returns (p0 (..., na),
    k (..., N, udim))."""
    lead = B.shape[:-3]
    col = lambda a: _flat(a, 2)[..., None]
    p0, k = _lin_backward_flat(
        _flat(fac.Aa, 3), _flat(fac.Mn, 3), _flat(fac.L, 3), _flat(fac.Huy, 3),
        _flat(B, 3), col(utf)[:, Nc:], Nc, c=col(c), xt=col(xt), utc=col(utc))
    return p0[..., 0].reshape(lead + p0.shape[1:2]), k[..., 0].reshape(lead + k.shape[1:3])


def _forward(x0, c, A, B, K, k, theta, Nc: int):
    """Forward rollout of every particle given theta (..., nct), one per
    lane, and the stage gains. Returns X (..., M, N, xdim), U."""
    lead = B.shape[:-3]
    th = theta[..., None, :].expand(lead + theta.shape[-1:])
    X, U = _forward_flat(_flat(A, 3), _flat(B, 3), _flat(K, 3), _flat(k, 2)[..., None],
                         _flat(th, 1)[..., None], Nc, x0=_flat(x0, 1)[..., None],
                         c=_flat(c, 2)[..., None])
    return X[..., 0].reshape(lead + X.shape[1:3]), U[..., 0].reshape(lead + U.shape[1:3])


def _schur_factor(P0, wc, maskc, xdim: int, kappa: float, S_extra=None):
    """Factor of the consensus system: the particles' theta-quadratics summed
    (P0 (B, M, na, na)), the consensus box weights wc (B, nct) on the
    diagonal, ``S_extra`` (B, nct, nct) (the consensus stages' cone blocks)
    on the live entries, dead theta entries pinned to 0 by identity rows."""
    nct = maskc.shape[0]
    eye = torch.eye(nct, dtype=P0.dtype, device=P0.device)
    live = maskc[:, None] * maskc[None, :]
    S_tot = psum(P0[..., xdim:, xdim:].sum(dim=-3)) * live \
        + torch.diag_embed(wc * maskc) + (1.0 - maskc) * eye + kappa * eye
    if S_extra is not None:
        S_tot = S_tot + S_extra * live
    return cholesky_factor(S_tot)


def _consensus_solve(fac: RiccatiFactor, B, c, x0, xt, utf, utc, wc, theta_lin,
                     Nc: int, maskc, xdim: int, kappa: float):
    """Solve one stage-structured system against a stored factor:
    per-particle linear backward sweeps, the theta Schur reduction (the sum
    over the particle axis), per-particle forward rollouts. Arrays
    (B, M, N, ...), wc and theta_lin (B, nct).

    Returns (theta (B, nct), X (B, M, N, xdim), U (B, M, N, udim))."""
    p0, k = _lin_backward(fac, B, c, xt, utf, utc, Nc)
    s = p0[..., xdim:] + (fac.P0[..., xdim:, :xdim] @ x0[..., None])[..., 0]
    rhs = (theta_lin - psum(s.sum(dim=-2))) * maskc
    theta = cholesky_solve(_schur_factor(fac.P0, wc, maskc, xdim, kappa), rhs)
    X, U = _forward(x0, c, fac.Aa[..., :xdim, :xdim], B, fac.K, k, theta, Nc)
    return theta, X, U


def _stage_obj_grad(theta, uf, x0, c, A, B, Qt, xt, Rt, ut, Nc: int, maskc):
    """Gradient of the stage objective w.r.t. (theta (B, nct), uf (B, M,
    nfu)): the FACTORED ``H z + q``, by rollout and adjoint with no
    condensed Ft. Roll out X; v_j = Qt_j x_j - xt_j; backward
    p_j = v_j + A_{j+1}' p_{j+1}; gU_j = Rt_j u_j - ut_j + B_j' p_j; the theta
    part sums the consensus stages' gU over the particles."""
    Bn, M = uf.shape[:2]
    udim = B.shape[-1]
    A_, B_ = _flat(A, 3), _flat(B, 3)
    U = _flat(_stage_U(theta, uf, Nc, udim, maskc), 2)[..., None]
    X = _rollout_flat(_flat(x0, 1)[..., None], _flat(c, 2)[..., None], A_, B_, U)
    V = _flat(Qt, 3) @ X - _flat(xt, 2)[..., None]
    gU = _flat(Rt, 3) @ U - _flat(ut, 2)[..., None] + _adjoint_flat(A_, B_, V)
    gth, gf = _pull(gU, Bn, M, Nc, maskc.shape[0])
    return gth * maskc, gf


@full_matmul_precision
def riccati_ipm_core(
    x0, c, A, B, Qt, xt, Rt, ut,
    lo_c, hi_c, lo_f, hi_f,
    Nc: int,
    iters: int = 20,
    tol_exp: int = -6,
    kappa: float = 0.0,
    warm: Optional[Tuple] = None,
    tol_dynamic: Optional[torch.Tensor] = None,
    tau: Optional[float] = None,
    x_lo=None,
    x_hi=None,
    soc_rc=None,
    soc_rf=None,
    mu_target: float = 0.0,
    ex_Gc=None,
    ex_Gf=None,
    ex_Gx=None,
    ex_h=None,
    scan_unroll: int = 1,
):
    """Mehrotra IPM over (theta, u_free) with Riccati-sweep Newton solves.

    Args:
        x0 (B, M, xdim); c/A/B/Qt/xt/Rt/ut: per-particle stage data
            (B, M, N, ...) in the `riccati.py` cost convention.
        lo_c/hi_c (B, nct): consensus control bounds (+-inf when absent;
            particle 0's rows).
        lo_f/hi_f (B, M, nfu): free control bounds, nfu = (N - Nc) * udim.
        warm: (theta (B, nct), uf (B, M, nfu), s (B, mtot), lam (B, mtot))
            from a previous nearby solve; with cones the same plus (sq, zq)
            (B, nq, 1 + udim).
        tol_dynamic (B,): overrides the static ``10**tol_exp`` where larger.
        x_lo/x_hi (B, M, N, nxb): STATE box bounds on the rolled-out states
            x_1..x_N (+-inf rows inactive). ``nxb`` may be smaller than the
            stage state dim (the slew augmentation appends control memory the
            box must not see).
        soc_rc (B, Nc) / soc_rf (B, M, Nf): per-stage control-norm cone radii
            ``||u_j|| <= r_j`` (+inf: no cone; the consensus stages carry one
            shared cone each, particle 0's radius). nq = Nc + M Nf cones,
            consensus first. A breakdown (a non-finite step, or a cone point
            that left its cone) keeps the iterate, shifts the cone points
            inward and retries with a regularization boost; the fourth in a
            row gives up.
        mu_target > 0: stop on the central path at that duality measure
            (the logbarrier smoothing's solution), then 10 pure centering
            steps.
        ex_Gc (B, l, nct) / ex_Gf (B, l, M, nfu) / ex_Gx (B, l, M, N, nxe) /
            ex_h (B, l): LINEAR extra rows ``g'z <= h`` over the full
            consensus layout, split by variable block (+inf h rows inactive;
            ``nxe`` may be smaller than the stage state dim, as ``nxb``).
            The state block reduces by one adjoint sweep (A, B are constant
            within the subproblem) to dense rows over (theta, uf), and h by
            the zero-control rollout; the rows border the Newton system, their
            dual step from the l x l Schur system
            ``(G A^-1 G' + W^-1) dlam = G A^-1 b - c2``.
        scan_unroll: taken for signature parity, without effect (it tunes
            the JAX package's scans).

    Returns (theta (B, nct), uf (B, M, nfu), stats): mu, iters, converged,
    failed (each (B,)), s, lam, sq, zq. Recover trajectories with
    `recover_XU_stage`.
    """
    Bn, M, N, xdim = c.shape
    udim = B.shape[-1]
    dtype, dev = c.dtype, c.device
    nb = Bn * M
    _, _, nct, maskc = _selectors(N, Nc, udim, dtype, dev)
    Nf = N - Nc
    nfu = Nf * udim
    has_x = x_lo is not None
    has_soc = soc_rc is not None
    has_ex = ex_h is not None
    nxb = x_lo.shape[-1] if has_x else 0
    mx = M * N * nxb
    o_chi, o_flo, o_fhi = nct, 2 * nct, 2 * nct + M * nfu
    o_xlo = 2 * nct + 2 * M * nfu
    o_xhi = o_xlo + mx
    o_ex = o_xhi + mx

    tol = torch.full((Bn,), 10.0 ** tol_exp, dtype=dtype, device=dev)
    if tol_dynamic is not None:
        tol = torch.maximum(tol_dynamic.to(dtype), tol)
    sqrt_tol = torch.sqrt(tol)
    mu_ok_floor = torch.clamp(tol, min=mu_target * 1.05)
    tau = 0.99 if tau is None else tau

    bound_blocks = [lo_c, hi_c, lo_f.reshape(Bn, -1), hi_f.reshape(Bn, -1)]
    if has_x:
        bound_blocks += [x_lo.reshape(Bn, -1), x_hi.reshape(Bn, -1)]
    if has_ex:
        bound_blocks += [ex_h]
    mask = torch.isfinite(torch.cat(bound_blocks, -1))
    mask[:, :2 * nct] &= (maskc > 0).repeat(2)
    if has_ex and particle_group() is not None:
        raise ValueError("riccati_ipm_core: extra rows do not take a particle group")
    n_c = 2 * nct  # the consensus rows lead the flat layout
    n_act = split_sum(mask, n_c).to(dtype)

    # -- the cones: (B, nq, p) points, consensus stages first ------------------
    if has_soc:
        p = udim + 1
        nq = Nc + M * Nf
        r_flat = torch.cat([soc_rc, soc_rf.reshape(Bn, -1)], -1)  # (B, nq)
        rmask = torch.isfinite(r_flat)
        rmaskf = rmask.to(dtype)
        e_soc = torch.zeros((nq, p), dtype=dtype, device=dev)
        e_soc[:, 0] = 1.0
        n_act = n_act + split_sum(rmask, Nc).to(dtype)
        eye_u = torch.eye(udim, dtype=dtype, device=dev)
        eye_c = torch.eye(nct, dtype=dtype, device=dev)

        def soc_viol(v):
            """`_soc_viol` over the live cones of every rank."""
            return split_max(rmaskf * (torch.linalg.vector_norm(v[..., 1:], dim=-1)
                                       - v[..., 0]), Nc)

        def cone_vals(theta, uf):
            """h - G z per cone: [r_k; u_stage] (B, nq, p); e on masked cones."""
            u_all = torch.cat([(theta * maskc)[:, :Nc * udim].reshape(Bn, Nc, udim),
                               uf.reshape(Bn, M * Nf, udim)], 1)
            vals = torch.cat([r_flat[..., None], u_all], -1)
            return torch.where(rmask[..., None], vals, e_soc)

        def cone_scatter(vq):
            """S' vq[1:] -> (theta part (B, nct), free part (B, M, nfu));
            masked cones give 0."""
            vq = vq * rmaskf[..., None]
            gth = torch.cat([vq[:, :Nc, 1:].reshape(Bn, Nc * udim),
                             vq.new_zeros((Bn, nct - Nc * udim))], -1)
            return gth * maskc, vq[:, Nc:, 1:].reshape(Bn, M, nfu)

        def cone_gdv(dth, duf):
            """G dz per cone = [0; -du_stage]; masked cones give 0."""
            du = cone_vals(dth, duf)[..., 1:]
            return torch.cat([torch.zeros_like(du[..., :1]), -du], -1) * rmaskf[..., None]
    n_act = torch.clamp(n_act, min=1.0)

    # the flat (B*M) batch the sweeps run on, vectors as columns
    col = lambda a: _flat(a, 2)[..., None]
    x0f, cf, xtf, utf_ = _flat(x0, 1)[..., None], col(c), col(xt), col(ut)
    Af, Bf, Qtf, Rtf = _flat(A, 3), _flat(B, 3), _flat(Qt, 3), _flat(Rt, 3)
    # constant within the subproblem: the augmented transitions, the stage
    # cost over [x; theta] (a consensus stage carries no box weight on its
    # Rt), the jittered control Hessians
    Aa, W = _augment(Af, Bf, Nc, nct)
    Qa0 = _stage_cost(Qtf, Rtf, Nc, nct)
    Rk0 = Rtf + kappa * torch.eye(udim, dtype=dtype, device=dev)

    def rollout(theta, uf):
        """Stage controls and states of an iterate, (nb, N, ., 1) columns."""
        U = _flat(_stage_U(theta, uf, Nc, udim, maskc), 2)[..., None]
        return U, _rollout_flat(x0f, cf, Af, Bf, U)

    if has_ex:
        # the rows' state block, one adjoint sweep with the l rows as its
        # columns: constant dense rows over (theta, uf); the states at zero
        # controls shift h
        l_ex, nxe = ex_h.shape[-1], ex_Gx.shape[-1]
        Vx = ex_Gx.permute(0, 2, 3, 4, 1).reshape(nb, N, nxe, l_ex)
        if nxe < xdim:
            Vx = torch.nn.functional.pad(Vx, (0, 0, 0, xdim - nxe))
        gx_th, gx_f = _pull_cols(_adjoint_flat(Af, Bf, Vx), Bn, M, Nc, nct)
        exr_c = (ex_Gc + gx_th.mT) * maskc  # (B, l, nct)
        exr_f = ex_Gf.reshape(Bn, l_ex, M * nfu) + gx_f.reshape(Bn, M * nfu, l_ex).mT
        X_zero = _rollout_flat(x0f, cf, Af, Bf, Af.new_zeros((nb, N, udim, 1)))
        h_eff = ex_h - (ex_Gx * X_zero[:, :, :nxe, 0].reshape(Bn, 1, M, N, nxe)).sum((2, 3, 4))

        def ex_dot(theta, uf):
            """The rows' values over the reduced variables, (B, l)."""
            return (exr_c @ theta[..., None] + exr_f @ uf.reshape(Bn, -1, 1))[..., 0]

        def ex_pull(v):
            """G_ex' v: (theta part (B, nct), free part (B, M, nfu))."""
            return (v[:, None] @ exr_c)[:, 0], (v[:, None] @ exr_f)[:, 0].reshape(Bn, M, nfu)

    def boxed(X):
        """The entries of the states that the box sees, (B, M*N*nxb)."""
        return X[:, :, :nxb, 0].reshape(Bn, mx)

    def slack_vals(theta, uf, X):
        vals = [theta - lo_c, hi_c - theta,
                (uf - lo_f).reshape(Bn, -1), (hi_f - uf).reshape(Bn, -1)]
        if has_x:
            Xb = boxed(X)
            vals += [Xb - x_lo.reshape(Bn, mx), x_hi.reshape(Bn, mx) - Xb]
        if has_ex:
            vals += [h_eff - ex_dot(theta * maskc, uf)]
        return torch.cat(vals, -1)

    def x_rows(v):
        """State-row multipliers of a flat vector as adjoint sources
        (nb, N, xdim, 1), zero past the boxed entries."""
        vx = (v[:, o_xhi:o_ex] - v[:, o_xlo:o_xhi]).reshape(nb, N, nxb, 1)
        return torch.nn.functional.pad(vx, (0, 0, 0, xdim - nxb)) if nxb < xdim else vx

    def u_rows(v):
        """(G' v) of the control-box rows."""
        return (v[:, o_chi:o_flo] - v[:, :nct],
                (v[:, o_fhi:o_xlo] - v[:, o_flo:o_fhi]).reshape(Bn, M, nfu))

    def mu_of(s_, lam_, sq_, zq_):
        tot = split_sum(torch.where(mask, s_ * lam_, 0.0), n_c)
        if has_soc:
            tot = tot + split_sum(rmaskf * (sq_ * zq_).sum(-1), Nc)
        return tot / n_act

    def newton_factor(wc, wf, wx, Bq_free=None, Sc_blk=None):
        """Factor H + diag(w) (+ the cone blocks): free-stage box weights
        onto Rt_j, consensus box weights onto the theta Schur complement,
        state-box weights onto the first nxb diagonal entries of Qt_j (the
        recursion propagates them through the dynamics chain); the free
        stages' cone blocks (nb, Nf, udim, udim) onto Rt_j, the consensus
        stages' (B, nct, nct) onto the theta Schur complement."""
        Rk = Rk0.clone()
        Rk[:, Nc:].diagonal(dim1=-2, dim2=-1).add_(wf.reshape(nb, Nf, udim))
        if Bq_free is not None:
            Rk[:, Nc:] += Bq_free
        Qa = Qa0
        if has_x:
            Qa = Qa0.clone()
            Qa.diagonal(dim1=-2, dim2=-1)[..., :nxb].add_(wx.reshape(nb, N, nxb))
        Mn, L, K, Huy, P0 = _factor(W, Qa, Rk, Nc)
        LS = _schur_factor(P0.reshape(Bn, M, xdim + nct, xdim + nct), wc, maskc,
                           xdim, kappa, Sc_blk)

        def solve(bc, bf):
            """(dtheta (B, nct, k), duf (B, M, nfu, k), the states' direction
            (B*M, N, xdim, k)) for k right-hand sides bc (B, nct, k), bf
            (B, M, nfu, k)."""
            k_ = bc.shape[-1]
            p0, k = _lin_backward_flat(Aa, Mn, L, Huy, Bf, bf.reshape(nb, Nf, udim, k_), Nc)
            s = psum(p0[:, xdim:].reshape(Bn, M, nct, k_).sum(1))
            th = cholesky_solve(LS, (bc - s) * maskc[:, None])
            th_p = th[:, None].expand(Bn, M, nct, k_).reshape(nb, nct, k_)
            dX, dU = _forward_flat(Af, Bf, K, k, th_p, Nc)
            return th, dU[:, Nc:].reshape(Bn, M, nfu, k_), dX

        return solve

    # -- initialization --------------------------------------------------------
    if warm is not None:
        th0, uf0, _, warm_lam = warm[:4]
        sv = slack_vals(th0, uf0, rollout(th0, uf0)[1])
        s0 = torch.where(mask, torch.clamp(sv, min=1e-2), 1.0)
        lam0 = torch.where(mask, torch.clamp(warm_lam, min=1e-2), 0.0)
    else:
        # cold start: the unconstrained (equality) stage solve
        zeros_c = torch.zeros_like(lo_c)
        th0, _, U0 = _consensus_solve(
            riccati_factor(A, B, Qt, Rt, Nc, xdim, kappa=kappa), B, c, x0, xt, ut, ut,
            zeros_c, zeros_c, Nc, maskc, xdim, kappa)
        uf0 = U0[:, :, Nc:].reshape(Bn, M, nfu)
        sv = slack_vals(th0, uf0, rollout(th0, uf0)[1])
        s0 = torch.where(mask, torch.clamp(sv, min=1.0), 1.0)
        lam0 = torch.where(mask, 1.0 / s0, 0.0)
    if has_soc:
        sq0 = _soc_shift(cone_vals(th0, uf0))
        if warm is not None and len(warm) >= 6:
            zq0 = _soc_shift(torch.where(rmask[..., None], warm[5], e_soc))
        else:
            zq0 = e_soc.expand(Bn, nq, p).clone()
    else:  # placeholders: the cone fields of the state carry nothing
        sq0 = zq0 = torch.zeros((Bn, 1, 1), dtype=dtype, device=dev)
    false = torch.zeros(Bn, dtype=torch.bool, device=dev)
    zero_i = torch.zeros(Bn, dtype=torch.int32, device=dev)
    state = RIPMState(th0, uf0, s0, lam0, sq0, zq0, mu_of(s0, lam0, sq0, zq0),
                      false, false, zero_i, zero_i, false)

    w_max = 1e14 if dtype == torch.float64 else 1e7

    def body(st: RIPMState, mehrotra: bool = True) -> RIPMState:
        theta, uf, s, lam, sq, zq, mu, done, ok, it_count, badc, failed = st
        U, X = rollout(theta, uf)
        r_p = torch.where(mask, s - slack_vals(theta, uf, X), 0.0)
        # the first solve's complementarity target: s*lam for the predictor,
        # mu_target for a pure centering step
        r_c1 = torch.where(mask, s * lam - (0.0 if mehrotra else mu_target), 0.0)
        v1 = torch.where(mask, (lam * r_p - r_c1) / s, 0.0)
        # gradient of the Lagrangian in factored form: the objective's
        # adjoint sources Qt x - xt and the state rows' multipliers share one
        # sweep; the first solve's state-row pull is its second column
        V = Qtf @ X - xtf
        if has_x:
            V = torch.cat([V + x_rows(lam), x_rows(v1)], dim=-1)
        pulled = _adjoint_flat(Af, Bf, V)
        gth, gfu = _pull(Rtf @ U - utf_ + pulled[..., :1], Bn, M, Nc, nct)
        dc, df = u_rows(lam)
        gc, gf = (gth + dc) * maskc, gfu + df
        if has_ex:
            ec, ef = ex_pull(lam[:, o_ex:])
            gc, gf = gc + ec * maskc, gf + ef

        w = torch.where(mask, torch.clamp(lam / s, max=w_max), 0.0)
        cone_kw = {}
        if has_soc:
            # the cone Jacobian G_k' z_k = -S_k' z_k[1:]
            zc, zf = cone_scatter(zq)
            gc, gf = gc - zc, gf - zf
            # NT scalings per cone; r_pq = s - (h - Gz)
            r_pq = (sq - cone_vals(theta, uf)) * rmaskf[..., None]
            Wq, Wqinv, Wq2inv, lamq = _soc_W(sq, zq)
            Bq = Wq2inv[..., 1:, 1:] * rmaskf[..., None, None]
            # a breakdown keeps the iterate and re-solves with a boosted
            # regularization: the cone scalings grow ~1/mu near the boundary
            boost = (badc.to(dtype) ** 2 * 1e-5 * (1.0 + mu))[:, None, None]
            Bq_free = Bq[:, Nc:].reshape(Bn, M, Nf, udim, udim) + boost[..., None, None] * eye_u
            Sc_blk = boost * eye_c
            if Nc:
                Sc_blk = Sc_blk + torch.nn.functional.pad(
                    _block_diag(Bq[:, :Nc]), (0, nct - Nc * udim, 0, nct - Nc * udim))
            cone_kw = dict(Bq_free=Bq_free.reshape(nb, Nf, udim, udim), Sc_blk=Sc_blk)
        solve_cols = newton_factor(
            w[:, :nct] + w[:, o_chi:o_flo],
            (w[:, o_flo:o_fhi] + w[:, o_fhi:o_xlo]).reshape(Bn, M, nfu),
            w[:, o_xlo:o_xhi] + w[:, o_xhi:o_ex] if has_x else None, **cone_kw)

        def solve(bc, bf):
            th, duf, dX = solve_cols(bc[..., None], bf[..., None])
            return th[..., 0], duf[..., 0], dX

        if has_ex:
            # the bordered solve: the l rows stay explicit, their dual step
            # from the l x l Schur system (G A^-1 G' + W^-1) dlam = G A^-1 b
            # - c2 (folding them into A multiplies the solve error by
            # w_ex ~ 1/mu). A^-1 G' is one solve with the rows as columns; the
            # solve of b - G' dlam is then y - (A^-1 G') dlam
            mask_ex = mask[:, o_ex:]
            Zth, Zuf, ZdX = solve_cols(exr_c.mT, exr_f.mT.reshape(Bn, M, nfu, l_ex))
            S_ex = exr_c @ Zth + exr_f @ Zuf.reshape(Bn, M * nfu, l_ex)
            S_ex = S_ex + torch.diag_embed(torch.where(
                mask_ex, 1.0 / torch.clamp(w[:, o_ex:], min=1e-30), 1e30))
            LS_ex = spd_factor(S_ex, jitter=1e-12)

            def solve_K(bc, bf, c2):
                th, duf, dX = solve(bc, bf)
                dle = torch.where(mask_ex, spd_apply(LS_ex, ex_dot(th, duf) - c2), 0.0)
                dle_p = dle[:, None].expand(Bn, M, l_ex).reshape(nb, 1, l_ex, 1)
                return (th - (Zth @ dle[..., None])[..., 0],
                        duf - (Zuf @ dle[:, None, :, None])[..., 0],
                        dX - ZdX @ dle_p, dle)
        else:
            def solve_K(bc, bf, c2):
                return solve(bc, bf) + (None,)

        def c2_of(r_c):
            """The rows' Schur right-hand side, -r_p + r_c / lam per row."""
            if not has_ex:
                return None
            return torch.where(mask[:, o_ex:], -r_p[:, o_ex:] + r_c[:, o_ex:]
                               / torch.clamp(lam[:, o_ex:], min=1e-30), 0.0)

        def newton_rhs(v, x_pull, dq_c):
            """-(grad + G'v) (+ the cones' term); ``x_pull`` is the adjoint
            of v's state rows. The extra rows' part of v is not folded in:
            it enters through the Schur system (`c2_of`)."""
            dc, df = u_rows(v)
            if has_x:
                xc, xf = _pull(x_pull, Bn, M, Nc, nct)
                dc, df = dc + xc * maskc, df + xf
            bc, bf = -(gc + dc) * maskc, -(gf + df)
            vq = None
            if has_soc:
                vq = _mv(Wq2inv, r_pq) - _mv(Wqinv, _soc_prod(_soc_inv(lamq), dq_c))
                vqc, vqf = cone_scatter(vq)  # rhs -= G' vq = +S' vq[1:]
                bc, bf = bc + vqc, bf + vqf
            return bc, bf, vq

        def recover_steps(dth, duf, dX, v, vq, dle):
            parts = [-dth, dth, -duf.reshape(Bn, -1), duf.reshape(Bn, -1)]
            if has_x:
                dXb = boxed(dX)
                parts += [-dXb, dXb]
            if has_ex:
                parts += [ex_dot(dth * maskc, duf)]
            gdz = torch.cat(parts, -1)
            ds = torch.where(mask, -r_p - gdz, 0.0)
            dlam = torch.where(mask, w * gdz + v, 0.0)
            if has_ex:
                # the Schur system's dual step is the stable one (w*gdz + v
                # cancels at w ~ 1/mu)
                dlam = torch.cat([dlam[:, :o_ex], torch.where(mask[:, o_ex:], dle, 0.0)], -1)
            dsq = dzq = None
            if has_soc:
                gdq = cone_gdv(dth, duf)
                dsq = (-r_pq - gdq) * rmaskf[..., None]
                dzq = (_mv(Wq2inv, gdq) + vq) * rmaskf[..., None]
            return ds, dlam, dsq, dzq

        def step_len(ds, dlam, dsq, dzq):
            # torch.where evaluates both branches: the inner guards keep the
            # unused branch finite
            rp_ = torch.where(mask & (ds < 0),
                              -s / torch.where(ds < 0, ds, -1.0), torch.inf)
            rd_ = torch.where(mask & (dlam < 0),
                              -lam / torch.where(dlam < 0, dlam, -1.0), torch.inf)
            mins = split_min(torch.stack([rp_, rd_], 1), n_c)  # (B, 2)
            ap = torch.clamp(tau * mins[:, 0], max=1.0)
            ad = torch.clamp(tau * mins[:, 1], max=1.0)
            if has_soc:
                aq_p = torch.where(rmask, _soc_step_len(sq, dsq), torch.inf)
                aq_d = torch.where(rmask, _soc_step_len(zq, dzq), torch.inf)
                ap = torch.minimum(ap, tau * split_min(aq_p, Nc))
                ad = torch.minimum(ad, tau * split_min(aq_d, Nc))
                # NT scaling assumes s and z move together: separate steps
                # let a cone crash into its boundary and stall
                ap = ad = torch.minimum(ap, ad)
            return ap, ad

        def ahead(x, a, dx):
            return x + a.reshape((Bn,) + (1,) * (x.ndim - 1)) * dx

        lam2 = _soc_prod(lamq, lamq) if has_soc else None
        if mehrotra:
            # predictor (affine)
            bc, bf, vq_a = newton_rhs(v1, pulled[..., 1:], lam2)
            dth_a, duf_a, dX_a, dle_a = solve_K(bc, bf, c2_of(r_c1))
            ds_a, dlam_a, dsq_a, dzq_a = recover_steps(dth_a, duf_a, dX_a, v1, vq_a, dle_a)
            ap_a, ad_a = step_len(ds_a, dlam_a, dsq_a, dzq_a)
            mu_aff = mu_of(ahead(s, ap_a, ds_a), ahead(lam, ad_a, dlam_a),
                           ahead(sq, ap_a, dsq_a) if has_soc else sq,
                           ahead(zq, ad_a, dzq_a) if has_soc else zq)
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
            sig_mu = torch.clamp(sigma * mu, min=mu_target)  # central-path floor
            # corrector (same factorization)
            r_c = torch.where(mask, s * lam + ds_a * dlam_a - sig_mu[:, None], 0.0)
            v = torch.where(mask, (lam * r_p - r_c) / s, 0.0)
            dq_c = None
            if has_soc:
                dq_c = lam2 + _soc_prod(_mv(Wqinv, dsq_a), _mv(Wq, dzq_a)) \
                    - sig_mu[:, None, None] * e_soc
            bc, bf, vq = newton_rhs(v, _adjoint_flat(Af, Bf, x_rows(v)) if has_x else None,
                                    dq_c)
        else:
            # pure centering Newton on the perturbed KKT at mu_target
            v, r_c = v1, r_c1
            bc, bf, vq = newton_rhs(v, pulled[..., 1:],
                                    lam2 - mu_target * e_soc if has_soc else None)
        dth, duf, dX, dle = solve_K(bc, bf, c2_of(r_c))
        ds, dlam, dsq, dzq = recover_steps(dth, duf, dX, v, vq, dle)
        ap, ad = step_len(ds, dlam, dsq, dzq)

        th_n = ahead(theta, ap, dth)
        uf_n = ahead(uf, ap, duf)
        s_n = torch.where(mask, ahead(s, ap, ds), 1.0)
        lam_n = torch.where(mask, ahead(lam, ad, dlam), 0.0)
        if has_soc:
            sq_n = torch.where(rmask[..., None], ahead(sq, ap, dsq), e_soc)
            zq_n = torch.where(rmask[..., None], ahead(zq, ad, dzq), e_soc)
        else:
            sq_n, zq_n = sq, zq
        mu_n = mu_of(s_n, lam_n, sq_n, zq_n)

        rp_inf = split_max(r_p.abs(), n_c)
        if has_soc:
            rp_inf = torch.maximum(rp_inf, split_max(r_pq.abs().amax(-1), Nc))
        # full consensus (Nc = N) leaves the free block zero-sized
        gd_inf = split_max(torch.cat([gc, gf.reshape(Bn, -1)], -1).abs(), nct)
        step_bad = pmax(~(torch.isfinite(mu_n) & torch.isfinite(th_n.sum(-1))
                          & torch.isfinite(uf_n.sum((-2, -1)))))
        if has_soc:
            # a missed boundary crossing leaves a cone point OUTSIDE its
            # cone: an escape is a breakdown
            step_bad = step_bad | (soc_viol(sq_n) > 0) | (soc_viol(zq_n) > 0)
        mu_ok = mu_n < mu_ok_floor
        if mu_target > 0:
            # the products must also be CENTERED at mu_target (that is what
            # makes the point the logbarrier solution)
            center_err = split_max(torch.where(mask, (s_n * lam_n - mu_target).abs(), 0.0),
                                   n_c)
            if has_soc:
                center_err = torch.maximum(center_err, split_max(rmaskf * (
                    (sq_n * zq_n).sum(-1) - mu_target).abs(), Nc))
            mu_ok = mu_ok & (center_err < 0.002 * mu_target + tol)
        # with cones the dual accuracy is cancellation-limited by the NT
        # scaling near the boundary, with extra rows by the bordered solve's
        # accuracy at row weights ~1/mu: ~sqrt(tol) either way
        gd_tol = sqrt_tol if (has_soc or has_ex) else 1e3 * tol
        now_done = mu_ok & (rp_inf < sqrt_tol) & (gd_inf < gd_tol)
        now_bad = step_bad | (mu_n > 1e12)

        frozen = done | now_bad
        new = RIPMState(th_n, uf_n, s_n, lam_n, sq_n, zq_n, mu_n, false, ok, it_count,
                        badc, failed)
        merged = RIPMState(*(lane_where(frozen, o, n) for n, o in zip(new, st)))
        if not has_soc:
            return merged._replace(done=done | now_done | now_bad, ok=ok | now_done,
                                   iters=it_count + 1,
                                   failed=failed | (now_bad & ~done & ~now_done))
        # convergence also needs the NEW primal point to be cone-feasible
        now_done = now_done & (soc_viol(cone_vals(th_n, uf_n)) < sqrt_tol)
        # the retry: keep the iterate on a bad step, count the breakdown (the
        # next factor gets the boost) and shift the cone points inward (a
        # crashed cone's scaling overflows: regularization alone cannot fix
        # the iterate); the fourth breakdown in a row gives up
        badc_n = torch.where(done, badc, torch.where(now_bad, badc + 1, 0)).to(badc.dtype)
        give_up = badc_n >= 4
        retry = now_bad & ~done
        return merged._replace(
            sq=lane_where(retry, _soc_shift(merged.sq), merged.sq),
            zq=lane_where(retry, _soc_shift(merged.zq), merged.zq),
            done=done | now_done | give_up, ok=ok | now_done, iters=it_count + 1,
            badc=badc_n, failed=failed | (give_up & ~done & ~now_done))

    # the loop of `jax.vmap(lax.while_loop)`: runs while ANY lane's condition
    # holds; lanes whose own condition is false keep their state. One host
    # sync an iteration
    while True:
        active = ~state.done & (state.iters < iters)
        if not pany(active):
            break
        new = body(state)
        state = RIPMState(*(lane_where(active, n, o) for n, o in zip(new, state)))
    if mu_target > 0:
        # finish with pure centering steps: Mehrotra's second-order
        # correction hunts mu -> 0 and wobbles around the mu_target point.
        # Every lane counts these 10 steps, as the JAX core's fori_loop does
        ok_main = state.ok
        state = state._replace(done=state.done & ~state.ok, ok=false)
        for _ in range(10):
            state = body(state, mehrotra=False)
        state = state._replace(failed=state.failed & ~ok_main, ok=state.ok | ok_main)

    stats = dict(mu=state.mu, iters=state.iters, converged=state.ok,
                 failed=state.failed & ~state.ok, s=state.s, lam=state.lam,
                 sq=state.sq, zq=state.zq)
    return state.theta, state.uf, stats


def recover_XU_stage(theta, uf, x0, c, A, B, Nc: int, maskc=None):
    """Trajectories from an IPM point: stitch stage controls, roll out the
    (linearized) dynamics. theta (B, nct), uf (B, M, nfu), stage data
    (B, M, ...). Returns (X (B, M, N, xdim), U (B, M, N, udim))."""
    udim = B.shape[-1]
    if maskc is None:
        maskc = torch.ones(theta.shape[-1], dtype=c.dtype, device=c.device)
    U = _stage_U(theta, uf, Nc, udim, maskc)
    X = _rollout_flat(_flat(x0, 1)[..., None], _flat(c, 2)[..., None], _flat(A, 3),
                      _flat(B, 3), _flat(U, 2)[..., None])
    return X[..., 0].reshape(c.shape), U


def riccati_ipm_solve_np(base_args, reg_args, u_l, u_u, Nc: int,
                         settings: Optional[Dict[str, Any]] = None, x_l=None, x_u=None,
                         u_soc_r=None, ex_G=None, ex_h=None,
                         device=None) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """The numpy frontend of the stage-structured IPM (the host-path twin of
    `ipm.ipm_solve_np`): one subproblem, numpy (X (M, N, xdim), U (M, N,
    udim), data).

    ``base_args``/``reg_args`` as `ipm.ipm_solve_np` takes them, the control
    bounds (M, N, udim) both given (the dispatcher fills an absent side with
    +-inf), state boxes x_l/x_u (one side may be None), ``u_soc_r`` (M, N),
    ``ex_G (l, n_full)`` / ``ex_h (l,)`` linear rows over the full consensus
    layout. The host path's defaults of ``ipm_iters``, ``ipm_tol_exp``,
    ``ipm_kappa`` and the SCP-residual forcing are `ipm.ipm_solve_np`'s.
    The warm start ``settings["solver_state"]["riccati_warm"]`` (theta
    (nct,), uf (M, nfu), s, lam (mtot,)[, sq, zq (nq, udim + 1)]) stays on
    the device between SCP iterations (a numpy or JAX tuple of the same
    layout is taken as well); X, U and the four scalars come back in ONE
    transfer. ``data``: solver_state (``riccati_warm``), ipm_mu, ipm_iters,
    ipm_converged, ipm_failed."""
    settings = settings or {}
    dev = default_device() if device is None else torch.device(device)
    f = np.asarray(base_args[1])
    M, N, xdim = f.shape
    udim = np.asarray(base_args[3]).shape[-1]
    dtype = f.dtype
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    T = lambda a: torch.as_tensor(np.array(a, dtype=dtype), device=dev)[None]
    nc = Nc * udim
    nct = max(nc, 1)
    nfu = (N - Nc) * udim
    has_x = x_l is not None or x_u is not None
    has_ex = ex_G is not None
    l_ex = int(np.shape(ex_G)[0]) if has_ex else 0
    mtot = 2 * nct + 2 * M * nfu + (2 * M * N * xdim if has_x else 0) + l_ex
    has_soc = u_soc_r is not None
    nq = (Nc + M * (N - Nc)) if has_soc else 0

    warm = None
    prev_state = settings.get("solver_state") or {}
    cand = prev_state.get("riccati_warm") if isinstance(prev_state, dict) else None
    if cand is not None and len(cand) >= 4:
        th_w, uf_w, s_w, lam_w = cand[:4]
        shapes_ok = (tuple(np.shape(th_w)) == (nct,) and tuple(np.shape(uf_w)) == (M, nfu)
                     and tuple(np.shape(s_w)) == (mtot,)
                     and tuple(np.shape(lam_w)) == (mtot,))
        if has_soc:
            shapes_ok = shapes_ok and len(cand) >= 6 \
                and tuple(np.shape(cand[4])) == (nq, udim + 1)
        if shapes_ok:
            # the port's own tuple stays on the device across SCP iterations
            warm = tuple(
                z[None] if isinstance(z, torch.Tensor) and z.dtype == tdt and z.device == dev
                else T(z) for z in cand)

    iters = int(settings.get("ipm_iters", 30))
    tol_exp = int(settings.get("ipm_tol_exp", -8 if dtype == np.float64 else -5))
    kappa = float(settings.get("ipm_kappa", 0.0 if dtype == np.float64 else 1e-7))

    # inexact-Newton forcing from the SCP residual (ipm_solve_np's rule)
    tol_dyn = None
    r_scp = settings.get("scp_residual")
    adaptive_dflt = "ipm_tol_exp" not in settings
    if r_scp is not None and np.isfinite(r_scp) \
            and settings.get("ipm_adaptive_tol", adaptive_dflt):
        r = min(float(r_scp), 1e3)
        tol_dyn = torch.full((1,), min(1e-3 * r * r, 1e-3), dtype=tdt, device=dev)

    kw = {}
    # slew coupling present: route through the augmented stage state
    if any(np.any(np.asarray(a) != 0) for a in reg_args[2:4]):
        kw.update(slew_reg=T(reg_args[2]), slew_reg0=T(reg_args[3]), slew_um1=T(reg_args[4]))
    if has_x:
        # one-sided state boxes: the absent side at +-inf (the core masks it)
        kw.update(x_l=T(x_l if x_l is not None else np.full((M, N, xdim), -np.inf)),
                  x_u=T(x_u if x_u is not None else np.full((M, N, xdim), np.inf)))
    if has_soc:
        kw["u_soc_r"] = T(np.broadcast_to(np.asarray(u_soc_r, dtype=dtype), (M, N)))
    if float(settings.get("mu_target", 0.0) or 0.0) > 0.0:
        kw["mu_target"] = float(settings["mu_target"])
    if has_ex:
        kw.update(ex_G=T(ex_G), ex_h=T(ex_h))
    X, U, stats = riccati_ipm_solve_scp(
        *(T(a) for a in base_args), T(reg_args[0]), T(reg_args[1]), T(u_l), T(u_u),
        Nc=Nc, iters=iters, tol_exp=tol_exp, kappa=kappa, warm=warm, tol_dynamic=tol_dyn,
        tau=float(settings["ipm_tau"]) if settings.get("ipm_tau") is not None else None,
        **kw)
    # ONE packed device->host transfer; the warm tuple stays on the device
    X_h, U_h, mu_h, it_h, conv_h, fail_h = (a[0] for a in to_host(
        [X, U, stats["mu"], stats["iters"], stats["converged"], stats["failed"]]))
    names = ("theta", "uf", "s", "lam") + (("sq", "zq") if has_soc else ())
    data = dict(
        solver_state=dict(riccati_warm=tuple(stats[k][0] for k in names)),
        ipm_mu=float(mu_h),
        ipm_iters=int(it_h),
        ipm_converged=bool(conv_h > 0),
        ipm_failed=bool(fail_h > 0),
    )
    return X_h, U_h, data


def riccati_ipm_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                          reg_x, reg_u, u_l, u_u, Nc: int,
                          slew_reg=None, slew_reg0=None, slew_um1=None,
                          x_l=None, x_u=None, u_soc_r=None,
                          ex_G=None, ex_h=None, **kw):
    """One SCP subproblem per lane via the stage-structured IPM.

    Arrays (B, M, ...); bounds (B, M, N, udim) with the consensus stages
    taking particle 0's rows. Slew coupling (optional, (B, M) / (B, M, udim)
    tensors) enters via `riccati.augment_slew_stages`; the bounds and the
    IPM layout are in control space and unchanged. State boxes x_l/x_u
    (B, M, N, xdim) apply to the ORIGINAL state entries (the augmentation's
    control-memory tail is unbounded). ``u_soc_r`` (B, M, N): per-stage
    control-norm radii (+inf: no cone; the consensus stages take particle
    0's). ``ex_G`` (B, l, n_full) / ``ex_h`` (B, l): linear rows g'z <= h
    over the full consensus layout [u_cons; u_free_1..M; x_1..M] (the
    original states: the slew augmentation's tail is not a variable).
    Returns (X, U, stats), stats with theta and uf beside the core's."""
    Bn, M, N = f.shape[:3]
    xdim, udim = x0.shape[-1], U_prev.shape[-1]
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev, Q, R,
                                         X_ref, U_ref, reg_x, reg_u)
    A, B, x0s = fx, fu, x0
    if slew_reg is not None:
        x0s, c, A, B, Qt, xt = augment_slew_stages(
            x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1)
    nc = Nc * udim
    ul, uu = u_l.reshape(Bn, M, N * udim), u_u.reshape(Bn, M, N * udim)
    if nc:  # particle 0's rows (the particle group's first rank's)
        lo_c, hi_c = pfirst(ul[:, 0, :nc]), pfirst(uu[:, 0, :nc])
    else:
        lo_c = torch.full((Bn, 1), -torch.inf, dtype=f.dtype, device=f.device)
        hi_c = -lo_c
    if u_soc_r is not None:
        r = u_soc_r.expand(Bn, M, N)
        kw = dict(kw, soc_rc=pfirst(r[:, 0, :Nc]), soc_rf=r[:, :, Nc:])
    if ex_h is not None:
        # split the rows into the core's (theta, u_free, state) blocks
        l, nfu = ex_h.shape[-1], (N - Nc) * udim
        ex_Gc = torch.nn.functional.pad(ex_G[..., :nc], (0, max(nc, 1) - nc))
        kw = dict(kw, ex_Gc=ex_Gc, ex_Gf=ex_G[..., nc:nc + M * nfu].reshape(Bn, l, M, nfu),
                  ex_Gx=ex_G[..., nc + M * nfu:].reshape(Bn, l, M, N, xdim), ex_h=ex_h)
    theta, uf, stats = riccati_ipm_core(
        x0s, c, A, B, Qt, xt, Rt, ut, lo_c, hi_c, ul[:, :, nc:], uu[:, :, nc:],
        Nc=Nc, x_lo=x_l, x_hi=x_u, **kw)
    maskc = _selectors(N, Nc, udim, f.dtype, f.device)[3]
    X, U = recover_XU_stage(theta, uf, x0s, c, A, B, Nc, maskc)
    return X[..., :xdim], U, dict(stats, theta=theta, uf=uf)
