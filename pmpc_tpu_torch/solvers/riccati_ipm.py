"""Stage-structured (Riccati) box-constrained IPM: the O(N) long-horizon path.

Twin of ``pmpc_tpu/solvers/riccati_ipm.py``, box path: control boxes, state
boxes (also under the slew augmentation, where the box sees only the first
``nxb`` entries of the stage state), warm start, ``tol_dynamic``, ``tau``,
``kappa``. SOC cones, linear extra rows and ``mu_target > 0`` raise.

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
  per-particle theta-quadratics.

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
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.linalg import cholesky_factor, cholesky_solve
from ..utils import full_matmul_precision, lane_where
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
    mu: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) bool
    ok: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32
    failed: torch.Tensor  # (B,) bool: froze on a bad (non-finite or diverged)
    #                       step without converging


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"riccati_ipm: {what} is not ported yet ({item})")


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
    ``utf`` (nb, N - Nc, udim, 1) applies to the eliminated (free) stage
    controls, ``utc`` (nb, N, udim, 1) to the consensus-stage controls
    (routed onto the theta block); ``c`` is the dynamics offset. None stands
    for zeros, as in every Newton solve. Returns (p0 (nb, na, 1),
    k (nb, N, udim, 1), zero on the consensus stages)."""
    nb, N, xdim, udim = B.shape
    p = Aa.new_zeros((nb, Aa.shape[-1], 1))
    ks = [Aa.new_zeros((nb, udim, 1))] * N
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
    """Forward rollout given theta (nb, nct, 1) and the stage gains: X
    (nb, N, xdim, 1), U (nb, N, udim, 1). ``x0``/``c`` None: zeros."""
    nb, N, xdim, udim = B.shape
    kk = k + K[..., xdim:] @ theta[:, None]  # the gains' theta part, every stage
    x = A.new_zeros((nb, xdim, 1)) if x0 is None else x0
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


def _pull(gU, Bn: int, M: int, Nc: int, nct: int):
    """Stage-control gradients (B*M, N, udim, 1) -> (theta part (B, nct),
    summed over the particles; free part (B, M, nfu))."""
    N, udim = gU.shape[1:3]
    g = gU.reshape(Bn, M, N, udim)
    gth = g.new_zeros((Bn, nct))
    if Nc:
        gth[:, :Nc * udim] = g[:, :, :Nc].sum(1).reshape(Bn, Nc * udim)
    return gth, g[:, :, Nc:].reshape(Bn, M, (N - Nc) * udim)


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


def _schur_factor(P0, wc, maskc, xdim: int, kappa: float):
    """Factor of the consensus system: the particles' theta-quadratics summed
    (P0 (B, M, na, na)), the consensus box weights wc (B, nct) on the
    diagonal, dead theta entries pinned to 0 by identity rows."""
    nct = maskc.shape[0]
    eye = torch.eye(nct, dtype=P0.dtype, device=P0.device)
    S_tot = P0[..., xdim:, xdim:].sum(dim=-3) * (maskc[:, None] * maskc[None, :]) \
        + torch.diag_embed(wc * maskc) + (1.0 - maskc) * eye + kappa * eye
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
    rhs = (theta_lin - s.sum(dim=-2)) * maskc
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
    """Mehrotra box IPM over (theta, u_free) with Riccati-sweep Newton solves.

    Args:
        x0 (B, M, xdim); c/A/B/Qt/xt/Rt/ut: per-particle stage data
            (B, M, N, ...) in the `riccati.py` cost convention.
        lo_c/hi_c (B, nct): consensus control bounds (+-inf when absent;
            particle 0's rows).
        lo_f/hi_f (B, M, nfu): free control bounds, nfu = (N - Nc) * udim.
        warm: (theta (B, nct), uf (B, M, nfu), s (B, mtot), lam (B, mtot))
            from a previous nearby solve.
        tol_dynamic (B,): overrides the static ``10**tol_exp`` where larger.
        x_lo/x_hi (B, M, N, nxb): STATE box bounds on the rolled-out states
            x_1..x_N (+-inf rows inactive). ``nxb`` may be smaller than the
            stage state dim (the slew augmentation appends control memory the
            box must not see).
        scan_unroll: taken for signature parity, without effect (it tunes
            the JAX package's scans).
        soc_rc/soc_rf, ex_G*/ex_h, mu_target > 0: not ported, they raise.

    Returns (theta (B, nct), uf (B, M, nfu), stats): mu, iters, converged,
    failed (each (B,)), s, lam. Recover trajectories with `recover_XU_stage`.
    """
    if soc_rc is not None or soc_rf is not None:
        _unsupported("per-stage control-norm cones (soc_rc, soc_rf)",
                     "ROADMAP §1.7, after §1.4's SOC slice")
    if any(a is not None for a in (ex_Gc, ex_Gf, ex_Gx, ex_h)):
        _unsupported("linear extra rows (ex_*)", "ROADMAP §1.7, with the host dispatcher §1.9")
    if mu_target > 0:
        _unsupported("mu_target > 0 (centering phase)", "ROADMAP §1.7")

    Bn, M, N, xdim = c.shape
    udim = B.shape[-1]
    dtype, dev = c.dtype, c.device
    nb = Bn * M
    _, _, nct, maskc = _selectors(N, Nc, udim, dtype, dev)
    Nf = N - Nc
    nfu = Nf * udim
    has_x = x_lo is not None
    nxb = x_lo.shape[-1] if has_x else 0
    mx = M * N * nxb
    o_chi, o_flo, o_fhi = nct, 2 * nct, 2 * nct + M * nfu
    o_xlo = 2 * nct + 2 * M * nfu
    o_xhi = o_xlo + mx

    tol = torch.full((Bn,), 10.0 ** tol_exp, dtype=dtype, device=dev)
    if tol_dynamic is not None:
        tol = torch.maximum(tol_dynamic.to(dtype), tol)
    sqrt_tol = torch.sqrt(tol)
    tau = 0.99 if tau is None else tau

    bound_blocks = [lo_c, hi_c, lo_f.reshape(Bn, -1), hi_f.reshape(Bn, -1)]
    if has_x:
        bound_blocks += [x_lo.reshape(Bn, -1), x_hi.reshape(Bn, -1)]
    mask = torch.isfinite(torch.cat(bound_blocks, -1))
    mask[:, :2 * nct] &= (maskc > 0).repeat(2)
    n_act = torch.clamp(mask.sum(-1).to(dtype), min=1.0)

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

    def boxed(X):
        """The entries of the states that the box sees, (B, M*N*nxb)."""
        return X[:, :, :nxb, 0].reshape(Bn, mx)

    def slack_vals(theta, uf, X):
        vals = [theta - lo_c, hi_c - theta,
                (uf - lo_f).reshape(Bn, -1), (hi_f - uf).reshape(Bn, -1)]
        if has_x:
            Xb = boxed(X)
            vals += [Xb - x_lo.reshape(Bn, mx), x_hi.reshape(Bn, mx) - Xb]
        return torch.cat(vals, -1)

    def x_rows(v):
        """State-row multipliers of a flat vector as adjoint sources
        (nb, N, xdim, 1), zero past the boxed entries."""
        vx = (v[:, o_xhi:] - v[:, o_xlo:o_xhi]).reshape(nb, N, nxb, 1)
        return torch.nn.functional.pad(vx, (0, 0, 0, xdim - nxb)) if nxb < xdim else vx

    def u_rows(v):
        """(G' v) of the control-box rows."""
        return (v[:, o_chi:o_flo] - v[:, :nct],
                (v[:, o_fhi:o_xlo] - v[:, o_flo:o_fhi]).reshape(Bn, M, nfu))

    def mu_of(s_, lam_):
        return torch.where(mask, s_ * lam_, 0.0).sum(-1) / n_act

    def newton_factor(wc, wf, wx):
        """Factor H + diag(w): free-stage box weights onto Rt_j, consensus
        box weights onto the theta Schur complement, state-box weights onto
        the first nxb diagonal entries of Qt_j (the recursion propagates
        them through the dynamics chain)."""
        Rk = Rk0.clone()
        Rk[:, Nc:].diagonal(dim1=-2, dim2=-1).add_(wf.reshape(nb, Nf, udim))
        Qa = Qa0
        if has_x:
            Qa = Qa0.clone()
            Qa.diagonal(dim1=-2, dim2=-1)[..., :nxb].add_(wx.reshape(nb, N, nxb))
        Mn, L, K, Huy, P0 = _factor(W, Qa, Rk, Nc)
        LS = _schur_factor(P0.reshape(Bn, M, xdim + nct, xdim + nct), wc, maskc,
                           xdim, kappa)

        def solve(bc, bf):
            """(dtheta, duf, the states' direction) for one right-hand side."""
            p0, k = _lin_backward_flat(Aa, Mn, L, Huy, Bf, bf.reshape(nb, Nf, udim, 1), Nc)
            s = p0[:, xdim:, 0].reshape(Bn, M, nct).sum(1)
            th = cholesky_solve(LS, (bc - s) * maskc)
            th_p = th[:, None, :].expand(Bn, M, nct).reshape(nb, nct, 1)
            dX, dU = _forward_flat(Af, Bf, K, k, th_p, Nc)
            return th, dU[:, Nc:, :, 0].reshape(Bn, M, nfu), dX

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
    false = torch.zeros(Bn, dtype=torch.bool, device=dev)
    state = RIPMState(th0, uf0, s0, lam0, mu_of(s0, lam0), false, false,
                      torch.zeros(Bn, dtype=torch.int32, device=dev), false)

    w_max = 1e14 if dtype == torch.float64 else 1e7

    def body(st: RIPMState) -> RIPMState:
        theta, uf, s, lam, mu, done, ok, it_count, failed = st
        U, X = rollout(theta, uf)
        r_p = torch.where(mask, s - slack_vals(theta, uf, X), 0.0)
        # the predictor's complementarity target is s*lam
        v_aff = torch.where(mask, (lam * r_p - s * lam) / s, 0.0)
        # gradient of the Lagrangian in factored form: the objective's
        # adjoint sources Qt x - xt and the state rows' multipliers share one
        # sweep; the predictor's state-row pull is its second column
        V = Qtf @ X - xtf
        if has_x:
            V = torch.cat([V + x_rows(lam), x_rows(v_aff)], dim=-1)
        pulled = _adjoint_flat(Af, Bf, V)
        gth, gfu = _pull(Rtf @ U - utf_ + pulled[..., :1], Bn, M, Nc, nct)
        dc, df = u_rows(lam)
        gc, gf = (gth + dc) * maskc, gfu + df

        w = torch.where(mask, torch.clamp(lam / s, max=w_max), 0.0)
        solve = newton_factor(
            w[:, :nct] + w[:, o_chi:o_flo],
            (w[:, o_flo:o_fhi] + w[:, o_fhi:o_xlo]).reshape(Bn, M, nfu),
            w[:, o_xlo:o_xhi] + w[:, o_xhi:] if has_x else None)

        def newton_rhs(v, x_pull):
            """-(grad + G'v); ``x_pull`` is the adjoint of v's state rows."""
            dc, df = u_rows(v)
            if has_x:
                xc, xf = _pull(x_pull, Bn, M, Nc, nct)
                dc, df = dc + xc * maskc, df + xf
            return -(gc + dc) * maskc, -(gf + df)

        def recover_steps(dth, duf, dX, v):
            parts = [-dth, dth, -duf.reshape(Bn, -1), duf.reshape(Bn, -1)]
            if has_x:
                dXb = boxed(dX)
                parts += [-dXb, dXb]
            gdz = torch.cat(parts, -1)
            ds = torch.where(mask, -r_p - gdz, 0.0)
            dlam = torch.where(mask, w * gdz + v, 0.0)
            return ds, dlam

        def step_len(s_, ds, lam_, dlam):
            # torch.where evaluates both branches: the inner guards keep the
            # unused branch finite
            rp_ = torch.where(mask & (ds < 0),
                              -s_ / torch.where(ds < 0, ds, -1.0), torch.inf)
            rd_ = torch.where(mask & (dlam < 0),
                              -lam_ / torch.where(dlam < 0, dlam, -1.0), torch.inf)
            mins = torch.stack([rp_, rd_], 1).amin(-1)  # (B, 2)
            return (torch.clamp(tau * mins[:, 0], max=1.0),
                    torch.clamp(tau * mins[:, 1], max=1.0))

        # predictor (affine)
        bc, bf = newton_rhs(v_aff, pulled[..., 1:])
        dth_a, duf_a, dX_a = solve(bc, bf)
        ds_a, dlam_a = recover_steps(dth_a, duf_a, dX_a, v_aff)
        ap_a, ad_a = step_len(s, ds_a, lam, dlam_a)
        mu_aff = mu_of(s + ap_a[:, None] * ds_a, lam + ad_a[:, None] * dlam_a)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
        sig_mu = torch.clamp(sigma * mu, min=0.0)
        # corrector (same factorization)
        r_c = torch.where(mask, s * lam + ds_a * dlam_a - sig_mu[:, None], 0.0)
        v = torch.where(mask, (lam * r_p - r_c) / s, 0.0)
        bc, bf = newton_rhs(v, _adjoint_flat(Af, Bf, x_rows(v)) if has_x else None)
        dth, duf, dX = solve(bc, bf)
        ds, dlam = recover_steps(dth, duf, dX, v)
        ap, ad = step_len(s, ds, lam, dlam)

        th_n = theta + ap[:, None] * dth
        uf_n = uf + ap[:, None, None] * duf
        s_n = torch.where(mask, s + ap[:, None] * ds, 1.0)
        lam_n = torch.where(mask, lam + ad[:, None] * dlam, 0.0)
        mu_n = mu_of(s_n, lam_n)

        rp_inf = r_p.abs().amax(-1)
        # full consensus (Nc = N) leaves the free block zero-sized
        gd_inf = torch.cat([gc, gf.reshape(Bn, -1)], -1).abs().amax(-1)
        step_bad = ~(torch.isfinite(mu_n) & torch.isfinite(th_n.sum(-1))
                     & torch.isfinite(uf_n.sum((-2, -1))))
        now_done = (mu_n < tol) & (rp_inf < sqrt_tol) & (gd_inf < 1e3 * tol)
        now_bad = step_bad | (mu_n > 1e12)

        frozen = done | now_bad
        new = RIPMState(th_n, uf_n, s_n, lam_n, mu_n, false, ok, it_count, failed)
        merged = RIPMState(*(lane_where(frozen, o, n) for n, o in zip(new, st)))
        return merged._replace(done=done | now_done | now_bad, ok=ok | now_done,
                               iters=it_count + 1,
                               failed=failed | (now_bad & ~done & ~now_done))

    # the loop of `jax.vmap(lax.while_loop)`: runs while ANY lane's condition
    # holds; lanes whose own condition is false keep their state. One host
    # sync an iteration
    while True:
        active = ~state.done & (state.iters < iters)
        if not bool(active.any()):
            break
        new = body(state)
        state = RIPMState(*(lane_where(active, n, o) for n, o in zip(new, state)))

    stats = dict(mu=state.mu, iters=state.iters, converged=state.ok,
                 failed=state.failed & ~state.ok, s=state.s, lam=state.lam)
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


def riccati_ipm_solve_np(*args, **kwargs):
    """The numpy frontend of the stage-structured IPM (it threads
    ``settings["solver_state"]["riccati_warm"]`` across the host SCP loop)
    belongs to the host dispatcher, which is not ported."""
    _unsupported("riccati_ipm_solve_np", "ROADMAP §1.9, the host frontend")


def riccati_ipm_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                          reg_x, reg_u, u_l, u_u, Nc: int,
                          slew_reg=None, slew_reg0=None, slew_um1=None,
                          x_l=None, x_u=None, u_soc_r=None,
                          ex_G=None, ex_h=None, **kw):
    """One box-constrained SCP subproblem per lane via the stage-structured
    IPM.

    Arrays (B, M, ...); bounds (B, M, N, udim) with the consensus stages
    taking particle 0's rows. Slew coupling (optional, (B, M) / (B, M, udim)
    tensors) enters via `riccati.augment_slew_stages`; the bounds and the
    IPM layout are in control space and unchanged. State boxes x_l/x_u
    (B, M, N, xdim) apply to the ORIGINAL state entries (the augmentation's
    control-memory tail is unbounded). Returns (X, U, stats), stats with
    theta and uf beside the core's."""
    if u_soc_r is not None:
        _unsupported("per-stage control-norm cones (u_soc_r)",
                     "ROADMAP §1.7, after §1.4's SOC slice")
    if ex_G is not None or ex_h is not None:
        _unsupported("linear extra rows (ex_G, ex_h)",
                     "ROADMAP §1.7, with the host dispatcher §1.9")
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
    if nc:
        lo_c, hi_c = ul[:, 0, :nc], uu[:, 0, :nc]
    else:
        lo_c = torch.full((Bn, 1), -torch.inf, dtype=f.dtype, device=f.device)
        hi_c = -lo_c
    theta, uf, stats = riccati_ipm_core(
        x0s, c, A, B, Qt, xt, Rt, ut, lo_c, hi_c, ul[:, :, nc:], uu[:, :, nc:],
        Nc=Nc, x_lo=x_l, x_hi=x_u, **kw)
    maskc = _selectors(N, Nc, udim, f.dtype, f.device)[3]
    X, U = recover_XU_stage(theta, uf, x0s, c, A, B, Nc, maskc)
    return X[..., :xdim], U, dict(stats, theta=theta, uf=uf)
