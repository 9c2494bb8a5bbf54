"""Central-path barrier solver for dense cone QPs with exponential cones.

Twin of ``pmpc_tpu/solvers/expbarrier.py``. The NT-scaled IPM of `coneipm`
is for symmetric cones only; exponential cones (user ``extra_cstrs`` with
``e`` > 0 triples, and the encoding ``PMPC.jl/src/cone_utils.jl:173-202``
generates for logbarrier smoothing) are not. This is the textbook barrier
method:

  phase I   relax every cone by ``t * shift`` (1 on nonnegative rows, e on
            SOCs, (-1, 1, 1) on exp cones: recession directions), damped
            Newton on the objective ``t`` until the unrelaxed margins are
            positive;
  phase II  damped Newton on F_mu(v) = (0.5 v'Pv + q'v) / mu + barriers,
            with backtracking that keeps the iterate strictly feasible, mu
            shrinking by 5 to 10^tol_exp.

Barriers: -log(s) per nonnegative row; -log(s0^2 - |s1|^2) per SOC (zero
padding is neutral); -log(z log(y/z) - x) - log y - log z per exp cone
(ECOS convention s = (x, y, z), z log(y/z) >= x, y, z > 0). The JAX package
takes each cone's gradient and Hessian by ``jax.grad`` / ``jax.hessian`` of
the 3-vector barrier; here they are closed forms (`_soc_grad_hess`,
`_exp_grad_hess`) with the same clamps: where a clamp at 1e-300 is active,
the gradient through it is 0 and the cone's Hessian NaN, as autodiff gives
them (its 1 / 1e-300^2 overflows). The Newton matrix is
dense (nv, nv) and factors through `ops.linalg.spd_factor` (on a CUDA tensor
the hand kernel K2 for nv <= 64, K4 for nv <= 96; the library above).

Every function works over an explicit leading batch axis B. The JAX solver
runs one program under ``jax.vmap``; a lane whose loop condition has turned
false keeps its whole state here as it does there, so every lane follows its
own serial path (its Newton counts and its ``converged`` are the JAX lane's).
The backtracking line search takes the largest 0.5^k (k < 40) with F < F0:
one batched evaluation of the whole ladder picks the first k that passes,
which is the JAX loop's choice. The host reads "are all lanes done" once
every `CHECK_EVERY` Newton steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import spd_apply, spd_factor
from ..utils import full_matmul_precision
from .coneipm import CHECK_EVERY

_BIG = 1e30
_TINY = 1e-300
N_LADDER = 40  # 0.5^k for k < 40: the JAX loop stops once alpha <= 1e-12


def _clamp_tiny(a: torch.Tensor):
    """(max(a, 1e-300), 1 where the clamp is inactive else 0): the value and
    the derivative of ``jnp.maximum(a, 1e-300)``."""
    return torch.clamp(a, min=_TINY), (a > _TINY).to(a.dtype)


def _soc_barrier(s: torch.Tensor) -> torch.Tensor:
    """-log(s0^2 - |s1|^2) of cone points (..., p)."""
    det = s[..., 0] ** 2 - (s[..., 1:] ** 2).sum(-1)
    return -torch.log(torch.clamp(det, min=_TINY))


def _soc_margin(s: torch.Tensor) -> torch.Tensor:
    return s[..., 0] - torch.linalg.vector_norm(s[..., 1:], dim=-1)


def _exp_barrier(s: torch.Tensor) -> torch.Tensor:
    """-log(z log(y/z) - x) - log y - log z of exp-cone points (..., 3)."""
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    yc, zc = torch.clamp(y, min=_TINY), torch.clamp(z, min=_TINY)
    u = z * torch.log(yc / zc) - x
    return -torch.log(torch.clamp(u, min=_TINY)) - torch.log(yc) - torch.log(zc)


def _exp_margin(s: torch.Tensor) -> torch.Tensor:
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    ok = (y > 0) & (z > 0)
    u = torch.where(ok, z * torch.log(torch.clamp(y, min=_TINY) / torch.clamp(z, min=_TINY))
                    - x, -1.0)
    return torch.minimum(torch.minimum(y, z), u)


def _soc_grad_hess(s: torch.Tensor):
    """Gradient (..., p) and Hessian (..., p, p) of `_soc_barrier`: with
    d = det(s) and Js = (s0, -s1), grad = -2 Js / d and Hess = 4 (Js)(Js)'/d^2
    - 2 J / d; where the clamp is active, grad 0 and Hess NaN."""
    p = s.shape[-1]
    J = torch.full((p,), -1.0, dtype=s.dtype, device=s.device)
    J[0] = 1.0
    dc, on = _clamp_tiny(s[..., 0] ** 2 - (s[..., 1:] ** 2).sum(-1))
    Js = J * s
    r = (on / dc)[..., None]
    g = -2.0 * r * Js
    H = 4.0 * (r * r)[..., None] * Js[..., :, None] * Js[..., None, :] \
        - 2.0 * r[..., None] * torch.diag(J)
    return g, torch.where(on[..., None, None] > 0, H, torch.nan)


def _exp_grad_hess(s: torch.Tensor):
    """Gradient (..., 3) and Hessian (..., 3, 3) of `_exp_barrier` in closed
    form. With u = z log(y/z) - x: grad u = (-1, z/y, log(y/z) - 1), the
    nonzero second derivatives u_yy = -z/y^2, u_yz = 1/y, u_zz = -1/z, and
    f = -log u - log y - log z gives grad f = -grad u / u - (0, 1/y, 1/z),
    Hess f = grad u grad u' / u^2 - Hess u / u + diag(0, 1/y^2, 1/z^2). Each
    1e-300 clamp is carried through with its derivative (0 while active);
    a cone with an active clamp has a NaN Hessian."""
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    yc, iy = _clamp_tiny(y)
    zc, iz = _clamp_tiny(z)
    L = torch.log(yc / zc)
    uc, iu = _clamp_tiny(z * L - x)
    u_y, u_z = z * iy / yc, L - z * iz / zc
    gu = torch.stack([-torch.ones_like(x), u_y, u_z], -1)
    w = iu / uc
    zero = torch.zeros_like(x)
    g = -w[..., None] * gu - torch.stack([zero, iy / yc, iz / zc], -1)
    u_yy = -z * iy / (yc * yc)
    u_yz = iy * iz / yc
    u_zz = iz * (z / (zc * zc) - 2.0 / zc)
    Hu = torch.stack([torch.stack([zero, zero, zero], -1),
                      torch.stack([zero, u_yy, u_yz], -1),
                      torch.stack([zero, u_yz, u_zz], -1)], -2)
    H = (w * w)[..., None, None] * gu[..., :, None] * gu[..., None, :] \
        - w[..., None, None] * Hu \
        + torch.diag_embed(torch.stack([zero, iy / (yc * yc), iz / (zc * zc)], -1))
    return g, torch.where((iy * iz * iu > 0)[..., None, None], H, torch.nan)


def _slacks(V, Gl, hl, Gq, hq, Ge, he, T, shift_on: float):
    """Cone slacks of the points V (B, K, nv) with the phase-I relaxation
    T * shift (T (B, K), shift_on 1) or without it (shift_on 0):
    sl (B, K, ml), sq (B, K, c, p), se (B, K, e, 3)."""
    B, K, nv = V.shape
    de = V.new_tensor([-1.0, 1.0, 1.0])
    sl = hl[:, None] - V @ Gl.mT + shift_on * T[..., None]
    c, p = Gq.shape[1:3]
    sq = hq[:, None] - (V @ Gq.reshape(B, c * p, nv).mT).reshape(B, K, c, p)
    sq = torch.cat([(sq[..., 0] + shift_on * T[..., None])[..., None], sq[..., 1:]], -1)
    ne = Ge.shape[1]
    se = he[:, None] - (V @ Ge.reshape(B, ne * 3, nv).mT).reshape(B, K, ne, 3)
    se = se + shift_on * T[..., None, None] * de
    return sl, sq, se


def _min_margin(sl, sq, se) -> torch.Tensor:
    """The smallest cone margin per point, (B, K); +inf for an empty family."""
    inf = torch.full(sl.shape[:2], torch.inf, dtype=sl.dtype, device=sl.device)
    ml = sl.amin(-1) if sl.shape[-1] else inf
    mq = _soc_margin(sq).amin(-1) if sq.shape[2] else inf
    me = _exp_margin(se).amin(-1) if se.shape[2] else inf
    return torch.minimum(ml, torch.minimum(mq, me))


def _barrier_value(sl, sq, se) -> torch.Tensor:
    return (-torch.log(torch.clamp(sl, min=_TINY)).sum(-1) + _soc_barrier(sq).sum(-1)
            + _exp_barrier(se).sum(-1))


def _barrier_grad_hess(sl, sq, se):
    """Per-family barrier gradients and (small dense) Hessians with respect
    to the slacks: ((gl, hll), (gq, hq), (ge, he)); hll is the diagonal."""
    return (-1.0 / sl, 1.0 / (sl * sl)), _soc_grad_hess(sq), _exp_grad_hess(se)


@full_matmul_precision
def exp_barrier_solve(P, q, Gl, hl, Gq, hq, Ge, he, tol_exp: int = -8, max_newton: int = 30,
                      kappa: float = 1e-10):
    """Solve the batch min 0.5 v'Pv + q'v s.t. slacks in (R+^ml x SOCs x EXPs).

    P (B, nv, nv), q (B, nv), Gl (B, ml, nv), hl (B, ml), Gq (B, c, p, nv)
    (zero-padded SOCs), hq (B, c, p), Ge (B, e, 3, nv), he (B, e, 3).
    Returns (v (B, nv), stats) with stats mu (the duality-gap proxy nbar *
    mu of the final centering), iters (the number of phase-II centerings),
    converged, and newton (the lane's Newton steps in both phases, a key the
    JAX stats have not), each (B,)."""
    dtype, dev = q.dtype, q.device
    B, nv = q.shape
    ml, (nq, p), ne = hl.shape[-1], hq.shape[1:], he.shape[1]
    nbar = ml + 2 * nq + 3 * ne  # the total barrier degree
    npdt = np.float64 if dtype == torch.float64 else np.float32
    de = q.new_tensor([-1.0, 1.0, 1.0])
    Gl_T = Gl.mT
    Gq2 = Gq.reshape(B, nq * p, nv)
    Ge2 = Ge.reshape(B, ne * 3, nv)
    mv = lambda A, x: (A @ x[..., None])[..., 0]

    def obj(V):  # (B, K, nv) -> (B, K)
        return 0.5 * ((V @ P) * V).sum(-1) + (V * q[:, None]).sum(-1)

    def F(VT, shift_on, inv_mu):
        """The phase objective with barriers at the points VT (B, K, nv+1);
        _BIG where a slack leaves its cone."""
        V, T = VT[..., :nv], VT[..., nv]
        sl, sq, se = _slacks(V, Gl, hl, Gq, hq, Ge, he, T, shift_on)
        m = _min_margin(sl, sq, se)
        f0 = T if shift_on > 0 else obj(V)
        return torch.where(m > 0, f0 * inv_mu + _barrier_value(sl, sq, se), _BIG)

    def newton_step(vt, shift_on, inv_mu):
        """One damped-Newton direction on the joint variable vt = [v; t]:
        (step (B, nv+1), the squared Newton decrement (B,))."""
        v, t = vt[:, :nv], vt[:, nv]
        sl, sq, se = (a[:, 0] for a in _slacks(v[:, None], Gl, hl, Gq, hq, Ge, he,
                                                t[:, None], shift_on))
        (gl, hll), (gq, hqq), (ge, hee) = _barrier_grad_hess(sl, sq, se)
        # d s / d v = -G for every family, d s / d t = the shift
        # the objective's terms enter in phase II only (the JAX code
        # multiplies them by 0 in phase I)
        g_v = inv_mu * (mv(P, v) + q) if shift_on == 0 else torch.zeros_like(v)
        g_v = g_v - mv(Gl_T, gl) - mv(Gq2.mT, gq.reshape(B, -1)) \
            - mv(Ge2.mT, ge.reshape(B, -1))
        g_t = shift_on * (gl.sum(-1) + gq[..., 0].sum(-1) + (ge @ de).sum(-1))
        if shift_on > 0:
            g_t = inv_mu + g_t
        HG_q = (hqq @ Gq).reshape(B, nq * p, nv)
        HG_e = (hee @ Ge).reshape(B, ne * 3, nv)
        Hvv = (Gl_T * hll[:, None, :]) @ Gl
        if shift_on == 0:
            Hvv = inv_mu * P + Hvv
        Hvv = Hvv + Gq2.mT @ HG_q + Ge2.mT @ HG_e
        Hvt = shift_on * (-mv(Gl_T, hll) - mv(Gq2.mT, hqq[..., 0].reshape(B, -1))
                          - mv(Ge2.mT, (hee @ de).reshape(B, -1)))
        Htt = shift_on * (hll.sum(-1) + hqq[..., 0, 0].sum(-1)
                          + ((hee @ de) @ de).sum(-1)) + 1e-12
        # Schur solve of the (nv + 1) system through the nv block
        L = spd_factor(Hvv, jitter=kappa)
        w = spd_apply(L, Hvt)
        schur = Htt - (Hvt * w).sum(-1)
        rhs_t = g_t - (Hvt * spd_apply(L, g_v)).sum(-1)
        if shift_on > 0:
            dt = rhs_t / torch.clamp(schur, min=1e-30)
        else:
            dt = torch.zeros_like(rhs_t)
        dv = spd_apply(L, g_v - shift_on * Hvt * dt[:, None])
        step = -torch.cat([dv, dt[:, None]], -1)
        dec2 = -(step * torch.cat([g_v, g_t[:, None]], -1)).sum(-1)
        return step, dec2

    alphas = 0.5 ** torch.arange(N_LADDER, dtype=dtype, device=dev)

    def backtrack(vt, step, shift_on, inv_mu):
        """The largest 0.5^k (k < 40) with F(vt + 0.5^k step) < F(vt), every
        k at once: (the new point, accepted (B,)). A lane that accepts none
        keeps vt (plus 0 times the last trial's move, as the JAX code
        writes it)."""
        F0 = F(vt[:, None], shift_on, inv_mu)[:, 0]
        trial = vt[:, None] + alphas[:, None] * step[:, None]
        passed = F(trial, shift_on, inv_mu) < F0[:, None]
        ok = passed.any(-1)
        k = torch.where(ok, passed.to(torch.int32).argmax(-1), N_LADDER - 1)
        vt_n = trial[torch.arange(B, device=dev), k]
        return ok.to(dtype)[:, None] * (vt_n - vt) + vt, ok

    def center(vt, shift_on, inv_mu, stop_t_neg):
        """Damped Newton until the decrement is small (or t < -1e-3 in
        phase I), every lane on its own count."""
        k = torch.zeros(B, dtype=torch.int32, device=dev)
        dec2 = torch.ones(B, dtype=dtype, device=dev)
        for n in range(max_newton):
            active = (dec2 > 1e-10) & (k < max_newton)
            if stop_t_neg:
                active = active & ~(vt[:, nv] < -1e-3)
            if n % CHECK_EVERY == 0 and not bool(active.any()):
                break
            step, dec2_n = newton_step(vt, shift_on, inv_mu)
            vt_n, ok = backtrack(vt, step, shift_on, inv_mu)
            vt = torch.where(active[:, None], vt_n, vt)
            dec2 = torch.where(active, torch.where(ok, dec2_n, 0.0), dec2)
            k = k + active.to(torch.int32)
        return vt, k

    def margin0(v):
        zero = torch.zeros((B, 1), dtype=dtype, device=dev)
        return _min_margin(*_slacks(v[:, None], Gl, hl, Gq, hq, Ge, he, zero, 0.0))[:, 0]

    # -- phase I: a strictly feasible point ------------------------------------
    GtG = Gl_T @ Gl + Gq2.mT @ Gq2 + Ge2.mT @ Ge2
    Gth = mv(Gl_T, hl) + mv(Gq2.mT, hq.reshape(B, -1)) + mv(Ge2.mT, he.reshape(B, -1))
    v0 = spd_apply(spd_factor(P + GtG, jitter=1e-8), -q + Gth)
    t0 = torch.ones(B, dtype=dtype, device=dev)
    while True:
        short = _min_margin(*_slacks(v0[:, None], Gl, hl, Gq, hq, Ge, he, t0[:, None],
                                     1.0))[:, 0] < 1.0
        if not bool(short.any()):
            break
        t0 = torch.where(short, 2.0 * t0 + 1.0, t0)
    vt = torch.cat([v0, t0[:, None]], -1)
    # a few outer reductions on the phase-I path (objective t)
    newton = torch.zeros(B, dtype=torch.int32, device=dev)
    for inv_mu1 in (1.0, 10.0, 100.0, 1000.0):
        vt, k = center(vt, 1.0, inv_mu1, True)
        newton = newton + k
    feasible = margin0(vt[:, :nv]) > 0

    # -- phase II: path following on the true objective -------------------------
    vt = torch.cat([vt[:, :nv], torch.zeros((B, 1), dtype=dtype, device=dev)], -1)
    n_outer = int(np.ceil(np.log(1.0 / 10.0 ** tol_exp) / np.log(5.0))) + 1
    mu, mu_min = npdt(1.0), npdt(10.0 ** tol_exp)
    for _ in range(n_outer):
        mu_used = mu
        vt_n, k = center(vt, 0.0, float(npdt(1.0) / mu), False)
        newton = newton + k
        # keep the old point where a centering went non-finite
        vt = torch.where(torch.isfinite(vt_n).all(-1, keepdim=True), vt_n, vt)
        mu = max(mu / npdt(5.0), mu_min)
    v = vt[:, :nv]
    # convergence needs centering progress, not just feasibility: a stalled
    # phase II (every backtrack failing) leaves a large decrement
    _, dec2 = newton_step(vt, 0.0, float(npdt(1.0) / mu_used))
    ok = feasible & torch.isfinite(v).all(-1) & (margin0(v) > 0) & (dec2 < 1e-2)
    gap = torch.full((B,), float(max(nbar, 1)) * float(mu_used), dtype=dtype, device=dev)
    stats = dict(mu=gap, iters=torch.full((B,), n_outer, dtype=torch.int32, device=dev),
                 converged=ok, newton=newton)
    return v, stats
