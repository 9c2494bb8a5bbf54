"""Smooth-constraint path: damped Newton, L-BFGS and the dense solvers over
the condensed consensus problem, and the Riccati smooth Newton.

Twin of ``pmpc_tpu/solvers/barrier.py`` (the reference's constraint
smoothing, ``PMPC.jl/src/cone_utils.jl:173-232`` / ``main.jl:242-290``):
each box row ``a'z <= b`` is replaced by a smooth penalty of the violation
``y = a'z - b``,

- ``logbarrier``: phi(y) = -(1/alpha) log(-alpha y) (domain y < 0), the
  exp-cone reformulation the reference hands to ECOS/Mosek and the smoothed
  objective of its experimental GPU path (``pmpc/experimental/
  solver_definitions.py:45-86``),
- ``squareplus``: phi(y) = (beta/2) (y + sqrt(y^2 + 1/alpha^2)), the SOC
  reformulation of ``cone_utils.jl:222-228``.

`barrier_core`: the Newton matrix is ``H + G' diag(phi''(y)) G``, which keeps
the arrow structure (`ipm.box_weighted_K`), so a Newton step costs the
batched factor of an IPM iteration: on a CUDA tensor the per-particle blocks
and the consensus Schur complement go to the hand kernel K2 (K4 past n =
64). Each step takes the best of ``ls_steps`` halvings (+inf outside the
logbarrier domain keeps the iterate strictly feasible); `barrier_solve_np`
starts it from the exact box solution of `ipm.ipm_core` (K1 + K2).
`riccati_barrier_core` is the same Newton with O(N) Riccati solves of each
step (no hand kernel). `lbfgs_core` is the ``BFGS`` / ``LBFGS`` registry
entry and the solver of a user ``diff_cost_fn``, a torch callable
``(X (M, N, xdim), U (M, N, udim)) -> scalar`` whose gradient comes from
autograd; ``CVX`` / ``SQP`` go to `second_order.dense_newton_solve`.

The JAX ``lbfgs_core`` runs ``optax.lbfgs`` (zoom line search); here it is a
two-loop recursion with a strong-Wolfe line search of its own, per lane, run
for the same fixed number of iterations: the same optimum, not the same
iterates (ROADMAP §3 F8). The JAX ``canonical_fn`` keys its jit cache by the
cloudpickle bytes of a callable; the port has no such cache and no twin.

Every core takes an explicit leading batch axis B; the ``_np`` entry points solve
one problem at B = 1 and put it on the card unless given ``device``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.linalg import psd_solve
from ..utils import default_device, full_matmul_precision
from .ipm import BoxBounds, _layout_bounds, box_weighted_K, ipm_core
from .reduced import CondensedQP, arrow_apply, arrow_factor, assemble_condensed, recover_XU
from .riccati import _scp_stage_terms, _theta_backward, _theta_forward, augment_slew_stages
from .second_order import dense_newton_solve


def _phi(method: str, y, alpha, beta):
    """Penalty value, derivative and curvature of a violation y (elementwise)."""
    if method == "logbarrier":
        val = torch.where(y < 0, -torch.log(torch.clamp(-alpha * y, min=1e-300)) / alpha,
                          torch.inf)
        d1 = torch.where(y < 0, -1.0 / (alpha * y), 0.0)
        d2 = torch.where(y < 0, 1.0 / (alpha * y * y), 0.0)
    elif method == "squareplus":
        s = torch.sqrt(y * y + 1.0 / (alpha * alpha))
        val = 0.5 * beta * (y + s)
        d1 = 0.5 * beta * (1.0 + y / s)
        d2 = 0.5 * beta / (alpha * alpha * s * s * s)
    else:
        raise ValueError(f"unknown smoothing method {method}")
    return val, d1, d2


N_WOLFE = 20  # the L-BFGS line search's trial points (optax's zoom line search takes 20)
C1_WOLFE, C2_WOLFE = 1e-4, 0.9  # its sufficient-decrease and curvature constants
APPROX_DEC = 1e-6  # its relative tolerance of the approximate decrease


def _masked_pen(method, m, y, alpha, beta):
    """phi(y) where the row exists (mask ``m``), else 0, elementwise."""
    return torch.where(m, _phi(method, torch.where(m, y, -1.0), alpha, beta)[0], 0.0)


class _Smoothed:
    """The smoothed objective of a batch of condensed QPs, evaluated at K
    points per lane: uc (B, K, nc), uf (B, K, M, nf) -> (B, K)."""

    def __init__(self, cqp: CondensedQP, bounds: BoxBounds, method, alpha, beta):
        self.cqp, self.method, self.alpha, self.beta = cqp, method, alpha, beta
        self.b = bounds
        self.has_xb = bounds.lo_x is not None
        lohi = [bounds.lo_c, bounds.hi_c, bounds.lo_f, bounds.hi_f]
        if self.has_xb:
            lohi += [bounds.lo_x, bounds.hi_x]
        self.masks = [torch.isfinite(a) for a in lohi]

    def states(self, uc, uf):
        """(x (..., M, NX), w (..., M, NU)) of uc (B, ..., nc), uf (B, ...,
        M, nf)."""
        cqp = self.cqp
        w = torch.cat([uc[..., None, :].expand(uf.shape[:-1] + uc.shape[-1:]), uf], -1)
        return (cqp.Ft[:, None] @ w[..., None])[..., 0] + cqp.g[:, None], w

    def violations(self, uc, uf):
        """y = a'z - b per group (lo rows: lo - v; hi rows: v - hi)."""
        b = self.b  # (B, ...) bounds against (B, K, ...) points
        ys = [b.lo_c[:, None] - uc, uc - b.hi_c[:, None],
              b.lo_f[:, None] - uf, uf - b.hi_f[:, None]]
        if self.has_xb:
            x, _ = self.states(uc, uf)
            ys += [b.lo_x[:, None] - x, x - b.hi_x[:, None]]
        return ys

    def quad(self, uc, uf):
        cqp = self.cqp
        mv = lambda A, x: (A @ x[..., None])[..., 0]
        quad = 0.5 * (uc * mv(cqp.Hcc[:, None], uc)).sum(-1) + (cqp.qc[:, None] * uc).sum(-1)
        quad = quad + (uf * mv(cqp.Hff[:, None], uf)).sum((-2, -1)) * 0.5
        quad = quad + (mv(cqp.Hcf[:, None], uf) * uc[..., None, :]).sum((-2, -1))
        return quad + (cqp.qf[:, None] * uf).sum((-2, -1))

    def __call__(self, uc, uf):
        pen = 0.0
        for m, y in zip(self.masks, self.violations(uc, uf)):
            pen = pen + _masked_pen(self.method, m[:, None], y, self.alpha,
                                    self.beta).flatten(2).sum(-1)
        return self.quad(uc, uf) + pen

    def terms(self, uc, uf):
        """At one point a lane, uc (B, nc), uf (B, M, nf): (the value (B,),
        phi' and phi'' of every row group in the order of `violations`, 0
        where the row is absent, None for the state rows without state
        bounds)."""
        ys = [y[:, 0] for y in self.violations(uc[:, None], uf[:, None])]
        pen, d1, d2 = 0.0, [], []
        for m, y in zip(self.masks, ys):
            p0, p1, p2 = _phi(self.method, torch.where(m, y, -1.0), self.alpha, self.beta)
            pen = pen + torch.where(m, p0, 0.0).flatten(1).sum(-1)
            d1.append(torch.where(m, p1, 0.0))
            d2.append(torch.where(m, p2, 0.0))
        if not self.has_xb:
            d1 += [None, None]
            d2 += [None, None]
        return self.quad(uc[:, None], uf[:, None])[:, 0] + pen, d1, d2

    def grad(self, uc, uf, d1, has_u: bool, has_x: bool):
        """The gradient Hz + q + sum phi' a (lo rows a = -e, hi rows a = +e)
        at uc (B, nc), uf (B, M, nf), phi' from `terms`: (gc, gf)."""
        cqp, nc = self.cqp, self.cqp.nc
        mv = lambda A, x: (A @ x[..., None])[..., 0]
        clo1, chi1, flo1, fhi1, xlo1, xhi1 = d1
        gc = mv(cqp.Hcc, uc) + mv(cqp.Hcf, uf).sum(1) + cqp.qc
        gf = (uc[:, None, None, :] @ cqp.Hcf)[..., 0, :] + mv(cqp.Hff, uf) + cqp.qf
        if has_u:
            gc = gc + (chi1 - clo1)
            gf = gf + (fhi1 - flo1)
        if has_x:
            dx1 = xhi1 - xlo1
            gc = gc + (dx1[..., None, :] @ cqp.Ft[..., :nc])[..., 0, :].sum(1)
            gf = gf + (dx1[..., None, :] @ cqp.Ft[..., nc:])[..., 0, :]
        return gc, gf


def _best_of_halvings(f_t: torch.Tensor, fval: torch.Tensor, ts: torch.Tensor):
    """The best strict decrease among the trial values f_t (B, K) at steps ts
    (K,), ties to the first: (t_best (B,), f_best (B,)), t_best 0 and f_best
    fval where none decreases (the JAX loop over k keeps the first strict
    improvement of the running best)."""
    f_t = torch.where(torch.isnan(f_t), torch.inf, f_t)
    k = f_t.argmin(-1)
    f_min = f_t.gather(-1, k[:, None])[:, 0]
    better = f_min < fval
    return torch.where(better, ts[k], 0.0), torch.where(better, f_min, fval)


@full_matmul_precision
def barrier_core(cqp: CondensedQP, bounds: BoxBounds, method: str, alpha, beta, has_u: bool,
                 has_x: bool, iters: int = 20, ls_steps: int = 25, kappa: float = 0.0,
                 start: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Damped Newton on F(z) = 0.5 z'Hz + q'z + sum phi(violations) of every
    lane, ``iters`` steps. ``bounds`` in the layout of `ipm.BoxBounds`
    ((B, nc), (B, M, nf), (B, M, NX)); ``start`` (uc (B, nc), uf (B, M, nf)),
    else the mean of the previous controls. Returns (uc, uf, dict(obj (B,)))."""
    dtype, dev = cqp.qf.dtype, cqp.qf.device
    nc = cqp.nc
    Ftc, Ftf = cqp.Ft[..., :nc], cqp.Ft[..., nc:]
    F = _Smoothed(cqp, bounds, method, alpha, beta)
    ts = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)
    if start is None:
        uc, uf = cqp.w_prev[..., :nc].mean(1), cqp.w_prev[..., nc:]
    else:
        uc, uf = start
    fval = F(uc[:, None], uf[:, None])[:, 0]
    for _ in range(iters):
        _, d1, (clo2, chi2, flo2, fhi2, xlo2, xhi2) = F.terms(uc, uf)
        gc, gf = F.grad(uc, uf, d1, has_u, has_x)
        wx = xlo2 + xhi2 if has_x else None
        Kcc, Kcf, Kff = box_weighted_K(cqp, clo2 + chi2, flo2 + fhi2, wx, Ftc, Ftf,
                                       has_u=has_u, has_x=has_x)
        duc, duf = arrow_apply(arrow_factor(Kcc, Kcf, Kff, jitter=kappa), -gc, -gf)
        # the best of the halvings (+inf outside the logbarrier domain)
        f_t = F(uc[:, None] + ts[:, None] * duc[:, None],
                uf[:, None] + ts[:, None, None] * duf[:, None])
        t_best, fval = _best_of_halvings(f_t, fval, ts)
        uc = uc + t_best[:, None] * duc
        uf = uf + t_best[:, None, None] * duf
    return uc, uf, dict(obj=fval)


def _cubic_min(t1, f1, d1, t2, f2, d2):
    """The minimizer of the cubic through (t1, f1, slope d1) and (t2, f2,
    slope d2), elementwise (Nocedal & Wright eq. 3.59); NaN where it has
    none (or an end is not finite)."""
    a = d1 + d2 - 3.0 * (f1 - f2) / (t1 - t2)
    b = torch.sqrt(a * a - d1 * d2)  # NaN where the cubic has no minimizer
    return t2 - (t2 - t1) * (d2 + b - a) / (d2 - d1 + 2.0 * b)


def _wolfe_search(value_grad, x, f, g, d, max_trials: int = N_WOLFE):
    """Strong-Wolfe line search along d for every lane on its own
    (Nocedal & Wright, Algorithms 3.5 and 3.6: expand t = 1, 2, 4, ... until
    a bracket, then zoom by the safeguarded cubic step, bisecting where it
    falls within a tenth of the bracket's ends). c1 = 1e-4, c2 = 0.9 and
    the approximate decrease of Hager and Zhang (2006, eq. 23) within 1e-6
    of |f|, as optax's zoom line search has them. A lane that meets no Wolfe point
    within ``max_trials`` evaluations takes its best sufficient-decrease
    point so far, or stays (t = 0). Returns (t, f, g) at the chosen point
    and whether the lane moved (B,)."""
    gd = (g * d).sum(-1)
    lo_t, lo_f, lo_d, lo_g = torch.zeros_like(f), f, gd, g  # the best Armijo point
    hi_t, hi_f, hi_d = torch.full_like(f, torch.inf), torch.full_like(f, torch.inf), gd
    t = torch.ones_like(f)
    done = torch.zeros_like(f, dtype=torch.bool)
    for k in range(max_trials):
        f_t, g_t = value_grad(x + t[:, None] * d)
        d_t = (g_t * d).sum(-1)
        # sufficient decrease: Armijo, or Hager and Zhang's approximate form
        # near the minimum, where the value's rounding hides the decrease
        decrease = (f_t <= f + C1_WOLFE * t * gd) | (
            (d_t <= (2.0 * C1_WOLFE - 1.0) * gd) & (f_t <= f + APPROX_DEC * f.abs()))
        high = ~decrease | ((k > 0) & ~(f_t < lo_f))  # NaN/inf fail too
        wolfe = ~high & (d_t.abs() <= -C2_WOLFE * gd)
        # a new low point: the old one becomes the far end where the slope turns
        flip = ~high & ~wolfe & (d_t * torch.sign(hi_t - lo_t) >= 0)
        new_hi, new_lo = ~done & (high | flip), ~done & ~high
        hi_t = torch.where(new_hi, torch.where(high, t, lo_t), hi_t)
        hi_f = torch.where(new_hi, torch.where(high, f_t, lo_f), hi_f)
        hi_d = torch.where(new_hi, torch.where(high, d_t, lo_d), hi_d)
        lo_t = torch.where(new_lo, t, lo_t)
        lo_f = torch.where(new_lo, f_t, lo_f)
        lo_d = torch.where(new_lo, d_t, lo_d)
        lo_g = torch.where(new_lo[:, None], g_t, lo_g)
        done = done | wolfe
        if bool(done.all()):
            break
        # the next trial: expand while there is no far end, else zoom
        c = _cubic_min(lo_t, lo_f, lo_d, hi_t, hi_f, hi_d)
        a, b = torch.minimum(lo_t, hi_t), torch.maximum(lo_t, hi_t)
        w = 0.1 * (b - a)
        c = torch.where(torch.isfinite(c) & (c >= a + w) & (c <= b - w), c, 0.5 * (a + b))
        t = torch.where(torch.isinf(hi_t), 2.0 * lo_t, c)
    return lo_t, lo_f, lo_g, lo_t > 0


@full_matmul_precision
def lbfgs_core(cqp: CondensedQP, bounds: BoxBounds, method: str, alpha, beta, has_u: bool,
               has_x: bool, iters: int = 100, extra_obj: Optional[Callable] = None, N: int = 0,
               xdim: int = 0, udim: int = 0, memory_size: int = 10):
    """L-BFGS on the smoothed objective of every lane, ``iters`` iterations
    (the reference's experimental BFGS / LBFGS solvers, ``solver_definitions.
    py:25-28,137-145``; ``memory_size = iters`` is full-memory BFGS).

    A two-loop recursion over the last ``memory_size`` pairs (a pair whose
    curvature s'y is not positive is dropped for its lane), the first
    direction scaled by min(1, 1/|g|_2) as optax scales it, and a
    strong-Wolfe line search per lane (`_wolfe_search`; +inf outside the
    logbarrier domain fails it). An iteration in which no lane moves ends
    the loop: the ones after it would repeat it. The smoothed objective's
    gradient is the closed form `barrier_core` takes; ``extra_obj`` (X (M,
    N, xdim), U (M, N, udim)) -> scalar is added to every lane's objective,
    its gradient by autograd. ``has_u`` / ``has_x`` are implied by the
    finite bounds. Returns (uc, uf, dict(obj (B,)))."""
    dtype = cqp.qf.dtype
    B, M, nc, nf = cqp.Hcc.shape[0], cqp.M, cqp.nc, cqp.nf
    F = _Smoothed(cqp, bounds, method, alpha, beta)

    def split(x):
        return x[:, :nc], x[:, nc:].reshape(B, M, nf)

    def value_grad(x):  # (B, n) -> (B,), (B, n)
        uc, uf = split(x)
        f, d1, _ = F.terms(uc, uf)
        g = torch.cat([a.reshape(B, -1) for a in F.grad(uc, uf, d1, has_u, has_x)], -1)
        if extra_obj is not None:
            # an additive differentiable cost over the trajectory (the
            # experimental diff_cost_fn, jax_solver.py:126-137), by autograd
            with torch.enable_grad():
                x = x.detach().requires_grad_(True)
                uc, uf = split(x)
                X, w = F.states(uc[:, None], uf[:, None])
                X, U = X[:, 0].reshape(B, M, N, xdim), w[:, 0].reshape(B, M, N, udim)
                e = torch.stack([extra_obj(X[b], U[b]) for b in range(B)]).to(dtype)
                (ge,) = torch.autograd.grad(e.sum(), x)
            f, g = f + e.detach(), g + ge
        return f, g

    x = torch.cat([cqp.w_prev[..., :nc].mean(1), cqp.w_prev[..., nc:].reshape(B, -1)], -1)
    f, g = value_grad(x)
    S, Y, rho = [], [], []
    dot = lambda a, b: (a * b).sum(-1)
    for _ in range(iters):
        # two-loop recursion
        r = -g
        alph = []
        for s, y, p in zip(reversed(S), reversed(Y), reversed(rho)):
            a = p * dot(s, r)
            r = r - a[:, None] * y
            alph.append(a)
        if S:
            sy, yy = dot(S[-1], Y[-1]), dot(Y[-1], Y[-1])
            gamma = torch.where(rho[-1] > 0, sy / torch.where(yy > 0, yy, 1.0), 1.0)
            r = gamma[:, None] * r
        else:
            r = r * torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0)[:, None]
        for s, y, p, a in zip(S, Y, rho, reversed(alph)):
            bcoef = p * dot(y, r)
            r = r + (a - bcoef)[:, None] * s
        d = torch.where((dot(g, r) < 0)[:, None], r, -g)
        t, f_n, g_n, moved = _wolfe_search(value_grad, x, f, g, d)
        if not bool(moved.any()):
            # no lane moved: every later iteration would repeat this one
            break
        x_n = x + t[:, None] * d
        s, y = x_n - x, g_n - g
        sy = dot(s, y)
        keep = moved & (sy > 1e-12 * torch.sqrt(dot(s, s) * dot(y, y)))
        S.append(torch.where(keep[:, None], s, 0.0))
        Y.append(torch.where(keep[:, None], y, 0.0))
        rho.append(torch.where(keep, 1.0 / torch.where(keep, sy, 1.0), 0.0))
        if len(S) > memory_size:
            S.pop(0)
            Y.pop(0)
            rho.pop(0)
        x, f, g = x_n, f_n, g_n
    uc, uf = split(x)
    return uc, uf, dict(obj=f)


def _dense_objective_fn(method: str, extra_obj, M: int, N: int, xdim: int, udim: int,
                        nc: int):
    """The smoothed objective over the stacked z (n,) of one lane, for the
    dense CVX / SQP solvers; the problem data arrive as its further
    arguments (mapped over the lanes by `dense_newton_solve`)."""
    nf = N * udim - nc

    def objective(z, Hcc, Hcf, Hff, qc, qf, Ft, g, lo_c, hi_c, lo_f, hi_f, lo_x, hi_x,
                  alpha, beta):
        mv = lambda A, x: (A @ x[..., None])[..., 0]
        uc = z[:nc]
        uf = z[nc:].reshape(M, nf)
        quad = 0.5 * (uc * mv(Hcc, uc)).sum() + (qc * uc).sum()
        quad = quad + (uf * mv(Hff, uf)).sum() * 0.5
        quad = quad + (mv(Hcf, uf) * uc).sum()
        quad = quad + (qf * uf).sum()
        w = torch.cat([uc.expand(M, nc), uf], -1)
        x = mv(Ft, w) + g
        pen = torch.zeros((), dtype=z.dtype, device=z.device)
        for lo, hi, v in ((lo_c, hi_c, uc), (lo_f, hi_f, uf), (lo_x, hi_x, x)):
            for mask, y in ((torch.isfinite(lo), lo - v), (torch.isfinite(hi), v - hi)):
                pen = pen + torch.where(
                    mask, _phi(method, torch.where(mask, y, -1.0), alpha, beta)[0], 0.0).sum()
        if extra_obj is not None:
            pen = pen + extra_obj(x.reshape(M, N, xdim), w.reshape(M, N, udim))
        return quad + pen

    return objective


def _torch_dtype(a) -> torch.dtype:
    return torch.float64 if np.asarray(a).dtype == np.float64 else torch.float32


def barrier_solve_np(base_args, reg_args, u_l, u_u, x_l, x_u, Nc: int, weights=None,
                     method: str = "logbarrier", alpha: float = 1.0, beta: float = 1.0,
                     settings: Optional[Dict[str, Any]] = None,
                     extra_obj: Optional[Callable] = None,
                     device=None) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """The smooth path on one problem, numpy in and out: (X (M, N, xdim),
    U (M, N, udim), data with solver_state and obj).

    ``base_args`` (x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref) and
    ``reg_args`` (reg_x, reg_u, slew_reg, slew_reg0, slew_um1) as the JAX
    function takes them; the dtype is f's. ``settings["solver"]`` "CVX" /
    "SQP" takes the dense Newton, "BFGS" / "LBFGS" (or any ``extra_obj``)
    L-BFGS (``max_it`` iterations, 100, or 200 with ``extra_obj``), else the
    structured Newton (``newton_iters``, 20) from the exact box solution of
    ``ipm_core`` (``ipm_iters``, ``ipm_tol_exp``, ``ipm_kappa``). The tensors
    go to ``device``, the card by default."""
    settings = settings or {}
    dev = default_device() if device is None else torch.device(device)
    f = np.asarray(base_args[1])
    M, N, xdim = f.shape
    udim = np.asarray(base_args[3]).shape[-1]
    tdt = _torch_dtype(f)
    np_dt = np.float64 if tdt == torch.float64 else np.float32
    T = lambda a: torch.as_tensor(np.array(a), dtype=tdt, device=dev)[None]
    cqp = assemble_condensed(
        *(T(a) for a in base_args), *(T(a) for a in reg_args), Nc=Nc,
        weights=None if weights is None else T(weights),
        scale_slew_target=bool(settings.get("weights_scale_slew_target", True)))
    nc, nf = Nc * udim, (N - Nc) * udim
    bounds = _layout_bounds(u_l, u_u, x_l, x_u, M, N, N * xdim, nc, nf, udim, np_dt,
                            device=dev)
    has_u = u_l is not None or u_u is not None
    has_x = x_l is not None or x_u is not None
    solver_name = str(settings.get("solver", "")).upper()

    if solver_name in ("CVX", "SQP"):
        obj_z = _dense_objective_fn(method, extra_obj, M, N, xdim, udim, nc)
        a = lambda v: torch.full((1,), float(v), dtype=tdt, device=dev)
        obj_args = (cqp.Hcc, cqp.Hcf, cqp.Hff, cqp.qc, cqp.qf, cqp.Ft, cqp.g, bounds.lo_c,
                    bounds.hi_c, bounds.lo_f, bounds.hi_f, bounds.lo_x, bounds.hi_x,
                    a(alpha), a(beta))
        z0 = torch.cat([cqp.w_prev[..., :nc].mean(1), cqp.w_prev[..., nc:].reshape(1, -1)], -1)
        z, obj = dense_newton_solve(obj_z, z0, obj_args,
                                    iters=int(settings.get("newton_iters", 30)),
                                    ls_steps=int(settings.get("ls_steps", 25)),
                                    regularized=solver_name == "SQP")
        uc, uf = z[:, :nc], z[:, nc:].reshape(1, M, nf)
        stats = dict(obj=obj)
    elif extra_obj is not None or solver_name in ("BFGS", "LBFGS"):
        # arbitrary additive costs need a general smooth solver: L-BFGS
        iters = int(settings.get("max_it", 100 if extra_obj is None else 200))
        uc, uf, stats = lbfgs_core(cqp, bounds, method=method, alpha=alpha, beta=beta,
                                   has_u=has_u, has_x=has_x, iters=iters, extra_obj=extra_obj,
                                   N=N, xdim=xdim, udim=udim,
                                   memory_size=iters if solver_name == "BFGS" else 10)
    else:
        kappa = float(settings.get("ipm_kappa", 0.0 if tdt == torch.float64 else 1e-7))
        # warm start from the exact box-QP solution: the smoothed optimum is
        # a small perturbation of it, reached in a few Newton steps
        uc0, uf0, _ = ipm_core(
            cqp, bounds, has_u=has_u, has_x=has_x, iters=int(settings.get("ipm_iters", 30)),
            tol_exp=int(settings.get("ipm_tol_exp", -8 if tdt == torch.float64 else -5)),
            kappa=kappa)
        uc, uf, stats = barrier_core(cqp, bounds, method=method, alpha=alpha, beta=beta,
                                     has_u=has_u, has_x=has_x,
                                     iters=int(settings.get("newton_iters", 20)),
                                     ls_steps=int(settings.get("ls_steps", 25)), kappa=kappa,
                                     start=(uc0, uf0))
    X, U = recover_XU(cqp, uc, uf, N=N)
    return (X[0].cpu().numpy(), U[0].cpu().numpy(),
            dict(solver_state=settings.get("solver_state"), obj=float(stats["obj"][0])))


# -- stage-structured (Riccati) smooth Newton --------------------------------------------


def _riccati_consensus_raw(x0s, c, A, B, Qt, xt, Rt, ut, Nc: int):
    """O(N) consensus LQR on raw per-particle stage terms, (B, M, ...): the
    theta sweep of `riccati.riccati_consensus_solve` with the stage cost
    terms given (the smooth Newton changes Qt / xt / Rt / ut every step).
    Returns (X (B, M, N, na), U (B, M, N, udim))."""
    S, s, gains = _theta_backward(x0s, c, A, B, Qt, xt, Rt, ut, Nc)
    S_tot, s_tot = S.sum(-3), s.sum(-2)
    theta = -psd_solve(S_tot, s_tot) if S_tot.shape[-1] else s_tot
    return _theta_forward(x0s, c, A, B, theta[..., None, :], gains, Nc)


@full_matmul_precision
def riccati_barrier_core(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u,
                         u_l, u_u, x_l, x_u, Nc: int, method: str, alpha, beta, has_u: bool,
                         has_x: bool, has_slew: bool = False, slew_reg=None, slew_reg0=None,
                         slew_um1=None, iters: int = 25, ls_steps: int = 25):
    """Damped Newton on the smoothed box problem with O(N) Riccati solves,
    every array (B, M, ...) (reg_x, reg_u, slew_reg, slew_reg0 (B, M)).

    The Newton subproblem around (X, U) is itself a stage-diagonal LQR: the
    penalty curvature phi'' lands on the Qt / Rt diagonals and phi' in the
    stage linear terms, so each step is one consensus theta sweep; z + t dz
    stays dynamics-feasible for every t (``cone_utils.jl:204-232``'s
    squareplus semantics). The consensus stages' controls are shared: their
    box rows exist once, with particle 0's bounds (``lqp_utils.jl:323-331``).
    With slew the stage state is augmented to ``na = xdim + 2 udim`` and the
    state penalty reads its first xdim entries. Returns (X, U, dict(obj))."""
    dtype, dev = f.dtype, f.device
    Bn, M, N, xdim = f.shape
    udim = fu.shape[-1]
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                                         reg_x, reg_u)
    A, Bm, x0s = fx, fu, x0
    if has_slew:
        x0s, c, A, Bm, Qt, xt = augment_slew_stages(x0, c, A, Bm, Qt, xt, slew_reg, slew_reg0,
                                                    slew_um1)
    na = c.shape[-1]
    keep = ((torch.arange(N, device=dev) >= Nc)[None, :, None]
            | (torch.arange(M, device=dev) == 0)[:, None, None])
    none = lambda a: torch.zeros_like(a, dtype=torch.bool)
    m_ulo = torch.isfinite(u_l) & keep if has_u else none(u_l)
    m_uhi = torch.isfinite(u_u) & keep if has_u else none(u_u)
    m_xlo = torch.isfinite(x_l) if has_x else none(x_l)
    m_xhi = torch.isfinite(x_u) if has_x else none(x_u)

    def objective(Xa, U):  # (B, K, M, N, .) -> (B, K)
        quad_form = lambda v, H: (v[..., None, :] @ H @ v[..., None])[..., 0, 0]
        val = 0.5 * quad_form(Xa, Qt[:, None]).sum((-2, -1)) \
            - (xt[:, None] * Xa).sum((-3, -2, -1))
        val = val + 0.5 * quad_form(U, Rt[:, None]).sum((-2, -1)) \
            - (ut[:, None] * U).sum((-3, -2, -1))
        Xr = Xa[..., :xdim]
        pen = 0.0
        for m, y in ((m_ulo, u_l[:, None] - U), (m_uhi, U - u_u[:, None]),
                     (m_xlo, x_l[:, None] - Xr), (m_xhi, Xr - x_u[:, None])):
            pen = pen + _masked_pen(method, m[:, None], y, alpha, beta).sum((-3, -2, -1))
        return val + pen

    Xa, U = _riccati_consensus_raw(x0s, c, A, Bm, Qt, xt, Rt, ut, Nc)
    fval = objective(Xa[:, None], U[:, None])[:, 0]
    ts = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)
    eye_u = torch.eye(udim, dtype=dtype, device=dev)
    eye_a = torch.eye(na, dtype=dtype, device=dev)
    for _ in range(iters):
        Xr = Xa[..., :xdim]
        Rt_n, ut_n, Qt_n, xt_n = Rt, ut, Qt, xt
        if has_u:
            plo = _phi(method, torch.where(m_ulo, u_l - U, -1.0), alpha, beta)
            phi_ = _phi(method, torch.where(m_uhi, U - u_u, -1.0), alpha, beta)
            d1u = torch.where(m_uhi, phi_[1], 0.0) - torch.where(m_ulo, plo[1], 0.0)
            d2u = torch.where(m_ulo, plo[2], 0.0) + torch.where(m_uhi, phi_[2], 0.0)
            Rt_n = Rt + d2u[..., :, None] * eye_u
            ut_n = ut + d2u * U - d1u
        if has_x:
            plo = _phi(method, torch.where(m_xlo, x_l - Xr, -1.0), alpha, beta)
            phi_ = _phi(method, torch.where(m_xhi, Xr - x_u, -1.0), alpha, beta)
            d1x = torch.where(m_xhi, phi_[1], 0.0) - torch.where(m_xlo, plo[1], 0.0)
            d2x = torch.where(m_xlo, plo[2], 0.0) + torch.where(m_xhi, phi_[2], 0.0)
            pad = torch.zeros((Bn, M, N, na), dtype=dtype, device=dev)
            pad[..., :xdim] = d2x
            Qt_n = Qt + pad[..., :, None] * eye_a
            lin = torch.zeros((Bn, M, N, na), dtype=dtype, device=dev)
            lin[..., :xdim] = d2x * Xr - d1x
            xt_n = xt + lin
        Xn, Un = _riccati_consensus_raw(x0s, c, A, Bm, Qt_n, xt_n, Rt_n, ut_n, Nc)
        dX, dU = Xn - Xa, Un - U
        tk = ts[:, None, None, None]
        f_t = objective(Xa[:, None] + tk * dX[:, None], U[:, None] + tk * dU[:, None])
        t_best, fval = _best_of_halvings(f_t, fval, ts)
        Xa = Xa + t_best[:, None, None, None] * dX
        U = U + t_best[:, None, None, None] * dU
    return Xa[..., :xdim], U, dict(obj=fval)


def riccati_barrier_solve_np(base_args, reg_args, u_l, u_u, x_l, x_u, Nc: int,
                             method: str = "squareplus", alpha: float = 1.0, beta: float = 1.0,
                             settings: Optional[Dict[str, Any]] = None,
                             device=None) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """The Riccati smooth Newton on one problem, numpy in and out (the
    long-horizon route of ``smooth_cstr="squareplus"``): (X, U, data with
    solver_state and obj); ``newton_iters`` (25) and ``ls_steps`` (25) from
    ``settings``. The tensors go to ``device``, the card by default."""
    settings = settings or {}
    dev = default_device() if device is None else torch.device(device)
    reg_x, reg_u, slew_reg, slew_reg0, slew_um1 = reg_args
    f = np.asarray(base_args[1])
    M, N, xdim = f.shape
    udim = np.asarray(base_args[3]).shape[-1]
    tdt = _torch_dtype(f)
    T = lambda a: torch.as_tensor(np.array(a), dtype=tdt, device=dev)[None]
    has_u = u_l is not None or u_u is not None
    has_x = x_l is not None or x_u is not None
    has_slew = bool(np.any(np.asarray(slew_reg) != 0) or np.any(np.asarray(slew_reg0) != 0))

    def bnd(b, d, fill):
        if b is None:
            return torch.full((1, M, N, d), fill, dtype=tdt, device=dev)
        return T(np.broadcast_to(np.asarray(b).reshape(-1, N, d), (M, N, d)))

    X, U, stats = riccati_barrier_core(
        *(T(a) for a in base_args), T(reg_x), T(reg_u),
        bnd(u_l, udim, -np.inf), bnd(u_u, udim, np.inf),
        bnd(x_l, xdim, -np.inf), bnd(x_u, xdim, np.inf),
        Nc=Nc, method=method, alpha=alpha, beta=beta, has_u=has_u, has_x=has_x,
        has_slew=has_slew, slew_reg=T(slew_reg), slew_reg0=T(slew_reg0),
        slew_um1=T(slew_um1), iters=int(settings.get("newton_iters", 25)),
        ls_steps=int(settings.get("ls_steps", 25)))
    return (X[0].cpu().numpy(), U[0].cpu().numpy(),
            dict(solver_state=settings.get("solver_state"), obj=float(stats["obj"][0])))
