"""The SCP loop: linearize -> condensed assembly -> box IPM (or the
unconstrained solve) -> recover -> Anderson acceleration -> early exit, over
a batch of scenarios.

Twin of ``pmpc_tpu/jax_scp.py`` for ``method="condensed"`` with control and
state boxes. The JAX solver takes one (M, ...) problem and is batched with
``jax.vmap``; this solver takes the batch itself, (B, M, ...) arrays, and
every per-scenario quantity (iteration count, residual, done flag, AA
window) is a (B, ...) tensor.

Usage:
    solver = build_scp_solver(dynamics, N=30, xdim=4, udim=2, M=32, Nc=5,
                              max_it=25, has_u_bounds=True, accel="AA")
    X, U, info = solver(data)   # data: SCPData of (B, M, ...) tensors
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .dynamics import linearize
from .solvers.ipm import BoxBounds, ipm_core
from .solvers.reduced import assemble_condensed, recover_XU, solve_eq
from .utils import default_device, lane_where, matmul_precision_scope


class SCPData(NamedTuple):
    """Joint M-particle SCP problem instances; leading axes (..., M), and
    (B, M) for the solver."""

    x0: torch.Tensor  # (..., M, xdim)
    Q: torch.Tensor  # (..., M, N, xdim, xdim)
    R: torch.Tensor  # (..., M, N, udim, udim)
    X_ref: torch.Tensor  # (..., M, N, xdim)
    U_ref: torch.Tensor  # (..., M, N, udim)
    X_prev: torch.Tensor  # (..., M, N, xdim)
    U_prev: torch.Tensor  # (..., M, N, udim)
    reg_x: torch.Tensor  # (..., M)
    reg_u: torch.Tensor  # (..., M)
    slew_reg: torch.Tensor  # (..., M)
    slew_reg0: torch.Tensor  # (..., M)
    slew_um1: torch.Tensor  # (..., M, udim)
    u_l: torch.Tensor  # (..., M, N, udim)  (+-inf where absent)
    u_u: torch.Tensor  # (..., M, N, udim)
    x_l: torch.Tensor  # (..., M, N, xdim)
    x_u: torch.Tensor  # (..., M, N, xdim)
    params: Any = None  # (..., M, P) per-particle dynamics parameters
    u_soc_r: Any = None  # per-stage control-norm radii: not ported


def make_scp_data(
    x0, Q, R,
    X_ref=None, U_ref=None, X_prev=None, U_prev=None,
    reg_x=1.0, reg_u=1e-2, slew_reg=0.0, slew_reg0=0.0, slew_um1=None,
    u_l=None, u_u=None, x_l=None, x_u=None, params=None, dtype=None,
    device=None,
) -> SCPData:
    """Constructor with reference-compatible defaults. Every field lands on
    ``device`` in ``dtype`` (that of ``Q`` when None). With ``device=None``
    the device is that of the first tensor among ``Q``, ``R``, ``x0``; when
    none of them is a tensor it is the card (`utils.default_device`, which
    raises where there is none)."""
    if device is None:
        device = next((a.device for a in (Q, R, x0)
                       if isinstance(a, torch.Tensor)), None)
        if device is None:
            device = default_device()
    Q = torch.as_tensor(Q, dtype=dtype, device=device)
    dt, dev = Q.dtype, Q.device
    R = torch.as_tensor(R, dtype=dt, device=dev)
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    lead, (N, xdim) = Q.shape[:-3], Q.shape[-3:-1]
    udim = R.shape[-1]

    def arr(v, shape, fill=0.0):
        if v is None:
            return torch.full(shape, fill, dtype=dt, device=dev)
        return torch.as_tensor(v, dtype=dt, device=dev).expand(shape).clone()

    X_ref = arr(X_ref, lead + (N, xdim))
    U_ref = arr(U_ref, lead + (N, udim))
    return SCPData(
        x0=x0, Q=Q, R=R, X_ref=X_ref, U_ref=U_ref,
        X_prev=arr(X_prev, lead + (N, xdim)) if X_prev is not None else X_ref,
        U_prev=arr(U_prev, lead + (N, udim)) if U_prev is not None else U_ref,
        reg_x=arr(reg_x, lead), reg_u=arr(reg_u, lead),
        slew_reg=arr(slew_reg, lead), slew_reg0=arr(slew_reg0, lead),
        slew_um1=arr(slew_um1, lead + (udim,)),
        u_l=arr(u_l, lead + (N, udim), -torch.inf),
        u_u=arr(u_u, lead + (N, udim), torch.inf),
        x_l=arr(x_l, lead + (N, xdim), -torch.inf),
        x_u=arr(x_u, lead + (N, xdim), torch.inf),
        params=None if params is None
        else torch.as_tensor(params, dtype=dt, device=dev),
    )


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"build_scp_solver: {what} is not ported yet ({item})")


def build_scp_solver(
    dynamics: Callable,
    N: int,
    xdim: int,
    udim: int,
    M: int,
    Nc: int = -1,
    max_it: int = 10,
    res_tol: float = 1e-5,
    has_u_bounds: bool = False,
    has_x_bounds: bool = False,
    ipm_iters: int = 20,
    ipm_tol_exp: Optional[int] = None,
    mu_target: float = 0.0,
    kappa: Optional[float] = None,
    lin_cost_fn: Optional[Callable] = None,
    warm_start: bool = True,
    collect_stats: bool = False,
    adaptive_tol: bool = True,
    adaptive_cap: float = 3e-2,
    ipm_gondzio: int = 0,
    ipm_predictor: bool = True,
    ipm_tau: Optional[float] = None,
    has_u_soc: bool = False,
    method: str = "condensed",
    return_state: bool = False,
    accel: str = "",
    accel_window: int = 5,
    accel_it0: int = 2,
    accel_wmax: float = 50.0,
    relin_stale: int = 0,
) -> Callable:
    """Build the batched SCP solver for fixed problem dimensions.

    ``dynamics`` is a torch step ``f(x (xdim,), u (udim,)) -> (xdim,)``, or
    ``f(x, u, p (P,))`` when the data carries per-particle ``params``
    (B, M, P), which are mapped with the particles and not differentiated.
    ``has_u_bounds=False`` ignores the control bounds in the data; with no
    bounds at all the subproblem is the unconstrained solve (`solve_eq`).
    ``lin_cost_fn(X_prev, U_prev, data) -> (cx, cu)`` linearizes an extra
    cost at the current iterate; here it receives the batched (B, M, ...)
    tensors (the JAX solver hands it one (M, ...) problem) and its
    gradients (or None) shift the references by ``Q^-1 cx`` / ``R^-1 cu``.
    ``collect_stats=True`` runs all ``max_it`` iterations (no early exit)
    and adds ``info["scan_stats"]``: ipm_iters, resid and, with bounds,
    ipm_failed, ipm_converged, accepted, each (B, max_it).
    ``accel="AA"`` is Type-II Anderson acceleration of the SCP fixed point:
    the next linearization point combines the last ``accel_window``
    subproblem solutions; the RETURNED solution is always the last accepted
    raw subproblem solution (bound-feasible).

    Returns ``solver(data, state=None) -> (X (B,M,N+1,xdim), U (B,M,N,udim),
    info)`` with ``info`` keys iters, resid, converged, resid_particle (and
    solver_state with ``return_state``), each with a leading B axis.
    """
    if method != "condensed":
        _unsupported(f"method={method!r}", "ROADMAP §1.7")
    if has_u_soc:
        _unsupported("SOC cones", "ROADMAP §1.4")
    if relin_stale:
        _unsupported("relin_stale", "ROADMAP §1.11")
    if ipm_gondzio or not ipm_predictor or mu_target > 0:
        _unsupported("ipm_gondzio, ipm_predictor=False and mu_target > 0",
                     "ROADMAP §1.4")
    if accel not in ("", "AA"):
        raise ValueError(f"unknown accel {accel!r} (use '' or 'AA')")
    Nc = Nc if Nc >= 0 else N
    if M == 1:
        Nc = 0  # single particle: consensus is a no-op; keep stage structure
    has_bounds = has_u_bounds or has_x_bounds
    AW = int(accel_window)
    nc, nx = Nc * udim, M * N * xdim
    # `jax_scp.hot_matmul_precision` needs no twin: every core here already
    # runs IEEE f32 matmuls with TF32 off (`matmul_precision_scope`)

    def _aa_combine(histF, histZ, nh, Fk, Zk):
        """Type-II Anderson weights over each lane's valid window (masked
        fixed-size buffers; the (AW-1)^2 normal system is tiny). Returns the
        combined flat iterate (B, n_flat) and its total weight mass (B,)."""
        dt = Fk.dtype
        ar = torch.arange(AW - 1, device=Fk.device)
        valid = (ar[None, :] >= (AW - nh)[:, None]).to(dt)  # older slots
        D = (histF[:, :-1] - Fk[:, None, :]) * valid[..., None]  # (B, AW-1, n)
        G = D @ D.mT
        rhs = -(D @ Fk[..., None])[..., 0]
        eps = 1e-6 * (G.diagonal(dim1=-2, dim2=-1).sum(-1) / (AW - 1) + 1e-30)
        eye = torch.eye(AW - 1, dtype=dt, device=Fk.device)
        # solve_ex: a singular or non-finite system gives inf/NaN weights
        # (rejected below), not an exception
        theta = torch.linalg.solve_ex(G + eps[:, None, None] * eye, rhs)[0]
        theta = theta * valid
        w_last = 1.0 - theta.sum(-1)
        Z_acc = (theta[:, None, :] @ histZ[:, :-1])[:, 0] + w_last[:, None] * Zk
        wmass = theta.abs().sum(-1) + w_last.abs()
        return Z_acc, wmass

    def iteration(data: SCPData, carry):
        X_prev, U_prev, it, done, resid, resid_m, warm, acc = carry
        B = X_prev.shape[0]
        X_ = torch.cat([data.x0[:, :, None, :], X_prev[:, :, :-1, :]], dim=2)
        f, fx, fu = linearize(dynamics, X_, U_prev, data.params)
        X_ref, U_ref = data.X_ref, data.U_ref
        if lin_cost_fn is not None:
            cx, cu = lin_cost_fn(X_prev, U_prev, data)
            if cx is not None:
                X_ref = X_ref - torch.linalg.solve(data.Q, cx[..., None])[..., 0]
            if cu is not None:
                U_ref = U_ref - torch.linalg.solve(data.R, cu[..., None])[..., 0]
        cqp = assemble_condensed(
            data.x0, f, fx, fu, X_prev, U_prev, data.Q, data.R,
            X_ref, U_ref, data.reg_x, data.reg_u, data.slew_reg,
            data.slew_reg0, data.slew_um1, Nc=Nc)
        dt = cqp.qf.dtype
        stats = None
        if has_bounds:
            ul = data.u_l.reshape(B, M, N * udim)
            uu = data.u_u.reshape(B, M, N * udim)
            bounds = BoxBounds(lo_c=ul[:, 0, :nc], hi_c=uu[:, 0, :nc],
                               lo_f=ul[:, :, nc:], hi_f=uu[:, :, nc:],
                               lo_x=data.x_l.reshape(B, M, N * xdim),
                               hi_x=data.x_u.reshape(B, M, N * xdim))
            f64 = dt == torch.float64
            # inexact-Newton forcing: early SCP iterations only need a loose
            # subproblem solve; the tolerance tightens with the SCP residual
            tol_dyn = None
            if adaptive_tol:
                r = torch.clamp(resid, max=1e3)  # resid starts at +inf
                tol_dyn = torch.clamp(1e-3 * r * r, 0.0, adaptive_cap).to(dt)
            uc, uf, stats = ipm_core(
                cqp, bounds, has_u=has_u_bounds, has_x=has_x_bounds,
                iters=ipm_iters,
                tol_exp=ipm_tol_exp if ipm_tol_exp is not None else (-8 if f64 else -6),
                kappa=kappa if kappa is not None else (0.0 if f64 else 1e-7),
                warm=warm, tol_dynamic=tol_dyn, tau=ipm_tau)
            warm_new = (uc, uf, stats["s"], stats["lam"]) if warm_start else warm
        else:
            uc, uf = solve_eq(cqp)
            warm_new = warm
        X, U = recover_XU(cqp, uc, uf, N=N)

        dX, dU = X - X_prev, U - U_prev
        # per-particle residuals (B, M); the scenario's residual is their max
        resid_m_new = torch.maximum(
            torch.linalg.vector_norm(dX, dim=-1).amax(-1),
            torch.linalg.vector_norm(dU, dim=-1).amax(-1))
        new_resid = resid_m_new.amax(-1)
        # a non-finite solution, or a gave-up IPM (its iterate has no
        # feasibility guarantee), is rejected: keep the last accepted iterate
        bad = ~torch.isfinite(new_resid)
        if has_bounds:
            bad = bad | stats["failed"]
        now_done = (new_resid < res_tol) & ~bad

        freeze = done | bad
        X_lin, U_lin = X, U
        acc_out = acc
        if accel:
            histF, histZ, nh, X_sol, U_sol = acc
            Fk = torch.cat([dX.reshape(B, -1), dU.reshape(B, -1)], -1)
            Zk = torch.cat([X.reshape(B, -1), U.reshape(B, -1)], -1)
            histF_n = torch.roll(histF, -1, dims=1)
            histF_n[:, -1] = Fk
            histZ_n = torch.roll(histZ, -1, dims=1)
            histZ_n[:, -1] = Zk
            nh_n = torch.clamp(nh + 1, max=AW)
            Z_acc, wmass = _aa_combine(histF_n, histZ_n, nh_n, Fk, Zk)
            use = ((it + 1 >= accel_it0) & (nh_n >= 2)
                   & (wmass < accel_wmax) & torch.isfinite(wmass) & ~now_done)
            Z_lin = lane_where(use, Z_acc, Zk)
            X_lin = Z_lin[:, :nx].reshape(X.shape)
            U_lin = Z_lin[:, nx:].reshape(U.shape)
            acc_out = tuple(_sel_tree(freeze, old, new) for old, new in zip(
                acc, (histF_n, histZ_n, nh_n, X, U)))
        keep = lambda old, new: _sel_tree(freeze, old, new)
        ys = None
        if collect_stats:
            ys = dict(ipm_iters=stats["iters"] if has_bounds
                      else torch.zeros_like(it), resid=new_resid)
            if has_bounds:
                ys.update(ipm_failed=stats["failed"],
                          ipm_converged=stats["converged"], accepted=~freeze)
        return (keep(X_prev, X_lin), keep(U_prev, U_lin),
                it + torch.where(done, 0, 1).to(it.dtype), done | now_done,
                keep(resid, new_resid), keep(resid_m, resid_m_new),
                keep(warm, warm_new), acc_out), ys

    def init_warm_acc(data: SCPData, state=None):
        B = data.x0.shape[0]
        dt, dev = data.Q.dtype, data.Q.device
        warm0 = None
        if has_bounds and warm_start:
            if state is not None:
                warm0 = tuple(state)
            else:
                # neutral warm point for the first iteration: primal from
                # U_prev, slacks/multipliers at the cold-start heuristics
                # (state rows exist in the flat layout only with state boxes)
                nf = (N - Nc) * udim
                mtot = 2 * nc + 2 * M * nf \
                    + (2 * M * N * xdim if has_x_bounds else 0)
                Uflat = data.U_prev.reshape(B, M, -1)
                s_w = torch.ones((B, mtot), dtype=dt, device=dev)
                warm0 = (Uflat[:, :, :nc].mean(1), Uflat[:, :, nc:], s_w, s_w)
        acc0 = None
        if accel:
            n_flat = M * N * (xdim + udim)
            acc0 = (torch.zeros((B, AW, n_flat), dtype=dt, device=dev),
                    torch.zeros((B, AW, n_flat), dtype=dt, device=dev),
                    torch.zeros(B, dtype=torch.int32, device=dev),
                    data.X_prev, data.U_prev)
        return warm0, acc0

    def solver(data: SCPData, state=None):
        """``state``: the IPM warm tuple a previous call returned in
        ``info["solver_state"]`` (built with ``return_state=True``)."""
        if data.u_soc_r is not None:
            _unsupported("SOC radii (u_soc_r)", "ROADMAP §1.4")
        with matmul_precision_scope():
            B = data.x0.shape[0]
            dt, dev = data.Q.dtype, data.Q.device
            warm0, acc0 = init_warm_acc(data, state)
            carry = (data.X_prev, data.U_prev,
                     torch.zeros(B, dtype=torch.int32, device=dev),
                     torch.zeros(B, dtype=torch.bool, device=dev),
                     torch.full((B,), torch.inf, dtype=dt, device=dev),
                     torch.full((B, M), torch.inf, dtype=dt, device=dev),
                     warm0, acc0)
            ys = []
            if collect_stats:
                # the fixed-length `lax.scan`: converged lanes freeze in place
                for _ in range(max_it):
                    carry, y = iteration(data, carry)
                    ys.append(y)
            else:
                # early exit, as `jax.vmap(lax.while_loop)` runs it: iterate
                # while any lane is active; inactive lanes keep their carry
                while True:
                    active = ~carry[3] & (carry[2] < max_it)
                    if not bool(active.any()):
                        break
                    new, _ = iteration(data, carry)
                    carry = tuple(_sel_tree(active, n, o)
                                  for n, o in zip(new, carry))
            X, U, it, done, resid, resid_m, warm_fin, acc_fin = carry
            if accel:
                # the last accepted RAW subproblem solution: feasible to IPM
                # tolerance, unlike the AA combination used for linearization
                X, U = acc_fin[3], acc_fin[4]
            X_traj = torch.cat([data.x0[:, :, None, :], X], dim=2)
            info = dict(iters=it, resid=resid, converged=resid < res_tol,
                        resid_particle=resid_m)
            if collect_stats:
                info["scan_stats"] = {k: torch.stack([y[k] for y in ys], dim=1)
                                      for k in ys[0]}
            if return_state:
                info["solver_state"] = warm_fin
            return X_traj, U, info

    def lane_refill(*args, **kwargs):
        _unsupported("init_carry/run_chunk/extract (lane refill)", "ROADMAP §1.5")

    solver.init_carry = solver.run_chunk = solver.extract = lane_refill
    return solver


def _sel_tree(cond, a, b):
    """`lane_where(cond, a, b)` over a tensor or a tuple of tensors (None
    passes through)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(lane_where(cond, x, y) for x, y in zip(a, b))
    return lane_where(cond, a, b)
