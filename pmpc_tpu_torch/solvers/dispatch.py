"""Affine-solve method dispatch: route one linearized consensus MPC instance
to the right solver of the port.

Twin of ``pmpc_tpu/solvers/dispatch.py``, every route in the JAX function's
order and under the same conditions:
- linear-only extras, and per-stage control-norm SOC extras with linear rows,
  stay structured (the rows border the arrow or Riccati Newton system, the
  cones become ``u_soc_r``);
- CVaR (``k``), other extras, ``Hf``, and control cones under smoothing build
  the composed cone program (`compose.composed_cone_solve`), in
  ``cone_dtype`` (float64 by default);
- a ``diff_cost_fn`` takes the smooth path (`barrier.barrier_solve_np`);
- ``method="riccati"``, or no method at N >= ``riccati_auto_N`` (240) when
  the Riccati route can express the problem, takes the O(N) stage-structured
  route (`riccati_ipm.riccati_ipm_solve_np`, the Riccati smooth Newton, or
  the unconstrained `riccati.riccati_consensus_solve`);
- no inequality: the unconstrained condensed solve (`reduced.solve_eq`);
- logbarrier smoothing: the IPM stopped on the central path at
  mu = 1/alpha (or the named smooth solvers); squareplus: the smooth Newton;
- else the condensed box IPM (`ipm.ipm_solve_np`).

numpy in, numpy out. Everything runs on ``device`` (the card when None;
`utils.default_device` raises without one) under full-precision f32
matmuls; the composed cone programs run on ``settings["cone_device"]`` where
it names one. No route falls back to the host when a device call fails.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import default_device, full_matmul_precision
from .reduced import CondensedQP, assemble_condensed, particle_H_q, recover_XU, solve_eq

SMOOTH_SOLVERS = ("BFGS", "LBFGS", "CVX", "SQP")


@full_matmul_precision
def affine_solve_np(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
    reg_x, reg_u, slew_reg, slew_reg0, slew_um1,
    u_l, u_u, x_l, x_u,
    Nc: int,
    settings: Optional[Dict[str, Any]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Solve one joint M-particle affine problem; returns numpy (X (M, N, xdim),
    U (M, N, udim), data). The arrays are the JAX function's (the dtype is
    f's); ``device`` places every solve but the composed cone programs'
    (``cone_device``, else ``device``)."""
    settings = settings or {}
    dev = default_device() if device is None else torch.device(device)
    N = f.shape[1]
    M = f.shape[0]

    weights = settings.get("weights", None)
    weights = np.asarray(weights, dtype=f.dtype) if weights is not None else None

    diff_cost_fn = settings.get("diff_cost_fn", None)
    smooth_cstr = settings.get("smooth_cstr", None)
    smooth_alpha = settings.get("smooth_alpha", None)
    if smooth_alpha is not None and (
        isinstance(smooth_alpha, float) and np.isnan(smooth_alpha)
    ):
        smooth_cstr, smooth_alpha = "", None  # NaN sentinel: smoothing NOT requested
    if smooth_alpha is not None and smooth_cstr is None:
        smooth_cstr = "logbarrier"

    extra_cstrs = settings.get("extra_cstrs", None)
    u_soc_r = settings.get("u_soc_r", None)  # per-stage ||u_j|| <= r cones
    has_ineq = (any(z is not None for z in (u_l, u_u, x_l, x_u))
                or bool(extra_cstrs) or u_soc_r is not None)

    k = settings.get("k", None)
    has_cvar = k is not None and int(k) >= 0 and int(k) != M
    Hf = settings.get("Hf", None)

    # LINEAR-only extras (no SOC/exp rows, no aux variables, no cost terms)
    # combined with nothing conic stay STRUCTURED: the rows border the arrow
    # (or Riccati) Newton system instead of densifying the whole program
    # through the composed cone path; logbarrier smoothing included (the
    # central-path stop at mu = 1/alpha smooths the rows with the boxes).
    # Squareplus keeps extras EXACT on the composed path.
    ex_lin = None
    ex_consumed = False  # every extras row absorbed by a structured path
    if extra_cstrs and not has_cvar and Hf is None \
            and smooth_cstr in (None, "", "logbarrier") \
            and diff_cost_fn is None \
            and bool(settings.get("extras_structured", True)) \
            and str(settings.get("solver", "")).upper() not in SMOOTH_SOLVERS:
        from .extras import _canon_extras

        udim_ = fu.shape[-1]
        xdim_ = f.shape[-1]
        Nc_ = Nc if Nc >= 0 else N
        n_full = Nc_ * udim_ + M * (N - Nc_) * udim_ + M * N * xdim_
        try:
            sig_ex, arr_ex = _canon_extras(extra_cstrs, n_full)
        except (ValueError, AssertionError):
            sig_ex, arr_ex = None, None
        if sig_ex is not None and all(
                q == () and e == 0 and na == 0 for (_, q, e, na) in sig_ex) \
                and all(np.all(np.asarray(a[3]) == 0.0) for a in arr_ex):
            ex_lin = (np.concatenate([a[0] for a in arr_ex], axis=0),
                      np.concatenate([a[2] for a in arr_ex]))
            ex_consumed = True
        elif sig_ex is not None and smooth_cstr in (None, ""):
            # SOC blocks that are per-stage control-norm cones plus linear
            # rows: the cones become u_soc_r on the structured IPM. Not under
            # smoothing (the reference smooths box and extras rows together
            # there, main.jl:301-316)
            from .extras import split_stage_u_cones

            Nc_eff = Nc if Nc >= 0 else N
            det = split_stage_u_cones(sig_ex, arr_ex, M, N, Nc_eff, udim_)
            if det is not None:
                r_det, lg, lh = det
                if u_soc_r is not None:
                    r_det = np.minimum(
                        np.broadcast_to(np.asarray(u_soc_r, float), (M, N)),
                        r_det)
                u_soc_r = r_det
                settings = dict(settings, u_soc_r=r_det)
                ex_lin = (lg, lh) if lg.shape[0] else None
                ex_consumed = True

    # the composed dense cone program handles every combination the
    # reference's lcone_solve builds in one conic program (main.jl:204-317):
    # k-worst epigraph, extras, Hf, smoothing of box + extras' linear rows,
    # and per-stage control-norm cones under smoothing
    needs_compose = (has_cvar or (bool(extra_cstrs) and not ex_consumed)
                     or Hf is not None
                     or (u_soc_r is not None
                         and smooth_cstr in ("logbarrier", "squareplus")))
    if needs_compose:
        if has_cvar and Hf is not None:
            # a cross-particle terminal cost cannot be attributed to a single
            # particle's epigraph cone; the reference cannot compose these
            # either (Hf exists only on its QP path, lqp_utils.jl:105-163)
            raise NotImplementedError(
                "k (CVaR) combined with Hf is not supported: the "
                "cross-particle terminal cost has no per-particle epigraph")
        if settings.get("diff_cost_fn") is not None:
            # arbitrary differentiable costs need the smooth solvers, which
            # cannot enforce cone programs
            raise NotImplementedError(
                "diff_cost_fn cannot be combined with extra_cstrs/Hf/k: the "
                "cone path has no smooth-objective hook")
        if str(settings.get("solver", "")).upper() in SMOOTH_SOLVERS:
            raise NotImplementedError(
                "named smooth solvers (BFGS/LBFGS/CVX/SQP) cannot solve cone "
                "programs (extra_cstrs/Hf/k); use the default cone IPM")
        from .compose import COST_ANCHOR_EPS, CvarParts, composed_cone_solve
        from .cvar import particle_constants
        from .extras import terminal_cross_cost

        xdim = f.shape[-1]
        udim = fu.shape[-1]
        alpha = smooth_alpha if smooth_alpha is not None else 1.0
        beta = settings.get("smooth_beta", 1.0)
        # the cone programs square conditioning, so they run in float64 by
        # default (the reference's cone solvers are f64); the card has f64
        cdt = np.dtype(settings.get("cone_dtype", np.float64))
        tdt = torch.float64 if cdt == np.float64 else torch.float32
        want = settings.get("cone_device", "auto")
        cdev = dev if want in (None, "auto") else torch.device(want)
        cast = lambda a: torch.as_tensor(np.array(a), dtype=tdt, device=cdev)[None]
        cvar = None
        if has_cvar:
            if weights is not None:
                # particle weights scale each particle's cost terms before
                # the k-worst epigraph program is built (main.jl:202-204 via
                # scale_probs_cost!, main.jl:96-112)
                wv = weights / np.sum(weights)
                wq = wv[:, None, None, None]
                Q, R = np.asarray(Q) * wq, np.asarray(R) * wq
                reg_x, reg_u = np.asarray(reg_x) * wv, np.asarray(reg_u) * wv
                slew_reg = np.asarray(slew_reg) * wv
                slew_reg0 = np.asarray(slew_reg0) * wv
                if bool(settings.get("weights_scale_slew_target", True)):
                    slew_um1 = np.asarray(slew_um1) * wv[:, None]
            H_per, q_per, Ft, g = particle_H_q(
                *(cast(a) for a in (x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                                    reg_x, reg_u, slew_reg, slew_reg0, slew_um1)))
            nc = Nc * udim
            cqp = CondensedQP(
                Hcc=H_per[:, :, :nc, :nc].sum(1), Hcf=H_per[:, :, :nc, nc:],
                Hff=H_per[:, :, nc:, nc:], qc=q_per[:, :, :nc].sum(1), qf=q_per[:, :, nc:],
                Ft=Ft, g=g, w_prev=cast(U_prev).reshape(1, M, -1),
                Qt=None, Rt=None, sl_reg=None, sl_reg0=None)
            c_per = particle_constants(
                g[0].cpu().numpy(), X_prev, U_prev, Q, R, X_ref, U_ref,
                reg_x, reg_u, slew_reg0, slew_um1)
            eps = float(settings.get("cost_anchor_eps", COST_ANCHOR_EPS))
            cvar = CvarParts(H_per=H_per, q_per=q_per, c_per=cast(c_per), k=float(k), eps=eps)
        else:
            cqp = assemble_condensed(
                *(cast(a) for a in (x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                                    reg_x, reg_u, slew_reg, slew_reg0, slew_um1)),
                Nc=Nc, weights=cast(weights) if weights is not None else None,
                scale_slew_target=bool(settings.get("weights_scale_slew_target", True)))
        H_extra = q_extra = None
        if Hf is not None:
            H_extra, q_extra = terminal_cross_cost(
                cqp, N=N, xdim=xdim, Hf=Hf, hf=settings.get("hf", None))
        return composed_cone_solve(
            cqp, N=N, udim=udim, xdim=xdim,
            u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u,
            extra_cstrs=extra_cstrs or [], settings=settings,
            H_extra=H_extra, q_extra=q_extra,
            u_soc_r=u_soc_r,
            smooth_method=smooth_cstr or "",
            smooth_alpha=alpha, smooth_beta=beta,
            cvar=cvar,
        )

    base_args = (x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref)
    reg_args = (reg_x, reg_u, slew_reg, slew_reg0, slew_um1)

    if u_soc_r is not None and (
        diff_cost_fn is not None
        or str(settings.get("solver", "")).upper() in SMOOTH_SOLVERS
    ):
        # smoothing combinations route through the composed cone program
        # above; only genuinely smooth-objective solves remain incompatible
        # with exact cones
        raise NotImplementedError(
            "u_soc_r cones cannot be combined with smooth-objective solves "
            "(diff_cost_fn / named BFGS/LBFGS/CVX/SQP solvers)"
        )

    if diff_cost_fn is not None:
        # an arbitrary additive differentiable cost: the smooth path with
        # L-BFGS; box constraints smoothed as the reference's GPU solver does
        from .barrier import barrier_solve_np

        alpha = float(smooth_alpha if smooth_alpha is not None else 1e2)
        return barrier_solve_np(
            base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
            method=smooth_cstr if smooth_cstr in ("logbarrier", "squareplus")
            else "logbarrier",
            alpha=alpha, beta=float(settings.get("smooth_beta", 1.0)),
            settings=settings, extra_obj=diff_cost_fn, device=dev,
        )

    method_s = str(settings.get("method", "")).lower()
    want_riccati = method_s == "riccati"
    if not method_s:
        # automatic long-horizon routing: the O(N^2) condensation overflows in
        # float32 around N ~ 240, where the O(N) stage-structured path also
        # wins on time. Eligible problems go there; what the Riccati route
        # cannot express stays condensed. settings["method"] overrides.
        auto_N = int(settings.get("riccati_auto_N", 240))
        eligible = (
            # LINEAR-only extras border the Riccati Newton system; stage
            # control-norm SOC extras became u_soc_r cones (both ex_consumed)
            (not extra_cstrs or ex_consumed)
            # logbarrier = central-path stop on the stage-structured IPM;
            # squareplus = the Riccati smooth Newton
            and (not smooth_cstr
                 or smooth_cstr in ("logbarrier", "squareplus"))
            and diff_cost_fn is None
            and str(settings.get("solver", "")).upper() not in SMOOTH_SOLVERS
        )
        if N >= auto_N and eligible:
            want_riccati = True
    if want_riccati and weights is not None:
        # the stage-structured path takes weights by pre-scaling the
        # per-particle costs (scale_probs_cost!, main.jl:96-112): the
        # theta-consensus sum then weights itself
        w = weights / np.sum(weights)
        wq = w[:, None, None, None]
        Q, R = np.asarray(Q) * wq, np.asarray(R) * wq
        reg_x, reg_u = np.asarray(reg_x) * w, np.asarray(reg_u) * w
        slew_reg = np.asarray(slew_reg) * w
        slew_reg0 = np.asarray(slew_reg0) * w
        if bool(settings.get("weights_scale_slew_target", True)):
            slew_um1 = np.asarray(slew_um1) * w[:, None]
        base_args = base_args[:6] + (Q, R) + base_args[8:]
        reg_args = (reg_x, reg_u, slew_reg, slew_reg0, slew_um1)
    has_slew = bool(np.any(np.asarray(slew_reg) != 0)
                    or np.any(np.asarray(slew_reg0) != 0))

    if want_riccati and has_ineq:
        # box bounds (control and state), per-stage control-norm cones,
        # linear extras and logbarrier smoothing: the stage-structured IPM;
        # squareplus: the Riccati smooth Newton
        if (extra_cstrs and not ex_consumed) \
                or (smooth_cstr
                    and smooth_cstr not in ("logbarrier", "squareplus")):
            raise NotImplementedError(
                "method='riccati' supports box bounds, u_soc_r cones, "
                "LINEAR extras, logbarrier and squareplus smoothing; "
                "SOC/exp/aux extras need the condensed path")
        if smooth_cstr == "squareplus":
            from .barrier import riccati_barrier_solve_np

            return riccati_barrier_solve_np(
                base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc,
                method="squareplus",
                alpha=float(smooth_alpha if smooth_alpha is not None else 1.0),
                beta=float(settings.get("smooth_beta", 1.0)),
                settings=settings, device=dev)
        st = settings
        if smooth_cstr == "logbarrier":
            alpha = float(smooth_alpha if smooth_alpha is not None else 1.0)
            st = dict(settings, mu_target=1.0 / alpha)
        udim = fu.shape[-1]
        if u_l is None:  # one-sided bounds: absent side at -inf/+inf
            u_l = np.full((M, N, udim), -np.inf, dtype=f.dtype)
        if u_u is None:
            u_u = np.full((M, N, udim), np.inf, dtype=f.dtype)
        from .riccati_ipm import riccati_ipm_solve_np

        return riccati_ipm_solve_np(
            base_args, reg_args, u_l, u_u, Nc=Nc, settings=st,
            x_l=x_l, x_u=x_u, u_soc_r=u_soc_r,
            ex_G=ex_lin[0] if ex_lin is not None else None,
            ex_h=ex_lin[1] if ex_lin is not None else None, device=dev)

    if not has_ineq:
        T = lambda a: torch.as_tensor(np.array(a, dtype=f.dtype), device=dev)[None]
        if want_riccati:
            from .riccati import riccati_consensus_solve

            slew_kw = {}
            if has_slew:
                slew_kw = dict(slew_reg=T(reg_args[2]), slew_reg0=T(reg_args[3]),
                               slew_um1=T(reg_args[4]))
            X, U = riccati_consensus_solve(
                *(T(a) for a in base_args), T(reg_args[0]), T(reg_args[1]), Nc=Nc, **slew_kw)
        else:
            cqp = assemble_condensed(
                *(T(a) for a in base_args), *(T(a) for a in reg_args), Nc=Nc,
                weights=T(weights) if weights is not None else None,
                scale_slew_target=bool(settings.get("weights_scale_slew_target", True)))
            uc, uf = solve_eq(cqp)
            X, U = recover_XU(cqp, uc, uf, N=N)
        return (X[0].cpu().numpy(), U[0].cpu().numpy(),
                dict(solver_state=settings.get("solver_state")))

    if smooth_cstr == "logbarrier":
        alpha = float(smooth_alpha if smooth_alpha is not None else 1.0)
        if str(settings.get("solver", "")).upper() in SMOOTH_SOLVERS:
            # the named smooth solvers on the smoothed objective
            from .barrier import barrier_solve_np

            return barrier_solve_np(
                base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
                method="logbarrier", alpha=alpha,
                beta=float(settings.get("smooth_beta", 1.0)), settings=settings,
                device=dev,
            )
        # the logbarrier-smoothed problem's solution is the central-path point
        # at mu = 1/alpha of the same box QP (the extras' linear rows in the
        # same flat product family): the IPM with a mu floor
        from .ipm import ipm_solve_np

        return ipm_solve_np(
            base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc,
            weights=weights,
            settings=dict(settings, mu_target=1.0 / alpha),
            ex_G=ex_lin[0] if ex_lin is not None else None,
            ex_h=ex_lin[1] if ex_lin is not None else None, device=dev,
        )

    if smooth_cstr == "squareplus":
        from .barrier import barrier_solve_np

        return barrier_solve_np(
            base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
            method="squareplus",
            alpha=float(smooth_alpha if smooth_alpha is not None else 1.0),
            beta=float(settings.get("smooth_beta", 1.0)),
            settings=settings, device=dev,
        )

    from .ipm import ipm_solve_np

    return ipm_solve_np(
        base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
        settings=settings,
        ex_G=ex_lin[0] if ex_lin is not None else None,
        ex_h=ex_lin[1] if ex_lin is not None else None, device=dev,
    )
