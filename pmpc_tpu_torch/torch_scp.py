"""The SCP loop: linearize -> subproblem solve -> Anderson acceleration ->
early exit, over a batch of scenarios. The subproblem goes one of three
ways: ``method="condensed"`` (condensed assembly -> box IPM or the
unconstrained solve -> recover), ``method="riccati"`` (the O(N) stage sweeps
of `solvers.riccati` / `solvers.riccati_ipm`, which never build the O(N^2)
condensed map and carry slew coupling by state augmentation) or
``method="priccati"`` (the same without bounds as associative scans of
O(log N) depth, `solvers.priccati`; with bounds the Riccati IPM).

Twin of ``pmpc_tpu/jax_scp.py``. The JAX solver takes one (M, ...) problem
and is batched with ``jax.vmap``; this solver takes the batch itself,
(B, M, ...) arrays, and every per-scenario quantity (iteration count,
residual, done flag, AA window) is a (B, ...) tensor. The loop is built from
the three lane-refill pieces the solver carries, ``init_carry``,
``run_chunk`` and ``extract`` (`stream.solve_stream` drives them).

Usage:
    solver = build_scp_solver(dynamics, N=30, xdim=4, udim=2, M=32, Nc=5,
                              max_it=25, has_u_bounds=True, accel="AA")
    X, U, info = solver(data)   # data: SCPData of (B, M, ...) tensors
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import graphs
from .dynamics import linearize
from .particles import global_particles, pany, pfirst, pmax, pmean, psum, \
    particle_scope
from .solvers.ipm import BoxBounds, ipm_core, layout_socs
from .solvers.priccati import priccati_consensus_solve
from .solvers.reduced import assemble_condensed, recover_XU, solve_eq, \
    update_condensed_linear
from .solvers.riccati import riccati_consensus_solve
from .solvers.riccati_ipm import riccati_ipm_solve_scp
from .tracing import COUNTS, span
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
    u_soc_r: Any = None  # (..., M, N) per-stage control-norm radii (+inf: no cone)


def make_scp_data(
    x0, Q, R,
    X_ref=None, U_ref=None, X_prev=None, U_prev=None,
    reg_x=1.0, reg_u=1e-2, slew_reg=0.0, slew_reg0=0.0, slew_um1=None,
    u_l=None, u_u=None, x_l=None, x_u=None, params=None, u_soc_r=None,
    dtype=None, device=None,
) -> SCPData:
    """Constructor with reference-compatible defaults. ``u_soc_r`` (radii of
    the per-stage cones ||u_j|| <= r, broadcast to (..., M, N); +inf: no
    cone) stays None when not given. Every field lands on
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
        u_soc_r=None if u_soc_r is None else arr(u_soc_r, lead + (N,)),
    )


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
    ipm_fresh_retry: bool = False,
    has_u_soc: bool = False,
    method: str = "condensed",
    has_slew: bool = False,
    return_state: bool = False,
    accel: str = "",
    accel_window: int = 5,
    accel_it0: int = 2,
    accel_wmax: float = 50.0,
    relin_stale: int = 0,
    riccati_unroll: Optional[int] = None,
    particle_group=None,
) -> Callable:
    """Build the batched SCP solver for fixed problem dimensions.

    ``dynamics`` is a torch step ``f(x (xdim,), u (udim,)) -> (xdim,)``, or
    ``f(x, u, p (P,))`` when the data carries per-particle ``params``
    (B, M, P), which are mapped with the particles and not differentiated.
    ``has_u_bounds=False`` ignores the control bounds in the data; with no
    bounds and no cones the subproblem is the unconstrained solve
    (`solve_eq`). ``has_u_soc=True`` adds the per-stage cones
    ||u_j|| <= r_j of ``data.u_soc_r`` (the data must carry them; without
    the flag they are ignored); the IPM warm tuple then carries the cone
    slacks and duals (sq, zq) as its 5th and 6th entries. A lane whose IPM
    gives up keeps its last accepted iterate, so its next round re-solves
    the same subproblem; as in the JAX solver, it starts from the warm start
    that gave up, which can give up again every round to ``max_it``.
    ``ipm_fresh_retry=True`` starts that round from the same primal point
    with fresh slacks and multipliers instead (ones, the cones at the unit
    point), which departs from the JAX solver on such lanes alone.
    ``ipm_gondzio`` (that many centrality correctors an IPM iteration, kept
    where they lengthen the step; without cones), ``ipm_predictor=False``
    (one Newton solve an IPM iteration, the LOQO centering rule) and
    ``mu_target > 0`` (stop on the central path at that duality measure)
    reach the condensed IPM; of them the Riccati IPM takes ``mu_target``
    and refuses the other two.
    ``lin_cost_fn(X_prev, U_prev, data) -> (cx, cu)`` linearizes an extra
    cost at the current iterate; here it receives the batched (B, M, ...)
    tensors (the JAX solver hands it one (M, ...) problem) and its
    gradients (or None) shift the references by ``Q^-1 cx`` / ``R^-1 cu``.
    ``collect_stats=True`` runs all ``max_it`` iterations (no early exit)
    and adds ``info["scan_stats"]``: ipm_iters, resid and, with bounds,
    ipm_failed, ipm_converged, accepted, each (B, max_it).
    ``method="riccati"`` solves every subproblem by O(N) stage sweeps instead
    of the condensed arrow system (the route for long horizons). Slew terms
    in the data reach it only behind the static ``has_slew`` flag (the
    augmented sweep costs (xdim + 2 udim)^3 per stage, so it is opt-in);
    with the flag off and slew terms present the result is poisoned with NaN
    (the iterate freezes and the lane reports not converged) rather than
    silently wrong. The condensed method always carries the slew terms and
    ignores the flag. ``riccati_unroll`` is taken for signature parity and
    has no effect (it tunes the JAX package's scans).
    ``accel="AA"`` is Type-II Anderson acceleration of the SCP fixed point:
    the next linearization point combines the last ``accel_window``
    subproblem solutions; the RETURNED solution is always the last accepted
    raw subproblem solution (bound-feasible).
    ``method="priccati"`` runs the unbounded subproblem as associative scans
    (`solvers.priccati`, O(log N) depth); with bounds it takes the Riccati
    IPM, as the JAX `build_scp_solver` does. It refuses state boxes and cones, and
    without bounds slew coupling (``NotImplementedError``, the JAX messages).
    ``relin_stale=k`` (condensed only) follows each fresh SCP iteration by k
    stale-Jacobian sub-iterations: they keep (f, fx, fu), the affine map and
    the Hessian blocks of the last assembly and refresh only q
    (`reduced.update_condensed_linear`); the iteration count counts
    sub-steps, so ``max_it`` bounds the subproblem solves (the test runs
    between super-iterations, so a lane can overshoot it by k).
    ``particle_group``: a `torch.distributed` group over which each
    problem's particles are spread, ``M`` of them on this rank (what
    `parallel.make_sharded_solver` builds); every reduction over particles
    is completed over the group (`particles`).

    On a CUDA device, with the condensed method and no particle group, the
    fresh sub-iteration's linearization and condensed assembly run as a CUDA
    graph, captured once a shape (at its second sighting) and replayed: the
    dynamics' kernels are recorded, not its Python. So Python-level
    constants the function closes over are read at the capture, while
    tensors it closes over are read at each replay (an in-place update of
    weights is seen). This is the JAX solver's contract too: ``jax.jit``
    traces the dynamics once a shape. A dynamics the capture refuses (one
    that reads the device on the host, say) runs eagerly.

    Returns ``solver(data, state=None) -> (X (B,M,N+1,xdim), U (B,M,N,udim),
    info)`` with ``info`` keys iters, resid, converged, resid_particle (and
    solver_state with ``return_state``), each with a leading B axis. The
    solver carries the lane-refill pieces it is built from:
    ``init_carry(data, state=None)`` (the loop's carry), ``run_chunk(data,
    carry, n_it=1, max_it=None)`` (``n_it`` iterations; converged, frozen
    and capped lanes do not move) and ``extract(data, carry)`` (the
    solver's return contract), with ``max_it`` and ``rebuild(**changes)``
    (this call of `build_scp_solver` with some arguments changed; ``build_args`` holds
    the call's arguments but ``dynamics``).
    """
    build_args = {k: v for k, v in locals().items() if k != "dynamics"}
    if method not in ("condensed", "riccati", "priccati"):
        raise ValueError(f"unknown method {method!r}")
    if method == "priccati" and (has_x_bounds or has_u_soc):
        raise NotImplementedError(
            "method='priccati' does not support state boxes or SOC cones; "
            "use method='riccati'")
    if relin_stale and method != "condensed":
        raise ValueError(
            "relin_stale (stale-Jacobian sub-iterations) is only supported "
            "with method='condensed'")
    if not ipm_predictor and method != "condensed":
        # the riccati stage-structured IPM always runs Mehrotra: silently
        # ignoring the flag would misreport the A/B being requested
        raise ValueError(
            "ipm_predictor=False is only supported with method='condensed' "
            "(the riccati IPM has no single-solve mode)")
    if ipm_gondzio and method != "condensed":
        # the stage-structured IPM has no Gondzio correctors (the JAX
        # `build_scp_solver` drops the flag there silently; ROADMAP §3 F6)
        raise ValueError("ipm_gondzio is only supported with method='condensed'")
    if accel not in ("", "AA"):
        raise ValueError(f"unknown accel {accel!r} (use '' or 'AA')")
    Nc = Nc if Nc >= 0 else N
    if global_particles(M, particle_group) == 1:
        Nc = 0  # single particle: consensus is a no-op; keep stage structure
    has_bounds = has_u_bounds or has_x_bounds or has_u_soc
    if method == "priccati" and has_slew and not has_bounds:
        raise NotImplementedError(
            "method='priccati' does not support slew coupling; "
            "use method='riccati'")
    AW = int(accel_window)
    nc, nx = Nc * udim, M * N * xdim
    riccati = method in ("riccati", "priccati")
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
        G = psum(D @ D.mT)
        rhs = psum(-(D @ Fk[..., None])[..., 0])
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
        """One SCP iteration: linearize at the carry's iterate, then the
        fresh sub-iteration and ``relin_stale`` stale ones that reuse the
        linearization (and the condensed map and Hessian blocks). The
        condensed method linearizes inside its fresh sub-iteration, together
        with the assembly (`lin_assemble`)."""
        with span("scp.iter"):
            lin = None
            if riccati:
                X_ = torch.cat([data.x0[:, :, None, :], carry[0][:, :, :-1, :]], dim=2)
                with span("scp.linearize"):
                    lin = linearize(dynamics, X_, carry[1], data.params)
            carry, ys, cqp = _sub_iteration(data, carry, lin, None)
            for _ in range(relin_stale):
                carry, ys, cqp = _sub_iteration(data, carry, lin, cqp)
            return carry, ys

    def lin_assemble(x0, X_prev, U_prev, params, Q, R, X_ref, U_ref, reg_x, reg_u,
                     slew_reg, slew_reg0, slew_um1):
        """The condensed method's fresh sub-iteration up to its QP: the
        linearization at (X_prev, U_prev) and the condensed assembly.
        Returns (f, fx, fu, cqp)."""
        X_ = torch.cat([x0[:, :, None, :], X_prev[:, :, :-1, :]], dim=2)
        with span("scp.linearize"):
            f, fx, fu = linearize(dynamics, X_, U_prev, params)
        with span("scp.assemble"):
            cqp = assemble_condensed(
                x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u,
                slew_reg, slew_reg0, slew_um1, Nc=Nc)
        return f, fx, fu, cqp

    lin_graphs = _LinGraphs(lin_assemble)

    def _sub_iteration(data: SCPData, carry, lin, cqp_prev):
        X_prev, U_prev, it, done, resid, resid_m, warm, acc = carry
        B = X_prev.shape[0]
        X_ref, U_ref = data.X_ref, data.U_ref
        if lin_cost_fn is not None:
            cx, cu = lin_cost_fn(X_prev, U_prev, data)
            if cx is not None:
                X_ref = X_ref - torch.linalg.solve(data.Q, cx[..., None])[..., 0]
            if cu is not None:
                U_ref = U_ref - torch.linalg.solve(data.R, cu[..., None])[..., 0]
        dt = data.Q.dtype
        f64 = dt == torch.float64
        stats = None
        ipm_kw = {}
        if has_bounds:
            # inexact-Newton forcing: early SCP iterations only need a loose
            # subproblem solve; the tolerance tightens with the SCP residual
            tol_dyn = None
            if adaptive_tol:
                r = torch.clamp(resid, max=1e3)  # resid starts at +inf
                tol_dyn = torch.clamp(1e-3 * r * r, 0.0, adaptive_cap).to(dt)
            ipm_kw = dict(
                iters=ipm_iters,
                tol_exp=ipm_tol_exp if ipm_tol_exp is not None else (-8 if f64 else -6),
                kappa=kappa if kappa is not None else (0.0 if f64 else 1e-7),
                warm=warm, tol_dynamic=tol_dyn, tau=ipm_tau, mu_target=mu_target)
        if riccati:
            # O(N) stage-structured solve: no O(N^2) Ft, the consensus Schur
            # complement is a per-particle theta-quadratic sum
            slew_kw, poison = {}, None
            f, fx, fu = lin
            if has_slew:
                slew_kw = dict(slew_reg=data.slew_reg, slew_reg0=data.slew_reg0,
                               slew_um1=data.slew_um1)
            else:
                # a silent drop of slew terms would return wrong solutions:
                # poison the lane instead (the NaN contract freezes the
                # iterate and reports not-converged)
                slew_present = pmax((data.slew_reg.amax(-1) > 0)
                                    | (data.slew_reg0.amax(-1) > 0))
                poison = torch.where(slew_present, torch.nan, 1.0).to(dt)[:, None, None, None]
            if has_bounds:
                xbox_kw = dict(x_l=data.x_l, x_u=data.x_u) if has_x_bounds else {}
                if has_u_soc:
                    xbox_kw["u_soc_r"] = data.u_soc_r
                u_l = data.u_l if has_u_bounds else torch.full_like(data.u_l, -torch.inf)
                u_u = data.u_u if has_u_bounds else torch.full_like(data.u_u, torch.inf)
                X, U, stats = riccati_ipm_solve_scp(
                    data.x0, f, fx, fu, X_prev, U_prev, data.Q, data.R, X_ref, U_ref,
                    data.reg_x, data.reg_u, u_l, u_u, Nc=Nc, **ipm_kw, **slew_kw,
                    **xbox_kw)
                warm_new = (stats["theta"], stats["uf"], stats["s"], stats["lam"]) \
                    + ((stats["sq"], stats["zq"]) if has_u_soc else ()) \
                    if warm_start else warm
            else:
                # priccati: the same subproblem by associative scans (it
                # takes no slew terms: refused at build time)
                consensus = priccati_consensus_solve if method == "priccati" \
                    else riccati_consensus_solve
                X, U = consensus(
                    data.x0, f, fx, fu, X_prev, U_prev, data.Q, data.R, X_ref, U_ref,
                    data.reg_x, data.reg_u, Nc=Nc, **slew_kw)
                warm_new = warm
            if poison is not None:
                X, U = X * poison, U * poison
        else:
            if cqp_prev is None:
                # on the card a replayed graph's outputs: the next fresh
                # sub-iteration overwrites them (`_LinGraphs`)
                cqp = lin_graphs(
                    (data.x0, X_prev, U_prev, data.params, data.Q, data.R, X_ref, U_ref,
                     data.reg_x, data.reg_u, data.slew_reg, data.slew_reg0, data.slew_um1),
                    _lin_engages(data.Q.device.type, method, particle_group))[3]
            else:  # a stale sub-iteration: only q moves
                with span("scp.assemble"):
                    cqp = update_condensed_linear(
                        cqp_prev, X_prev, U_prev, data.Q, data.R, X_ref, U_ref,
                        data.reg_x, data.reg_u, data.slew_reg0, data.slew_um1)
            if has_bounds:
                ul = data.u_l.reshape(B, M, N * udim)
                uu = data.u_u.reshape(B, M, N * udim)
                # the consensus bounds follow particle 0 (on the group's
                # first rank when the particles are spread)
                bounds = BoxBounds(lo_c=pfirst(ul[:, 0, :nc]), hi_c=pfirst(uu[:, 0, :nc]),
                                   lo_f=ul[:, :, nc:], hi_f=uu[:, :, nc:],
                                   lo_x=data.x_l.reshape(B, M, N * xdim),
                                   hi_x=data.x_u.reshape(B, M, N * xdim))
                uc, uf, stats = ipm_core(
                    cqp, bounds, has_u=has_u_bounds, has_x=has_x_bounds,
                    socs=layout_socs(data.u_soc_r, Nc) if has_u_soc else None,
                    has_soc=has_u_soc, gondzio=ipm_gondzio, predictor=ipm_predictor,
                    **ipm_kw)
                warm_new = (uc, uf, stats["s"], stats["lam"]) \
                    + ((stats["sq"], stats["zq"]) if has_u_soc else ()) \
                    if warm_start else warm
            else:
                uc, uf = solve_eq(cqp)
                warm_new = warm
            X, U = recover_XU(cqp, uc, uf, N=N)

        dX, dU = X - X_prev, U - U_prev
        # per-particle residuals (B, M); the scenario's residual is their max
        resid_m_new = torch.maximum(
            torch.linalg.vector_norm(dX, dim=-1).amax(-1),
            torch.linalg.vector_norm(dU, dim=-1).amax(-1))
        new_resid = pmax(resid_m_new.amax(-1))
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
            with span("scp.accel"):
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
        warm_out = keep(warm, warm_new)
        if has_bounds and warm_start and ipm_fresh_retry:
            # an IPM that gave up leaves its lane where it was, so the next
            # round solves the same subproblem again: from the warm start that
            # gave up it can give up again, every round to max_it. The retry
            # keeps the primal point and starts the slacks and multipliers afresh
            warm_out = _sel_tree(bad & ~done, _fresh_duals(warm_out), warm_out)
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
                warm_out, acc_out), ys, None if riccati else cqp

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
                # the stage-structured IPM pads theta to at least one entry
                nct = max(nc, 1) if riccati else nc
                mtot = 2 * nct + 2 * M * nf \
                    + (2 * M * N * xdim if has_x_bounds else 0)
                Uflat = data.U_prev.reshape(B, M, -1)
                s_w = torch.ones((B, mtot), dtype=dt, device=dev)
                uc_w = torch.zeros((B, nct), dtype=dt, device=dev)
                uc_w[:, :nc] = pmean(Uflat[:, :, :nc], 1)
                warm0 = (uc_w, Uflat[:, :, nc:], s_w, s_w)
                if has_u_soc:  # the cones' slacks and duals at the unit point
                    e0 = torch.zeros((B, Nc + M * (N - Nc), udim + 1), dtype=dt, device=dev)
                    e0[..., 0] = 1.0
                    warm0 = warm0 + (e0, e0)
        acc0 = None
        if accel:
            n_flat = M * N * (xdim + udim)
            acc0 = (torch.zeros((B, AW, n_flat), dtype=dt, device=dev),
                    torch.zeros((B, AW, n_flat), dtype=dt, device=dev),
                    torch.zeros(B, dtype=torch.int32, device=dev),
                    data.X_prev, data.U_prev)
        return warm0, acc0

    @contextlib.contextmanager
    def scope():
        with matmul_precision_scope(), particle_scope(particle_group):
            yield

    def init_carry(data: SCPData, state=None):
        """The loop's carry for a batch of problems (``state``: a previous
        call's ``info["solver_state"]``): the lane-refill serving loop
        re-initializes only the rows of lanes that take a new problem."""
        if has_u_soc and data.u_soc_r is None:
            raise ValueError("has_u_soc=True needs the cone radii data.u_soc_r")
        with scope():
            B = data.x0.shape[0]
            dt, dev = data.Q.dtype, data.Q.device
            warm0, acc0 = init_warm_acc(data, state)
            return (data.X_prev, data.U_prev,
                    torch.zeros(B, dtype=torch.int32, device=dev),
                    torch.zeros(B, dtype=torch.bool, device=dev),
                    torch.full((B,), torch.inf, dtype=dt, device=dev),
                    torch.full((B, M), torch.inf, dtype=dt, device=dev),
                    warm0, acc0)

    def step(data: SCPData, carry, cap: Optional[int]):
        new, ys = iteration(data, carry)
        if cap is None:  # done and frozen lanes keep their carry in `iteration`
            return new, ys
        # as `jax.vmap(lax.while_loop)` runs it: lanes at the cap keep theirs
        active = ~carry[3] & (carry[2] < cap)
        return tuple(_sel_tree(active, n, o) for n, o in zip(new, carry)), ys

    def run_chunk(data: SCPData, carry, n_it: int = 1, max_it: Optional[int] = None):
        """Advance every lane by ``n_it`` SCP iterations with no host read of
        the SCP loop (an IPM still tests its own loop once an iteration).
        Converged and frozen lanes do not move, nor, with ``max_it``, lanes
        at that count; without it, as the JAX ``run_chunk``, the solver's
        own ``max_it`` is no cap (the stream retires a lane at its budget)."""
        with scope():
            for _ in range(n_it):
                carry, _ = step(data, carry, max_it)
            return carry

    def extract(data: SCPData, carry):
        """(X_traj, U, info) from a carry: the solver's return contract."""
        X, U, it, done, resid, resid_m, warm_fin, acc_fin = carry
        if accel:
            # the last accepted RAW subproblem solution: feasible to IPM
            # tolerance, unlike the AA combination used for linearization
            X, U = acc_fin[3], acc_fin[4]
        X_traj = torch.cat([data.x0[:, :, None, :], X], dim=2)
        info = dict(iters=it, resid=resid, converged=resid < res_tol,
                    resid_particle=resid_m)
        if return_state:
            info["solver_state"] = warm_fin
        return X_traj, U, info

    def solver(data: SCPData, state=None):
        """``state``: the IPM warm tuple a previous call returned in
        ``info["solver_state"]`` (built with ``return_state=True``)."""
        with span("scp.call"), scope():
            carry = init_carry(data, state)
            ys = []
            if collect_stats:
                # the fixed-length `lax.scan`: converged lanes freeze in place
                for _ in range(max_it):
                    carry, y = step(data, carry, None)
                    ys.append(y)
            else:
                # early exit, as `jax.vmap(lax.while_loop)` runs it: iterate
                # while any lane is active (one host read an iteration)
                while pany(~carry[3] & (carry[2] < max_it)):
                    carry = run_chunk(data, carry, 1, max_it)
            X_traj, U, info = extract(data, carry)
            if collect_stats:
                info["scan_stats"] = {k: torch.stack([y[k] for y in ys], dim=1)
                                      for k in ys[0]}
            return X_traj, U, info

    solver.init_carry, solver.run_chunk, solver.extract = init_carry, run_chunk, extract
    solver.max_it, solver.build_args = max_it, build_args
    solver.rebuild = lambda **changes: build_scp_solver(dynamics, **{**build_args, **changes})
    return solver


def _fresh_duals(warm):
    """An IPM warm tuple (uc, uf, s, lam[, sq, zq]) with its slacks and
    multipliers at the first round's neutral point: ones, and the cones'
    at the unit point e = (1; 0)."""
    ones = torch.ones_like(warm[2])
    if len(warm) == 4:
        return (warm[0], warm[1], ones, ones)
    e = torch.zeros_like(warm[4])
    e[..., 0].fill_(1.0)
    return (warm[0], warm[1], ones, ones, e, e)


def _sel_tree(cond, a, b):
    """`lane_where(cond, a, b)` over a tensor or a tuple of tensors (None
    passes through)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(lane_where(cond, x, y) for x, y in zip(a, b))
    return lane_where(cond, a, b)


# -- the fresh sub-iteration's linearization and assembly as CUDA graphs -------

def _lin_engages(device_type: str, method: str, group) -> bool:
    """Whether a fresh sub-iteration replays its linearization and condensed
    assembly as a captured graph (`_LinGraphs`): with the condensed method,
    where `graphs.engages` holds."""
    return method == "condensed" and graphs.engages(device_type, group)


LIN_GRAPH_CACHE = 2  # captured graphs a solver keeps (`graphs` says why)


class _LinGraphs:
    """One built solver's ``lin_assemble(*ins) -> (f, fx, fu, cqp)``, run
    eagerly or, where the engage rule holds, as captured CUDA graphs
    (`graphs.Captured`) keyed by `graphs.key`; a key whose capture raised (a
    dynamics that reads the device on the host, say) runs eagerly for the
    solver's life.

    A replay writes its outputs over the last replay's, so the caller holds
    them for one SCP round: the subproblem solve (the IPM's graph copies the
    QP in, the eager IPM and `solve_eq` read it within the round),
    `recover_XU` (fresh X, U) and the round's stale sub-iterations
    (`update_condensed_linear` keeps its map and Hessian blocks). No carry,
    ``collect_stats`` row or ``return_state`` tuple holds any of them."""

    def __init__(self, fn):
        self.fn = fn
        self.cache = graphs.Cache(LIN_GRAPH_CACHE, "scp.capture", "lin_graph_capture")

    def __call__(self, ins: tuple, engage: bool):
        graph = self.cache.get(graphs.key(ins), lambda: graphs.Captured(self.fn, ins)) \
            if engage else None
        if graph is None:
            return self.fn(*ins)
        with span("scp.linearize"):
            graph.copy_in(ins)
        with span("scp.assemble"):
            out = graph.replay()
        COUNTS["lin_graph_replay"] += 1
        return out
