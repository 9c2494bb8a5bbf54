"""SCP outer loop of the host frontend: linearize, augment the cost, solve the
affine consensus subproblem, filter and bookkeep.

Twin of ``pmpc_tpu/scp.py``, with the reference SCP loop's behaviour
(``pmpc/scp_mpc.py:205-442``): linearize (user callback) -> augment cost ->
affine consensus solve (`solvers.dispatch.affine_solve_np`, on the card)
-> residual bookkeeping, solution filtering (AA/smooth/select),
min-violation tracking, the NaN failure contract, the ``ipm_failed`` reject
contract, time-limit/residual stopping, the verbose iteration table and the
``data`` dict contract (``hist``, ``solver_data``, ``t_aff_solve``,
``sol_hist`` under ``debug``, ``f32_stall_suspected``).

The loop is a canonicalized problem record (`_SCPProblem`) plus a mutable
loop state (`_LoopState`); each iteration runs linearize -> solve -> filter
-> bookkeeping through small helpers.
"""

from __future__ import annotations

import dataclasses
import math
import time
from copy import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .utils import TablePrinter, atleast_nd, default_device, default_dtype, numpy_dtype
from . import filters as _filters

print_fn = print

HIST_FIELDS = ("it", "elaps", "obj", "resid", "reg_x", "reg_u")
HIST_FMTS = ("%04d", "%8.3e", "%8.3e", "%8.3e", "%8.3e", "%8.3e")


# -- affine solve dispatcher -------------------------------------------------------


def _bound_given(b) -> bool:
    """One side of a box bound is in effect (reference drops a side whose
    array contains NaN — the sentinel encoding, c_interface.jl:56-63)."""
    if b is None:
        return False
    b = np.asarray(b, dtype=float)
    return b.size > 0 and not np.any(np.isnan(b))


def _bounds_present(lo, hi) -> bool:
    """Either side present activates the group; the absent side is filled
    with +-inf downstream (one-sided bounds used to be silently DROPPED)."""
    return _bound_given(lo) or _bound_given(hi)


def aff_solve(
    f: np.ndarray,
    fx: np.ndarray,
    fu: np.ndarray,
    x0: np.ndarray,
    X_prev: np.ndarray,
    U_prev: np.ndarray,
    Q: np.ndarray,
    R: np.ndarray,
    X_ref: np.ndarray,
    U_ref: np.ndarray,
    reg_x: float,
    reg_u: float,
    slew_rate: Optional[float],
    u_slew: Optional[np.ndarray],
    x_l: Optional[np.ndarray],
    x_u: Optional[np.ndarray],
    u_l: Optional[np.ndarray],
    u_u: Optional[np.ndarray],
    solver_settings: Optional[Dict[str, Any]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Any]:
    """Solve one linearized consensus MPC instance. Returns (X (M,N+1,xdim), U, data).

    Argument order/semantics match the reference ``aff_solve``
    (``pmpc/scp_mpc.py:78-98``); ``solver_settings`` carries the open config
    dict (solver, Nc, smooth_cstr/alpha/beta, extra_cstrs, weights, coerce, k,
    verbose, solver_state, dtype) like ``pmpc/static_backend.py:242-276``.
    The working dtype is ``solver_settings["dtype"]`` (a numpy or torch
    dtype), else `utils.default_dtype`; the solve runs on ``device`` (the
    card when None).
    """
    from .solvers.dispatch import affine_solve_np

    ss = copy(solver_settings) if solver_settings is not None else dict()
    dtype = numpy_dtype(ss.get("dtype", default_dtype()))

    f = atleast_nd(np.asarray(f), 3)
    fx, fu = atleast_nd(np.asarray(fx), 4), atleast_nd(np.asarray(fu), 4)
    x0 = atleast_nd(np.asarray(x0), 2)
    X_prev, U_prev = atleast_nd(np.asarray(X_prev), 3), atleast_nd(np.asarray(U_prev), 3)
    Q, R = atleast_nd(np.asarray(Q), 4), atleast_nd(np.asarray(R), 4)
    X_ref, U_ref = atleast_nd(np.asarray(X_ref), 3), atleast_nd(np.asarray(U_ref), 3)
    M, N, xdim = f.shape
    udim = fu.shape[-1]

    has_u_bounds = _bounds_present(u_l, u_u)
    has_x_bounds = _bounds_present(x_l, x_u)

    def _side(b, shape, fill):
        if not _bound_given(b):
            return np.broadcast_to(np.asarray(fill, dtype=float), shape).copy()
        return np.broadcast_to(
            atleast_nd(np.asarray(b, dtype=float), 3), shape).copy()

    if has_u_bounds:
        u_l = _side(u_l, (M, N, udim), -np.inf)
        u_u = _side(u_u, (M, N, udim), np.inf)
    else:
        u_l = u_u = None
    if has_x_bounds:
        x_l = _side(x_l, (M, N, xdim), -np.inf)
        x_u = _side(x_u, (M, N, xdim), np.inf)
    else:
        x_l = x_u = None

    # slew encoding parity with static_backend.py:262-272 / c_interface.jl:64-70:
    # - slew_rate couples consecutive controls (slew_reg),
    # - u_slew anchors the first control with weight slew_reg0
    #   (defaults to solver_settings["slew_reg"] like the static backend,
    #    falling back to slew_rate).
    slew_reg = float(slew_rate) if slew_rate is not None else 0.0
    if u_slew is not None:
        slew_reg0 = float(ss.get("slew_reg0", ss.get("slew_reg", slew_reg)))
        slew_um1 = np.broadcast_to(np.asarray(u_slew, dtype=float), (M, udim)).copy()
    else:
        slew_reg0 = 0.0
        slew_um1 = np.zeros((M, udim))

    Nc = int(ss.get("Nc", -1))
    Nc = Nc if Nc >= 0 else N
    if M == 1:
        # single particle: consensus is semantically a no-op (controls shared
        # with themselves), but the Nc=0 LAYOUT keeps the per-particle block
        # (condensed) / per-stage structure (riccati) instead of one dense
        # consensus block over all N*udim controls — for the O(N) long-
        # horizon path this is the difference between working and a dense
        # theta solve over the whole horizon
        Nc = 0

    X, U, data = affine_solve_np(
        x0=x0.astype(dtype),
        f=f.astype(dtype),
        fx=fx.astype(dtype),
        fu=fu.astype(dtype),
        X_prev=X_prev.astype(dtype),
        U_prev=U_prev.astype(dtype),
        Q=Q.astype(dtype),
        R=R.astype(dtype),
        X_ref=X_ref.astype(dtype),
        U_ref=U_ref.astype(dtype),
        reg_x=np.broadcast_to(np.asarray(reg_x, dtype=dtype), (M,)),
        reg_u=np.broadcast_to(np.asarray(reg_u, dtype=dtype), (M,)),
        slew_reg=np.full((M,), slew_reg, dtype=dtype),
        slew_reg0=np.full((M,), slew_reg0, dtype=dtype),
        slew_um1=slew_um1.astype(dtype),
        u_l=None if u_l is None else u_l.astype(dtype),
        u_u=None if u_u is None else u_u.astype(dtype),
        x_l=None if x_l is None else x_l.astype(dtype),
        x_u=None if x_u is None else x_u.astype(dtype),
        Nc=Nc,
        settings=ss,
        device=device,
    )
    X_traj = np.concatenate([np.asarray(x0)[:, None, :], np.asarray(X)], axis=-2)
    return X_traj, np.asarray(U), data


# -- cost augmentation (role of pmpc/scp_mpc.py:171-185) ---------------------------


def _augment_cost(lin_cost_fn, X_prev, U_prev, Q, R, X_ref, U_ref, problems):
    """Fold a linearized nonconvex cost into the tracking references.

    A linear cost term c'x added to 0.5(x-x_ref)'Q(x-x_ref) is equivalent to
    shifting the reference by -Q^{-1}c; same for controls."""
    if lin_cost_fn is None:
        return X_ref, U_ref
    cx, cu = lin_cost_fn(X_prev, U_prev, problems)

    def shifted(ref, weight, c):
        if c is None:
            return ref
        shift = np.linalg.solve(weight, np.asarray(c)[..., None])[..., 0]
        return ref - shift

    return shifted(X_ref, Q, cx), shifted(U_ref, R, cu)


# -- canonicalized problem + loop state --------------------------------------------


@dataclasses.dataclass
class _SCPProblem:
    """All solve inputs, canonicalized to batched (M, ...) numpy arrays."""

    f_fx_fu_fn: Callable
    Q: np.ndarray  # (M, N, xdim, xdim)
    R: np.ndarray  # (M, N, udim, udim)
    x0: np.ndarray  # (M, xdim)
    X_ref: np.ndarray  # (M, N, xdim)
    U_ref: np.ndarray  # (M, N, udim)
    x_l: np.ndarray  # (M, N, xdim) or size-0
    x_u: np.ndarray
    u_l: np.ndarray
    u_u: np.ndarray
    reg_x: float
    reg_u: float
    slew_rate: Optional[float]
    u0_slew: Optional[np.ndarray]
    single: bool  # caller passed unbatched arrays; squeeze outputs
    extra_kw: Dict[str, Any]

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        M, N, xdim = self.Q.shape[:3]
        return M, N, xdim, self.R.shape[-1]

    @classmethod
    def build(
        cls, f_fx_fu_fn, Q, R, x0, X_ref, U_ref, x_l, x_u, u_l, u_u,
        reg_x, reg_u, slew_rate, u0_slew, extra_kw,
    ) -> "_SCPProblem":
        x0 = np.array(x0, dtype=float)
        Q, R = np.array(Q, dtype=float), np.array(R, dtype=float)
        single = x0.ndim == 1
        if single:
            assert Q.ndim == 3 and R.ndim == 3, "single-particle arrays must be (N, d, d)"
            Q, R, x0 = Q[None], R[None], x0[None]
            X_ref, U_ref = atleast_nd(X_ref, 3), atleast_nd(U_ref, 3)
            x_l, x_u = atleast_nd(x_l, 3), atleast_nd(x_u, 3)
            u_l, u_u = atleast_nd(u_l, 3), atleast_nd(u_u, 3)
        else:
            assert Q.ndim == 4 and R.ndim == 4, "batched arrays must be (M, N, d, d)"
        M, N, xdim = Q.shape[:3]
        udim = R.shape[-1]

        def ref_or_zero(ref, d):
            if ref is None:
                return np.zeros((M, N, d))
            return np.array(ref, dtype=float).reshape((M, N, d))

        def bound_or_empty(b):
            return np.array(b, dtype=float) if b is not None else np.zeros((0, 0, 0))

        return cls(
            f_fx_fu_fn=f_fx_fu_fn,
            Q=Q, R=R, x0=x0,
            X_ref=ref_or_zero(X_ref, xdim), U_ref=ref_or_zero(U_ref, udim),
            x_l=bound_or_empty(x_l), x_u=bound_or_empty(x_u),
            u_l=bound_or_empty(u_l), u_u=bound_or_empty(u_u),
            reg_x=float(reg_x), reg_u=float(reg_u),
            slew_rate=float(slew_rate) if slew_rate is not None else None,
            u0_slew=np.array(u0_slew, dtype=float) if u0_slew is not None else None,
            single=single,
            extra_kw=dict(extra_kw),
        )

    def callback_context(self, f, fx, fu, X_prev, U_prev) -> Dict[str, Any]:
        """The ``problems`` dict handed to user callbacks (lin_cost_fn /
        extra_cstrs_fns), reference contract ``pmpc/scp_mpc.py:344-350``."""
        ctx = dict(self.extra_kw)
        ctx.update(
            f_fx_fu_fn=self.f_fx_fu_fn, f=f, fx=fx, fu=fu,
            x0=self.x0, X_prev=X_prev, U_prev=U_prev,
            slew_rate=self.slew_rate, u0_slew=self.u0_slew,
            x_l=self.x_l, x_u=self.x_u, u_l=self.u_l, u_u=self.u_u,
            Q=self.Q, R=self.R, X_ref=self.X_ref, U_ref=self.U_ref,
        )
        return ctx


@dataclasses.dataclass
class _LoopState:
    """Mutable SCP iteration state."""

    X_prev: np.ndarray  # (M, N, xdim) current linearization trajectory
    U_prev: np.ndarray  # (M, N, udim)
    solver_state: Any = None
    X: Optional[np.ndarray] = None  # latest solution (M, N+1, xdim)
    U: Optional[np.ndarray] = None
    max_res: float = math.inf
    min_viol: float = math.inf
    it: int = 0
    update_vecs: List[np.ndarray] = dataclasses.field(default_factory=list)  # filter residuals


def _filter_combine(method: str, window: int, update_vecs, sol_hist):
    """Combine the last `window` solutions with filter weights. Returns (X, U)."""
    k = min(window, len(update_vecs))
    weights = _filters.FILTER_MAP[method](update_vecs[-k:])
    recent = sol_hist[-k:]
    X = sum(w * Xi for w, (Xi, _) in zip(weights, recent))
    U = sum(w * Ui for w, (_, Ui) in zip(weights, recent))
    return X, U


def _quad_objective(prob: _SCPProblem, X_tail, U) -> float:
    """Mean tracking cost (x-x_ref)'Q(x-x_ref) + (u-u_ref)'R(u-u_ref)."""
    M, N = prob.Q.shape[:2]
    ex = X_tail - prob.X_ref
    eu = U - prob.U_ref
    cost_x = np.einsum("mni,mnij,mnj->", ex, prob.Q, ex)
    cost_u = np.einsum("mni,mnij,mnj->", eu, prob.R, eu)
    return float(cost_x + cost_u) / N / M


def scp_solve(
    f_fx_fu_fn: Callable,
    Q: np.ndarray,
    R: np.ndarray,
    x0: np.ndarray,
    X_ref: Optional[np.ndarray] = None,
    U_ref: Optional[np.ndarray] = None,
    X_prev: Optional[np.ndarray] = None,
    U_prev: Optional[np.ndarray] = None,
    x_l: Optional[np.ndarray] = None,
    x_u: Optional[np.ndarray] = None,
    u_l: Optional[np.ndarray] = None,
    u_u: Optional[np.ndarray] = None,
    verbose: bool = False,
    debug: bool = False,
    max_it: int = 100,
    time_limit: float = 1000.0,
    res_tol: float = 1e-5,
    reg_x: float = 1e0,
    reg_u: float = 1e-2,
    slew_rate: float = 0.0,
    u0_slew: Optional[np.ndarray] = None,
    lin_cost_fn: Optional[Callable] = None,
    cost_fn: Optional[Callable] = None,  # deprecated
    extra_cstrs_fns: Optional[Callable] = None,
    solver_settings: Optional[Dict[str, Any]] = None,
    solver_state: Optional[Dict[str, Any]] = None,
    filter_method: str = "",
    filter_window: int = 5,
    filter_it0: int = 20,
    return_min_viol: bool = False,
    min_viol_it0: int = -1,
    device=None,
    **extra_kw,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """SCP solution of a nonlinear-dynamics quadratic-cost control problem.

    Signature and semantics are a drop-in for the reference ``scp_solve``
    (``pmpc/scp_mpc.py:205-277``); see that docstring for argument meaning.
    ``f_fx_fu_fn`` is a numpy callback (`dynamics.make_f_fx_fu_fn` wraps a
    torch step); every subproblem is solved on ``device``, the card when
    None (`utils.default_device` raises without one).
    """
    if cost_fn is not None:
        raise ValueError("cost_fn is deprecated, use lin_cost_fn instead.")
    u0_slew = extra_kw.pop("u_slew", u0_slew)  # alias accepted by the reference API
    device = default_device() if device is None else torch.device(device)

    clock_start = time.time()
    prob = _SCPProblem.build(
        f_fx_fu_fn, Q, R, x0, X_ref, U_ref, x_l, x_u, u_l, u_u,
        reg_x, reg_u, slew_rate, u0_slew, extra_kw,
    )
    M, N, xdim, udim = prob.dims

    def as_traj(ref, fallback):
        if ref is None:
            return fallback.copy()
        d = fallback.shape[-1]
        return np.array(ref, dtype=float).reshape((M, N, d))

    st = _LoopState(
        X_prev=as_traj(X_prev, prob.X_ref),
        U_prev=as_traj(U_prev, prob.U_ref),
        solver_state=solver_state,
    )

    settings = copy(solver_settings) if solver_settings is not None else dict()
    # `diff_cost_fn` is accepted as a top-level kwarg too (the reference only
    # supports it on the experimental path, jax_solver.py:77): it is a solver
    # concern, so fold it into the settings dict the backends read — without
    # this it would land in extra_kw and be SILENTLY ignored
    if "diff_cost_fn" in extra_kw:
        settings.setdefault("diff_cost_fn", extra_kw["diff_cost_fn"])
    # `method` likewise (SOLVE_KWS lists it): selects the subproblem solver
    # structure (e.g. "riccati" for the O(N) stage-structured path)
    if "method" in extra_kw:
        settings.setdefault("method", extra_kw["method"])
    data: Dict[str, Any] = dict(solver_data=[], hist=[], sol_hist=[], t_aff_solve=[])
    keep_sol_hist = debug or filter_method != ""
    table = TablePrinter(list(HIST_FIELDS), fmts=list(HIST_FMTS))
    if verbose:
        print_fn(table.make_header())

    while st.it < max_it:
        # 1. linearize dynamics at the current iterate (user callback)
        x_at = np.concatenate([prob.x0[:, None, :], st.X_prev[:, :-1, :]], axis=1)
        f, fx, fu = prob.f_fx_fu_fn(x_at, st.U_prev)
        f = np.asarray(f, dtype=float).reshape((M, N, xdim))
        fx = np.asarray(fx, dtype=float).reshape((M, N, xdim, xdim))
        fu = np.asarray(fu, dtype=float).reshape((M, N, xdim, udim))

        # 2. fold user cost linearization / extra constraints into this solve
        ctx = prob.callback_context(f, fx, fu, st.X_prev, st.U_prev)
        X_ref_it, U_ref_it = _augment_cost(
            lin_cost_fn, st.X_prev, st.U_prev, prob.Q, prob.R, prob.X_ref, prob.U_ref, ctx
        )
        if extra_cstrs_fns is not None:
            settings["extra_cstrs"] = tuple(extra_cstrs_fns(st.X_prev, st.U_prev, ctx))
        settings["solver_state"] = st.solver_state
        # previous-iteration residual: the cone/IPM backends derive an
        # inexact-Newton forcing tolerance from it (same rule as the fused
        # path's adaptive_tol) — early loose solves, tight near convergence
        settings["scp_residual"] = st.max_res

        # 3. affine consensus solve
        t0 = time.time()
        X_new, U_new, solver_data = aff_solve(
            f, fx, fu, prob.x0, st.X_prev, st.U_prev,
            prob.Q, prob.R, X_ref_it, U_ref_it,
            prob.reg_x, prob.reg_u, prob.slew_rate, prob.u0_slew,
            prob.x_l, prob.x_u, prob.u_l, prob.u_u,
            solver_settings=settings, device=device,
        )
        data["t_aff_solve"].append(time.time() - t0)
        st.solver_state = (solver_data or {}).get("solver_state", None)

        # failure contract (pre-NaN): a subproblem solver that reports a hard
        # failure (e.g. a cone IPM stalled far from its central path) returned
        # garbage, not an approximation — reject it instead of re-linearizing
        # around it (mirror of the fused path's reject contract)
        if solver_data and solver_data.get("ipm_failed"):
            data["rejected_subproblem"] = True
            if st.it == 0:
                if verbose:
                    print_fn("Solver failed...")
                return None, None, None
            break  # keep the last accepted iterate

        X_new = np.asarray(X_new).reshape((M, N + 1, xdim))
        U_new = np.asarray(U_new).reshape((M, N, udim))

        # 4. optional solution filtering over the iterate history
        if keep_sol_hist:
            data["sol_hist"].append((X_new, U_new))
        raw_X, raw_U = X_new, U_new
        if filter_method != "":
            full_prev = np.concatenate([prob.x0[:, None, :], st.X_prev], axis=1)
            st.update_vecs.append(np.concatenate(
                [(X_new - full_prev).ravel(), (U_new - st.U_prev).ravel()]
            ))
            if st.it >= filter_it0:
                X_new, U_new = _filter_combine(
                    filter_method, filter_window, st.update_vecs, data["sol_hist"]
                )

        # 5. failure contract: NaN solution aborts the solve
        if not (np.isfinite(X_new).all() and np.isfinite(U_new).all()):
            if verbose:
                print_fn("Solver failed...")
            return None, None, None

        # 6. residual (of the unfiltered update), objective, bookkeeping
        st.max_res = max(
            float(np.linalg.norm(raw_X[:, 1:] - st.X_prev, axis=-1).max()),
            float(np.linalg.norm(raw_U - st.U_prev, axis=-1).max()),
        )
        obj = _quad_objective(prob, X_new[:, 1:], U_new)
        st.X, st.U = X_new, U_new
        st.X_prev, st.U_prev = X_new[:, 1:], U_new
        st.it += 1

        row = (st.it, time.time() - clock_start, obj, st.max_res, prob.reg_x, prob.reg_u)
        if verbose:
            print_fn(table.make_values(row))
        data["solver_data"].append(solver_data)
        data["hist"].append(dict(zip(HIST_FIELDS, row)))

        if return_min_viol and (min_viol_it0 < 0 or st.it - 1 >= min_viol_it0):
            if st.max_res < st.min_viol:
                st.min_viol = st.max_res
                data["min_viol_sol"] = (st.X, st.U)

        # 7. stopping: converged, or the projected time after one more
        #    iteration would exceed the budget
        if st.max_res < res_tol:
            break
        elapsed = time.time() - clock_start
        if elapsed + elapsed / st.it > time_limit:
            break

    if verbose:
        print_fn(table.make_footer())
        if st.max_res > 1e-2:
            banner = "#" * 73
            print_fn(banner)
            print_fn(
                "Bad solution found, the solution is approximate to a residual:",
                "%9.4e" % st.max_res,
            )
            print_fn(banner)
    _flag_f32_stall(data, settings, st.max_res, res_tol)
    if not debug:
        del data["sol_hist"]
    if prob.single:
        return st.X[0], st.U[0], data
    return st.X, st.U, data


def _flag_f32_stall(data, settings, max_res: float, res_tol: float) -> None:
    """Detect the documented float32 failure signature and surface it.

    The f32 accuracy envelope (benchmarks/RESULTS_r2.md) shows hard instances
    where the SCP residual PLATEAUS around 1e-3 — f32 wobble in the
    linearization/condensation moves the subproblem optimum between
    equivalent iterates, so the loop exits at max_it "not converged" with no
    hint that precision (not the problem) is the limiter. Signature: 32-bit
    solve, final residual >= 10x res_tol, and <30%% total residual progress
    over the last 3 iterations. Sets ``data["f32_stall_suspected"]`` and
    warns once (structured, not print: visible at verbose=False)."""
    dtype = numpy_dtype(settings.get("dtype", default_dtype()))
    if dtype != np.float32 or not np.isfinite(max_res):
        return
    resids = [h["resid"] for h in data.get("hist", [])]
    if len(resids) < 4 or max_res < 10.0 * res_tol:
        return
    if resids[-1] > 0.7 * resids[-4]:  # <30% progress over 3 iterations
        data["f32_stall_suspected"] = True
        import warnings

        warnings.warn(
            f"SCP residual plateaued at {max_res:.2e} (res_tol={res_tol:.0e})"
            " in float32 — this matches the f32 precision floor on hard "
            "instances; retry with solver_settings={'dtype': 'float64'}.",
            RuntimeWarning, stacklevel=3)


def solve(*args, **kwargs):
    """Main entry point; optional ``profile=True`` wraps with line_profiler
    (parity with ``pmpc/scp_mpc.py:446-456``)."""
    if kwargs.pop("profile", False):
        try:
            from line_profiler import LineProfiler

            LP = LineProfiler()
            LP.add_function(scp_solve)
            ret = LP.wrap_function(scp_solve)(*args, **kwargs)
            LP.print_stats(output_unit=1e-3)
            return ret
        except ImportError:
            pass
    return scp_solve(*args, **kwargs)


def solve_with_a_dict(problem: Dict[str, Any]) -> tuple:
    return solve(**problem)


def solve_problems_serial(
    problems: List[Dict[str, Any]],
    verbose: bool = False,
    **kw,
) -> List[Tuple[np.ndarray, np.ndarray, Dict[str, Any]]]:
    """Serial fallback batch solve (parity with ``pmpc/scp_mpc.py:504-511``);
    ``kw`` entries override every problem's settings."""
    return [solve(**dict(p, verbose=verbose, **kw)) for p in problems]
