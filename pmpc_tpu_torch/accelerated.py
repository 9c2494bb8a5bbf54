"""Momentum-accelerated SCP loop over the port's `scp.scp_solve`.

Twin of ``pmpc_tpu/accelerated.py`` (the reference's ``pmpc/accelerated.py``):
each outer step extrapolates the linearization point beyond the latest SCP
iterate (Nesterov-style over-relaxation) and runs a single SCP iteration from
there, threading ``solver_state`` through so warm starts survive across steps.

The extrapolation is ``z + MOMENTUM * (z - z_old)``, equivalently the
over-relaxed combination ``(1 + MOMENTUM) z - MOMENTUM z_old``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .scp import HIST_FIELDS, HIST_FMTS, print_fn, scp_solve
from .utils import TablePrinter

#: over-relaxation strength; the reference uses alf=1.6, i.e. momentum 0.6
MOMENTUM = 0.6


def momentum_update(zk, zkm1, it):
    """Extrapolated linearization point (``it`` unused; kept for API parity)."""
    return zk + MOMENTUM * (zk - zkm1)


def accelerated_scp_solve(
    f_fx_fu_fn,
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
    verbose: bool = True,
    debug: bool = False,
    max_it: int = 100,
    time_limit: float = 1000.0,
    res_tol: float = 1e-5,
    reg_x: float = 1e0,
    reg_u: float = 1e-2,
    slew_rate: float = 0.0,
    u_slew: Optional[np.ndarray] = None,
    cost_fn=None,
    lin_cost_fn=None,
    solver_settings: Optional[Dict[str, Any]] = None,
    solver_state: Optional[Dict[str, Any]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """``scp_solve``'s arguments; every subproblem runs on ``device`` (the
    card when None)."""
    assert x0.ndim == 2 and Q.ndim == 4 and R.ndim == 4, "batched (M, ...) arrays required"
    M, N, xdim = Q.shape[:3]
    udim = R.shape[-1]

    def traj(given, ref, d):
        arr = given if given is not None else ref
        return np.zeros((M, N, d)) if arr is None else np.asarray(arr, float).reshape((M, N, d))

    X_ref = traj(X_ref, None, xdim)
    U_ref = traj(U_ref, None, udim)
    # (previous, current) linearization points; equal at startup so the first
    # extrapolation is a no-op
    X_pair = (traj(X_prev, X_ref, xdim),) * 2
    U_pair = (traj(U_prev, U_ref, udim),) * 2

    table = TablePrinter(list(HIST_FIELDS), fmts=list(HIST_FMTS))
    clock_start = time.time()
    merged: Dict[str, Any] = {}
    X = U = None
    if verbose:
        print_fn(table.make_header())

    for it in range(max_it):
        X_lin = momentum_update(X_pair[1], X_pair[0], it)
        U_lin = momentum_update(U_pair[1], U_pair[0], it)

        X, U, step_data = scp_solve(
            f_fx_fu_fn, Q, R, x0,
            X_ref=X_ref, U_ref=U_ref, X_prev=X_lin, U_prev=U_lin,
            x_l=x_l, x_u=x_u, u_l=u_l, u_u=u_u,
            verbose=False, debug=debug,
            max_it=1, time_limit=float("inf"), res_tol=0.0,
            reg_x=reg_x, reg_u=reg_u,
            slew_rate=slew_rate, u0_slew=u_slew,
            cost_fn=cost_fn, lin_cost_fn=lin_cost_fn,
            solver_settings=solver_settings, solver_state=solver_state,
            device=device,
        )
        if X is None:
            return None, None, None

        X_pair = (X_lin, X[:, 1:, :])
        U_pair = (U_lin, U)

        # carry the inner solver's warm-start state into the next outer step
        inner = (step_data.get("solver_data") or [{}])[-1] or {}
        solver_state = inner.get("solver_state", None)

        for key, val in step_data.items():
            merged.setdefault(key, []).extend(val)

        last = merged["hist"][-1]
        if verbose:
            row = (it + 1, time.time() - clock_start, last["obj"], last["resid"],
                   last["reg_x"], last["reg_u"])
            print_fn(table.make_values(row))
        if last["resid"] < res_tol:
            break
        elapsed = time.time() - clock_start
        if elapsed + elapsed / (it + 1) > time_limit:
            break

    if verbose:
        print_fn(table.make_footer())
    return X, U, merged
