"""Compatibility shim for the reference's experimental GPU API, over the
port's `scp.scp_solve`.

Twin of ``pmpc_tpu/experimental.py``. The reference ships a second,
device-resident solver under ``pmpc.experimental``
(``experimental/jax_solver.py``) with slightly different conventions:
constraints are ALWAYS smoothed log-barriers (``smooth_alpha``),
``extra_cstrs_fns`` is rejected, and ``device``/``dtype`` keywords select
placement. Here they place the solve: ``device`` goes to `scp.scp_solve`,
``dtype`` (numpy or torch) becomes the working dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .scp import scp_solve as _scp_solve
from .utils import numpy_dtype

SOLVE_KWS = {
    "X_ref", "U_ref", "X_prev", "U_prev", "x_l", "x_u", "u_l", "u_u",
    "verbose", "debug", "max_it", "time_limit", "res_tol", "reg_x", "reg_u",
    "slew_rate", "u0_slew", "lin_cost_fn", "diff_cost_fn", "solver_settings",
    "solver_state", "differentiate_rollout", "device",
}


def scp_solve(
    f_fx_fu_fn: Callable,
    Q,
    R,
    x0,
    *,
    solver_settings: Optional[Dict[str, Any]] = None,
    device: Any = None,
    dtype: Any = None,
    diff_cost_fn: Optional[Callable] = None,
    differentiate_rollout: bool = False,
    **kw,
):
    """Reference-experimental-compatible solve: smoothed box constraints only.

    ``extra_cstrs_fns`` raises like ``jax_solver.py:347-352``; constraints are
    smoothed with ``smooth_alpha`` (default 1e2 like ``jax_solver.py:362``).
    """
    if "extra_cstrs_fns" in kw and kw["extra_cstrs_fns"] is not None:
        raise ValueError(
            "The device-resident experimental API does not support custom convex "
            "constraints; provide a `diff_cost_fn` or use pmpc_tpu_torch.solve with "
            "extra_cstrs_fns instead."
        )
    kw.pop("extra_cstrs_fns", None)
    if differentiate_rollout:
        # the callback linearizes through the dynamics protocol already
        pass
    ss = dict(solver_settings or {})
    has_bounds = any(kw.get(k) is not None for k in ("x_l", "x_u", "u_l", "u_u"))
    if has_bounds:
        ss.setdefault("smooth_cstr", "logbarrier")
        ss.setdefault("smooth_alpha", 1e2)
    if diff_cost_fn is not None:
        # a torch fn(X (M,N,xdim), U (M,N,udim)) -> scalar tensor
        ss["diff_cost_fn"] = diff_cost_fn
    if dtype is not None:
        ss.setdefault("dtype", numpy_dtype(dtype))
    return _scp_solve(f_fx_fu_fn, Q, R, x0, solver_settings=ss, device=device, **kw)


solve = scp_solve
