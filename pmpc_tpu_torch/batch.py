"""Batched multi-problem solving: stack a list of problems into one solve.

Twin of ``pmpc_tpu/batch.py`` (parity with the reference's batched GPU
interface, ``pmpc/experimental/remote_like_interface.py:18-106``): the
numeric fields of all problems are stacked along a new leading axis and the
whole batch is solved at once (the stacked single-particle problems become
the particle axis with ``Nc=0``, block-diagonal, no cross-problem coupling),
then split back per problem. Heterogeneous batches fall back to a serial
loop (``pmpc/scp_mpc.py:504-511``).

Three routes, as in the JAX package: the stacked host route (the port's
`scp.scp_solve` over the particle axis), ``fused=True`` (one
`torch_scp.build_scp_solver` program over one scenario of B particles) and
the hand-off of cone-featured problems to
`conebatch.solve_problems_cone`. Every route runs on ``device``, the card
when None.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .scp import scp_solve, solve
from .utils import default_device, default_dtype, numpy_dtype

_STACK_KEYS = [
    "Q", "R", "x0", "X_ref", "U_ref", "X_prev", "U_prev",
    "x_l", "x_u", "u_l", "u_u",
]
# solver_settings that send a fused batch to the cone batcher
_CONE_FEATURES = ("smooth_cstr", "smooth_alpha", "extra_cstrs", "k", "Hf", "weights")


def _host(v) -> np.ndarray:
    """An array or a tensor (any device) as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _is_numeric(v) -> bool:
    return isinstance(v, (int, float, np.ndarray, np.generic)) or (
        hasattr(v, "shape") and hasattr(v, "dtype")
    )


def stack_problems(problems: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Tree-stack numeric array fields of homogeneous problems along axis 0."""
    out = dict(problems[0])
    for k in _STACK_KEYS:
        vals = [p.get(k, None) for p in problems]
        if all(v is None for v in vals):
            out[k] = None
            continue
        if any(v is None for v in vals):
            raise ValueError(f"field {k} present in some problems but not others")
        out[k] = np.stack([_host(v) for v in vals], axis=0)
    return out


def _values_equal(a, b) -> bool:
    """Equality that tolerates array-valued entries (e.g. weights, Hf) in
    solver_settings: plain ``!=`` on dicts with arrays raises."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_values_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_values_equal(x, y) for x, y in zip(a, b))
    if _is_numeric(a) or _is_numeric(b):
        try:
            return bool(np.array_equal(_host(a), _host(b)))
        except (TypeError, ValueError):
            return a is b
    if type(a) is not type(b):
        return False
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return a is b


_SCALAR_KEYS = ("reg_x", "reg_u", "max_it", "res_tol", "slew_rate",
                "u0_slew", "u_slew", "time_limit")


def _homogeneous(problems: Sequence[Dict[str, Any]]) -> bool:
    p0 = problems[0]
    if np.ndim(p0["x0"]) != 1:
        return False  # already multi-particle: no free axis for stacking
    ss0 = p0.get("solver_settings", {}) or {}
    if ss0.get("Nc") not in (None, 0):
        # the stacked encoding makes the problems the particle axis; any
        # other consensus horizon (including -1 = full) would COUPLE the
        # independent problems: solve those serially instead
        return False
    for p in problems:
        if p.get("f_fx_fu_fn") is not p0.get("f_fx_fu_fn"):
            return False
        for k in _STACK_KEYS:
            a, b = p.get(k, None), p0.get(k, None)
            if (a is None) != (b is None):
                return False
            if a is not None and tuple(np.shape(a)) != tuple(np.shape(b)):
                return False
        # scalar kwargs are taken from problem 0 by the stacked solve, so
        # they must agree across the batch
        for k in _SCALAR_KEYS:
            if not _values_equal(p.get(k, None), p0.get(k, None)):
                return False
        for k in ("lin_cost_fn", "extra_cstrs_fns"):
            if p.get(k, None) is not p0.get(k, None):
                return False
        if not _values_equal(p.get("solver_settings", {}) or {},
                             p0.get("solver_settings", {}) or {}):
            return False
    return True


_FUSED_CACHE: Dict[Any, Any] = {}


def _solve_problems_fused(problems, split, device):
    """One fused solver call for the whole batch: the stacked problems become
    the particle axis of one scenario with Nc=0 and the entire SCP loop runs
    in `torch_scp.build_scp_solver`'s solver, no host round trip per
    iteration beyond its early-exit test. Requires the dynamics protocol
    (`make_f_fx_fu_fn`) and the fused feature subset; raises otherwise.
    `solve_problems` has sent cone-featured batches to the cone batcher."""
    from .torch_scp import build_scp_solver, make_scp_data

    p0 = problems[0]
    dyn = getattr(p0.get("f_fx_fu_fn"), "__wrapped_dynamics__", None)
    if dyn is None:
        raise ValueError(
            "fused=True needs the dynamics protocol: build f_fx_fu_fn "
            "with pmpc_tpu_torch.make_f_fx_fu_fn(step_fn)")
    ss = dict(p0.get("solver_settings") or {})
    unsupported = [k for k in ("weights", "diff_cost_fn", "solver", "mu_target")
                   if ss.get(k) is not None]
    if str(ss.get("method", "condensed")).lower() not in ("condensed",):
        unsupported.append("method")
    for k in ("lin_cost_fn", "extra_cstrs_fns", "diff_cost_fn",
              "filter_method", "return_min_viol", "time_limit"):
        if p0.get(k):
            unsupported.append(k)
    if unsupported:
        raise ValueError(f"fused=True does not support: {unsupported}")

    dev = default_device() if device is None else torch.device(device)
    st = stack_problems(problems)
    B = len(problems)
    N, xdim = st["Q"].shape[1], st["Q"].shape[-1]
    udim = st["R"].shape[-1]
    dtype = numpy_dtype(ss.get("dtype", default_dtype()))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    slew_rate = float(p0.get("slew_rate", 0.0) or 0.0)
    # the alias precedence of scp_solve: u_slew overrides u0_slew when the
    # key is present, even with value None
    u0_slew = p0["u_slew"] if "u_slew" in p0 else p0.get("u0_slew")
    slew_reg0 = float(ss.get("slew_reg0", ss.get("slew_reg", slew_rate))) \
        if u0_slew is not None else 0.0
    u_soc_r = ss.get("u_soc_r")
    if u_soc_r is not None:
        u_soc_r = np.broadcast_to(_host(u_soc_r).astype(dtype), (B, N))
    # one scenario whose particles are the B problems
    one = lambda v: None if v is None else np.asarray(v, dtype)[None]
    data = make_scp_data(
        one(st["x0"]), one(st["Q"]), one(st["R"]),
        X_ref=one(st.get("X_ref")), U_ref=one(st.get("U_ref")),
        X_prev=one(st.get("X_prev")), U_prev=one(st.get("U_prev")),
        reg_x=float(p0.get("reg_x", 1.0)), reg_u=float(p0.get("reg_u", 1e-2)),
        slew_reg=slew_rate, slew_reg0=slew_reg0,
        slew_um1=(np.broadcast_to(_host(u0_slew).astype(dtype), (1, B, udim))
                  if u0_slew is not None else None),
        u_l=one(st.get("u_l")), u_u=one(st.get("u_u")),
        x_l=one(st.get("x_l")), x_u=one(st.get("x_u")),
        u_soc_r=one(u_soc_r), dtype=tdt, device=dev,
    )
    has_u = st.get("u_l") is not None or st.get("u_u") is not None
    has_x = st.get("x_l") is not None or st.get("x_u") is not None
    max_it = int(p0.get("max_it", 100))
    res_tol = float(p0.get("res_tol", 1e-5))
    ipm_kw = dict(
        ipm_iters=int(ss.get("ipm_iters", 20)),
        ipm_tol_exp=(int(ss["ipm_tol_exp"]) if ss.get("ipm_tol_exp") is not None else None),
        ipm_tau=(float(ss["ipm_tau"]) if ss.get("ipm_tau") is not None else None),
        kappa=(float(ss["ipm_kappa"]) if ss.get("ipm_kappa") is not None else None),
        # the host frontends' rule: an explicit ipm_tol_exp disables the
        # SCP-residual forcing unless ipm_adaptive_tol is itself set
        adaptive_tol=bool(ss.get("ipm_adaptive_tol", "ipm_tol_exp" not in ss)),
    )
    key = (id(dyn), B, N, xdim, udim, has_u, has_x, u_soc_r is not None,
           max_it, res_tol, str(dtype), tuple(sorted(ipm_kw.items())))
    solver = _FUSED_CACHE.get(key)
    if solver is None:
        solver = build_scp_solver(
            dyn, N=N, xdim=xdim, udim=udim, M=B, Nc=0, max_it=max_it, res_tol=res_tol,
            has_u_bounds=has_u, has_x_bounds=has_x, has_u_soc=u_soc_r is not None, **ipm_kw)
        _FUSED_CACHE[key] = solver
    X, U, info = solver(data)
    X, U = X[0].cpu().numpy(), U[0].cpu().numpy()
    resid_m = info["resid_particle"][0].double().cpu().numpy()
    base = dict(fused=True, iters=int(info["iters"][0]), resid=float(info["resid"][0]),
                converged=bool(info["converged"][0]))
    if not split:
        base["resid_particle"] = resid_m
        return [(X, U, base)]
    # per-problem convergence: each stacked problem is an independent
    # particle, so report its OWN residual, not the batch max
    return [(X[i], U[i], dict(base, batch_index=i, resid=float(resid_m[i]),
                              converged=bool(resid_m[i] < res_tol)))
            for i in range(B)]


def solve_problems(
    problems: List[Dict[str, Any]],
    split: bool = True,
    verbose: bool = False,
    fused: bool = False,
    device=None,
    **kw,
) -> List[Tuple[np.ndarray, np.ndarray, Dict[str, Any]]]:
    """Solve many problems at once; one stacked solve when possible.

    ``fused=True`` runs the whole SCP loop as one fused solver call
    (homogeneous problems whose ``f_fx_fu_fn`` comes from
    `make_f_fx_fu_fn`, the fused feature subset): the deployment-scale
    path, thousands of problems per call. Cone-featured problems go to
    `conebatch.solve_problems_cone`. Every route runs on ``device``, the
    card when None (which raises where there is none)."""
    problems = [dict(p) for p in problems]
    if len(problems) == 0:
        return []
    if fused:
        ss0 = dict(problems[0].get("solver_settings") or {})
        if any(ss0.get(k) is not None for k in _CONE_FEATURES) \
                or (ss0.get("u_soc_r") is not None and not _homogeneous(problems)):
            # cone-featured problems: their own batcher (multi-particle and
            # consensus Nc allowed there; it validates signatures itself)
            from .conebatch import solve_problems_cone

            return solve_problems_cone(problems, split=split, device=device)
        if not _homogeneous(problems):
            raise ValueError("fused=True requires homogeneous problems")
        return _solve_problems_fused(problems, split, device)
    place = {} if device is None else dict(device=device)
    if not _homogeneous(problems):
        return [solve(**dict(p, verbose=verbose, **place)) for p in problems]

    B = len(problems)
    stacked = stack_problems(problems)
    ss = dict(stacked.get("solver_settings") or {})
    # stacked problems are independent: no consensus across the batch
    ss.setdefault("Nc", 0)
    stacked["solver_settings"] = ss
    stacked["verbose"] = verbose
    stacked.pop("M", None)
    stacked.pop("Nc", None)
    stacked.update(place)
    X, U, data = scp_solve(**stacked)
    if X is None:
        return [(None, None, None)] * B
    if not split:
        return [(X, U, data)]

    def per_problem_data(i: int) -> Dict[str, Any]:
        # each split problem gets its OWN data dict (independent hist
        # records), so callers can annotate and mutate it per problem
        d = dict(data, batch_index=i)
        if "hist" in d:
            d["hist"] = [dict(h) for h in d["hist"]]
        return d

    return [(X[i], U[i], per_problem_data(i)) for i in range(B)]
