"""Scenario-batched SCP over composed cone programs (CVaR-k, user extras,
the cross-particle terminal cost ``Hf``, control-norm cones, squareplus and
logbarrier smoothing, user exponential cones).

Twin of the composed route of ``pmpc_tpu/conebatch.py``: B problems of one
signature (M particles each) run a host-driven SCP loop whose iteration is
one batched step: linearize, condensed assembly, cone-program build and the
NT cone IPM over the batch axis (`compose.composed_solve_batch_device`),
with per-problem convergence, failure flags, the reject contract and warm
starts kept on the device. Signatures with exponential cones (logbarrier
smoothing, user ``e`` rows) run the central-path barrier method
(`expbarrier.exp_barrier_solve`) over the batch instead of the NT IPM, as
the JAX function vmaps it. The host reads one flag an iteration: are all
problems done.

The programs run in float64 (``cone_dtype``) on the card: the JAX package
pins them to the host CPU because a TPU emulates f64; the H100 has it
natively. A problem dict is the JAX package's, except that the dynamics is
the torch step function ``f(x (xdim,), u (udim,)) -> (xdim,)`` under the
key ``dynamics`` (the JAX ``f_fx_fu_fn`` wrapper has no twin).

Not ported: the structured batched route (boxes, per-stage control cones and
linear-only extras on the arrow IPM; ROADMAP §1.10): its signatures raise
`NotImplementedError`. The XLA-CPU batch sharding of the JAX function is a
host-XLA workaround with nothing to port.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dynamics import linearize
from .solvers.compose import COST_ANCHOR_EPS, composed_solve_batch_device
from .solvers.extras import _canon_extras, split_stage_u_cones
from .utils import default_device

_UNSUPPORTED_PROBLEM_KEYS = ("lin_cost_fn", "extra_cstrs_fns", "filter_method",
                             "return_min_viol", "diff_cost_fn")
STRUCTURED = "ROADMAP §1.10, the structured batched route"


def _np(a) -> np.ndarray:
    """An array or a tensor (any device) as a float numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=float)


def _atleast_3d(a: np.ndarray) -> np.ndarray:
    return a.reshape((1,) * (3 - a.ndim) + a.shape) if a.ndim < 3 else a


def _cone_scp_step(state, warm_in, probs_c, bounds_c, ecs_c, extras_q_c, alpha, beta, kv, eps,
                   *, dyn, dims, sig, smooth_method, Nc, has_cvar, iters, tol_exp, kappa,
                   adaptive, res_tol):
    """One batched SCP iteration: linearize, adaptive forcing, the composed
    cone solve, and the accept/reject bookkeeping. Returns (state, warm,
    the IPM stats)."""
    X_p, U_p, resid_v, done_v, failed_v = state
    B = X_p.shape[0]
    x_at = torch.cat([probs_c["x0"][:, :, None, :], X_p[:, :, :-1, :]], 2)
    f, fx, fu = linearize(dyn, x_at, U_p)
    probs_it = dict(probs_c, f=f, fx=fx, fu=fu, X_prev=X_p, U_prev=U_p)
    tol_dyn = None
    if adaptive:
        r = torch.clamp(torch.where(torch.isfinite(resid_v), resid_v, 1e3), max=1e3)
        tol_dyn = torch.clamp(1e-3 * r * r, 0.0, 1e-3)
    X_new, U_new, _, stats, warm_new = composed_solve_batch_device(
        probs_it, bounds_c, ecs_c, extras_q_c, dims, sig, smooth_method, alpha, beta,
        Nc=Nc, k=kv, eps=eps, has_cvar=has_cvar, iters=iters, tol_exp=tol_exp,
        kappa=kappa, tol_dynamic=tol_dyn, warm=warm_in)
    mu_v, conv_v = stats["mu"], stats["converged"]
    # the per-problem reject contract: a hard-failed subproblem (IPM far from
    # its central path) freezes that problem's iterate
    tol_eff = torch.full_like(mu_v, 10.0 ** tol_exp)
    if tol_dyn is not None:
        tol_eff = torch.maximum(tol_eff, tol_dyn.max())
    hard_fail = (~conv_v) & (~torch.isfinite(mu_v) | (mu_v > 1e2 * tol_eff))
    r_new = torch.maximum(torch.linalg.vector_norm(X_new - X_p, dim=-1).amax((1, 2)),
                          torch.linalg.vector_norm(U_new - U_p, dim=-1).amax((1, 2)))
    bad = hard_fail | ~torch.isfinite(r_new)
    accept = ~(done_v | bad)
    failed_v = failed_v | (bad & ~done_v & ~torch.isfinite(resid_v))
    acc = lambda n, o: torch.where(accept.reshape((B,) + (1,) * (n.ndim - 1)), n, o)
    warm_out = warm_new if warm_in is None else tuple(map(acc, warm_new, warm_in))
    resid_o = torch.where(accept, r_new, resid_v)
    done_o = done_v | (accept & (r_new < res_tol)) | bad
    return (acc(X_new, X_p), acc(U_new, U_p), resid_o, done_o, failed_v), warm_out, stats


def _canon_problem(p: Dict[str, Any]) -> Dict[str, Any]:
    """One problem dict as (M, ...) float64 numpy arrays (the conventions of
    the JAX ``scp._SCPProblem.build``, without callbacks)."""
    out = {}
    Q = _np(p["Q"]).copy()
    single = np.ndim(p["x0"]) == 1
    Q = Q[None] if single else Q
    R = _np(p["R"]).copy()
    R = R[None] if single else R
    M, N, xdim = Q.shape[:3]
    udim = R.shape[-1]
    x0 = _np(p["x0"]).reshape(M, xdim)

    def ref(name, d):
        v = p.get(name)
        return np.zeros((M, N, d)) if v is None else _np(v).reshape(M, N, d)

    X_ref, U_ref = ref("X_ref", xdim), ref("U_ref", udim)

    def traj(name, fallback):
        v = p.get(name)
        return fallback.copy() if v is None else _np(v).reshape(fallback.shape)

    def bound(name, d):
        v = p.get(name)
        if v is None or (_np(v).size and np.any(np.isnan(_np(v)))):
            return None
        return np.broadcast_to(_atleast_3d(_np(v)), (M, N, d)).copy()

    out.update(
        x0=x0, Q=Q, R=R, X_ref=X_ref, U_ref=U_ref,
        X_prev=traj("X_prev", X_ref), U_prev=traj("U_prev", U_ref),
        u_l=bound("u_l", udim), u_u=bound("u_u", udim),
        x_l=bound("x_l", xdim), x_u=bound("x_u", xdim),
        reg_x=float(p.get("reg_x", 1.0)), reg_u=float(p.get("reg_u", 1e-2)),
        M=M, N=N, xdim=xdim, udim=udim,
    )
    ss = dict(p.get("solver_settings") or {})
    slew_rate = p.get("slew_rate")
    out["slew_reg"] = float(slew_rate) if slew_rate else 0.0
    u0_slew = p.get("u_slew", p.get("u0_slew"))
    if u0_slew is not None:
        out["slew_reg0"] = float(ss.get("slew_reg0", ss.get("slew_reg", out["slew_reg"])))
        out["slew_um1"] = np.broadcast_to(_np(u0_slew), (M, udim)).copy()
    else:
        out["slew_reg0"] = 0.0
        out["slew_um1"] = np.zeros((M, udim))
    return out


def solve_problems_cone(problems: Sequence[Dict[str, Any]], split: bool = True,
                        device=None, stats: Optional[Dict[str, Any]] = None,
                        ) -> List[Tuple[np.ndarray, np.ndarray, Dict[str, Any]]]:
    """Batched SCP solve of B cone-featured problems in lockstep.

    Requirements (checked): homogeneous shapes and settings, the torch
    dynamics under ``dynamics``, an identical extras signature (the numbers
    may differ per problem). The programs run in ``cone_dtype`` (float64 by
    default) on ``device``; with none given, on ``solver_settings
    ["cone_device"]`` when the problems name one, else on the card (which
    raises where there is none: pass ``device="cpu"`` for the CPU).
    ``stats``, a dict, receives ``ipm_iters`` (SCP iterations x B, the IPM
    iterations of every lane in every SCP iteration; the phase-II centerings
    of the barrier method), ``ipm_converged`` (the same shape, the inner
    solve's flag), ``newton_steps`` with exponential cones (the same shape,
    the barrier method's Newton steps) and ``t_step`` (the seconds of each
    SCP iteration). Returns the JAX function's per-problem
    ``(X, U, data)``, or ``(None, None, None)`` for a problem whose
    subproblem failed hard."""
    p0 = problems[0]
    dyn = p0.get("dynamics")
    if not callable(dyn):
        raise ValueError(
            "batched cone solves need the torch dynamics: put the step function "
            "f(x, u) -> x_next under the problem key 'dynamics'")
    for k in _UNSUPPORTED_PROBLEM_KEYS:
        if p0.get(k):
            raise ValueError(f"batched cone solves do not support {k!r}")
    ss0 = dict(p0.get("solver_settings") or {})
    smooth = str(ss0.get("smooth_cstr") or "")
    if smooth == "" and ss0.get("smooth_alpha") is not None \
            and np.isfinite(float(ss0["smooth_alpha"])):
        smooth = "logbarrier"
    B = len(problems)
    cps = [_canon_problem(p) for p in problems]
    M, N, xdim, udim = cps[0]["M"], cps[0]["N"], cps[0]["xdim"], cps[0]["udim"]
    Nc = int(ss0.get("Nc", -1))
    Nc = Nc if Nc >= 0 else N
    if M == 1:
        Nc = 0  # single particle: keep the per-particle layout
    dims = (N, udim, xdim)

    def stack(key):
        vals = [cp[key] for cp in cps]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"field {key} present in only some problems")
            return None
        return np.stack([np.asarray(v, dtype=float) for v in vals])

    probs_np = {k: stack(k) for k in
                ("x0", "Q", "R", "X_ref", "U_ref", "X_prev", "U_prev", "slew_um1")}
    for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0"):
        probs_np[k] = np.stack([np.full((M,), cp[k]) for cp in cps])

    # particle weights pre-scale each problem's cost terms (scale_probs_cost!
    # parity, main.jl:96-112); presence must be homogeneous
    w_list = [(p.get("solver_settings") or {}).get("weights") for p in problems]
    if any(w is not None for w in w_list):
        if not all(w is not None for w in w_list):
            raise ValueError("weights present in only some problems of the batch")
        W = np.stack([_np(w).reshape(M) for w in w_list])  # (B, M)
        W = W / W.sum(axis=1, keepdims=True)
        probs_np["Q"] = probs_np["Q"] * W[:, :, None, None, None]
        probs_np["R"] = probs_np["R"] * W[:, :, None, None, None]
        for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0"):
            probs_np[k] = probs_np[k] * W
        if bool(ss0.get("weights_scale_slew_target", True)):
            probs_np["slew_um1"] = probs_np["slew_um1"] * W[:, :, None]
    bounds_np = {k: stack(k) for k in ("u_l", "u_u", "x_l", "x_u")}
    bounds_np = {k: v for k, v in bounds_np.items() if v is not None}

    if ss0.get("u_soc_r") is not None:
        bounds_np["u_soc_r"] = np.stack([np.broadcast_to(
            _np((p.get("solver_settings") or {}).get("u_soc_r")), (M, N)) for p in problems])

    # extras: one static signature across the batch, stacked numerics
    nu_total = Nc * udim + M * (N - Nc) * udim
    n_full = nu_total + M * N * xdim
    sigs, arrays = [], []
    for p in problems:
        ec = (p.get("solver_settings") or {}).get("extra_cstrs") or []
        ec = [tuple(a if isinstance(a, (int, list, tuple)) else _np(a) for a in c) for c in ec]
        sig_i, arr_i = _canon_extras(ec, n_full)
        sigs.append(sig_i)
        arrays.append(arr_i)
    sig = sigs[0]
    if any(s != sig for s in sigs):
        raise ValueError(
            "batched cone solves need the same extras signature (l, q, e, "
            "n_aux) for every problem; numeric values may differ")
    ecs_np = tuple(tuple(np.stack([arrays[b][i][j] for b in range(B)]) for j in range(5))
                   for i in range(len(sig)))

    extras_q_np = {}
    if ss0.get("Hf") is not None:
        extras_q_np["Hf"] = np.stack([_np((p.get("solver_settings") or {})["Hf"])
                                      for p in problems])
        if ss0.get("hf") is not None:
            extras_q_np["hf"] = np.stack([_np((p.get("solver_settings") or {})["hf"])
                                          .reshape(-1) for p in problems])

    k_set = ss0.get("k")
    has_cvar = k_set is not None and int(k_set) >= 0 and int(k_set) != M
    if has_cvar and "Hf" in extras_q_np:
        raise NotImplementedError("k (CVaR) combined with Hf is not supported")

    max_it = int(p0.get("max_it", 100))
    res_tol = float(p0.get("res_tol", 1e-5))

    # the JAX function sends boxes + per-stage control cones + linear-only
    # extras to its structured route (the arrow IPM): same test, and those
    # signatures are refused here until that route is ported
    lin_only = all(q == () and e == 0 and na == 0 for (_, q, e, na) in sig)
    c_left_zero = all(np.all(arrs[i][3] == 0.0) for arrs in arrays for i in range(len(sig)))
    struct_base = (not has_cvar and not smooth and not extras_q_np and c_left_zero
                   and ss0.get("mu_target") is None
                   and bool(ss0.get("extras_structured", True))
                   and "cone_dtype" not in ss0 and "cone_device" not in ss0)
    struct_ok = struct_base and lin_only
    if struct_base and not lin_only:
        struct_ok = all(split_stage_u_cones(sig, arrays[b], M, N, Nc, udim) is not None
                        for b in range(B))
    if struct_ok:
        raise NotImplementedError(
            "this signature takes the JAX package's structured batched route (boxes, "
            "per-stage control cones, linear-only extras on the arrow IPM), which is not "
            f"ported yet ({STRUCTURED}); settings extras_structured=False (or an explicit "
            "cone_dtype / cone_device) send it to the composed cone program")

    cdt = np.dtype(ss0.get("cone_dtype", np.float64))
    f64 = cdt == np.float64
    iters = int(ss0.get("ipm_iters", 100 if f64 else (50 if has_cvar else 35)))
    tol_exp = int(ss0.get("ipm_tol_exp", -8 if f64 else (-3 if has_cvar else -5)))
    kappa = float(ss0.get("ipm_kappa", 1e-10 if f64 else (1e-6 if has_cvar else 1e-7)))
    adaptive = bool(ss0.get("ipm_adaptive_tol", "ipm_tol_exp" not in ss0))

    want = device if device is not None else ss0.get("cone_device")
    dev = default_device() if want in (None, "auto") else torch.device(want)
    tdt = torch.float64 if f64 else torch.float32
    cast = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt, device=dev)
    probs = {k: cast(v) for k, v in probs_np.items()}
    bounds = {k: cast(v) for k, v in bounds_np.items()}
    ecs = tuple(tuple(cast(a) for a in ec) for ec in ecs_np)
    extras_q = {k: cast(v) for k, v in extras_q_np.items()}
    alpha = float(ss0.get("smooth_alpha", 1.0) or 1.0)
    beta = float(ss0.get("smooth_beta", 1.0) or 1.0)
    kv = float(k_set) if has_cvar else None
    eps = float(ss0.get("cost_anchor_eps", COST_ANCHOR_EPS)) if has_cvar else None

    state = (probs["X_prev"], probs["U_prev"], cast(np.full((B,), np.inf)),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    warm = None
    iters_used, t_aff, ipm_hist, conv_hist, newton_hist = 0, [], [], [], []
    for it in range(max_it):
        t0 = time.perf_counter()
        state, warm, st = _cone_scp_step(
            state, warm, probs, bounds, ecs, extras_q, alpha, beta, kv, eps, dyn=dyn,
            dims=dims, sig=sig, smooth_method=smooth, Nc=Nc, has_cvar=has_cvar, iters=iters,
            tol_exp=tol_exp, kappa=kappa, adaptive=adaptive, res_tol=res_tol)
        done_all = bool(state[3].all())  # the one host sync of an iteration
        t_aff.append(time.perf_counter() - t0)
        ipm_hist.append(st["iters"])
        conv_hist.append(st["converged"])
        if "newton" in st:
            newton_hist.append(st["newton"])
        iters_used = it + 1
        if done_all:
            break
    X_np, U_np, resid_b, _, failed_b = (z.cpu().numpy() for z in state)
    if stats is not None:
        stats["ipm_iters"] = torch.stack(ipm_hist).cpu().numpy()
        stats["ipm_converged"] = torch.stack(conv_hist).cpu().numpy()
        if newton_hist:
            stats["newton_steps"] = torch.stack(newton_hist).cpu().numpy()
        stats["t_step"] = list(t_aff)
    return _emit(problems, probs_np, X_np, U_np, resid_b, failed_b, iters_used, t_aff,
                 res_tol, split)


def _emit(problems, probs_np, X_np, U_np, resid_b, failed_b, iters_used, t_aff, res_tol,
          split):
    """Per-problem results (the scp.py contract: ``(None, None, None)`` on
    hard failure)."""
    B = X_np.shape[0]
    X_traj = np.concatenate([np.asarray(probs_np["x0"])[:, :, None, :], X_np], axis=2)
    base = dict(fused_cone=True, iters=iters_used, t_aff_solve=t_aff)
    single = np.ndim(problems[0]["x0"]) == 1
    if not split:
        return [(X_traj, U_np, dict(base, resid_problem=resid_b,
                                    converged=bool((resid_b < res_tol).all()),
                                    ipm_failed=failed_b))]
    out = []
    for i in range(B):
        d = dict(base, batch_index=i, resid=float(resid_b[i]),
                 converged=bool(resid_b[i] < res_tol), ipm_failed=bool(failed_b[i]))
        Xi, Ui = X_traj[i], U_np[i]
        if single:
            Xi, Ui = Xi[0], Ui[0]
        out.append((None, None, None) if failed_b[i] else (Xi, Ui, d))
    return out
