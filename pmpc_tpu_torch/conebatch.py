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
natively. A problem dict is the JAX package's: the dynamics is the torch
step function ``f(x (xdim,), u (udim,)) -> (xdim,)`` that
``make_f_fx_fu_fn`` keeps as ``f_fx_fu_fn.__wrapped_dynamics__``, or the
same step under the key ``dynamics``.

Signatures with boxes, per-stage control-norm cones and linear-only extras
take the structured route instead (`_struct_scp_step`): no cone program is
built, each iteration is one batched condensed assembly, arrow IPM
(`ipm.ipm_core`, the extras rows bordering its Newton system) and recovery
over the B problems, in the working dtype (``solver_settings["dtype"]``).
The XLA-CPU batch sharding of the JAX function is a host-XLA workaround with
nothing to port.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dynamics import linearize
from .solvers.compose import COST_ANCHOR_EPS, composed_solve_batch_device
from .solvers.extras import _canon_extras, split_stage_u_cones
from .solvers.ipm import BoxBounds, _layout_bounds, ipm_core, layout_socs, map_extras_rows
from .solvers.reduced import assemble_condensed, recover_XU
from .utils import default_device, default_dtype, matmul_precision_scope, numpy_dtype

_UNSUPPORTED_PROBLEM_KEYS = ("lin_cost_fn", "extra_cstrs_fns", "filter_method",
                             "return_min_viol", "diff_cost_fn")


def _np(a) -> np.ndarray:
    """An array or a tensor (any device) as a float numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=float)


def _atleast_3d(a: np.ndarray) -> np.ndarray:
    return a.reshape((1,) * (3 - a.ndim) + a.shape) if a.ndim < 3 else a


def _adaptive_tol(resid_v):
    """The inexact-Newton forcing of an SCP iteration, per problem (B,)."""
    r = torch.clamp(torch.where(torch.isfinite(resid_v), resid_v, 1e3), max=1e3)
    return torch.clamp(1e-3 * r * r, 0.0, 1e-3)


def _tol_eff(tol_exp, tol_dyn, like):
    """max(10^tol_exp, the batch's largest forcing tolerance), per problem."""
    tol_eff = torch.full_like(like, 10.0 ** tol_exp)
    return tol_eff if tol_dyn is None else torch.maximum(tol_eff, tol_dyn.max())


def _accept(state, warm_in, X_new, U_new, warm_new, hard_fail, res_tol):
    """The per-problem accept/reject bookkeeping of both routes: a problem
    whose subproblem failed hard (or whose step is not finite) keeps its
    iterate, its warm tuple and its residual, and is done; a problem that
    never accepted a step is failed."""
    X_p, U_p, resid_v, done_v, failed_v = state
    B = X_p.shape[0]
    r_new = torch.maximum(torch.linalg.vector_norm(X_new - X_p, dim=-1).amax((1, 2)),
                          torch.linalg.vector_norm(U_new - U_p, dim=-1).amax((1, 2)))
    bad = hard_fail | ~torch.isfinite(r_new)
    accept = ~(done_v | bad)
    failed_v = failed_v | (bad & ~done_v & ~torch.isfinite(resid_v))
    acc = lambda n, o: torch.where(accept.reshape((B,) + (1,) * (n.ndim - 1)), n, o)
    warm_out = warm_new if warm_in is None else tuple(map(acc, warm_new, warm_in))
    resid_o = torch.where(accept, r_new, resid_v)
    done_o = done_v | (accept & (r_new < res_tol)) | bad
    return (acc(X_new, X_p), acc(U_new, U_p), resid_o, done_o, failed_v), warm_out


def _cone_scp_step(state, warm_in, probs_c, bounds_c, ecs_c, extras_q_c, alpha, beta, kv, eps,
                   *, dyn, dims, sig, smooth_method, Nc, has_cvar, iters, tol_exp, kappa,
                   adaptive, res_tol):
    """One batched SCP iteration: linearize, adaptive forcing, the composed
    cone solve, and the accept/reject bookkeeping. Returns (state, warm,
    the IPM stats)."""
    X_p, U_p = state[:2]
    x_at = torch.cat([probs_c["x0"][:, :, None, :], X_p[:, :, :-1, :]], 2)
    f, fx, fu = linearize(dyn, x_at, U_p)
    probs_it = dict(probs_c, f=f, fx=fx, fu=fu, X_prev=X_p, U_prev=U_p)
    tol_dyn = _adaptive_tol(state[2]) if adaptive else None
    X_new, U_new, _, stats, warm_new = composed_solve_batch_device(
        probs_it, bounds_c, ecs_c, extras_q_c, dims, sig, smooth_method, alpha, beta,
        Nc=Nc, k=kv, eps=eps, has_cvar=has_cvar, iters=iters, tol_exp=tol_exp,
        kappa=kappa, tol_dynamic=tol_dyn, warm=warm_in)
    mu_v, conv_v = stats["mu"], stats["converged"]
    # the per-problem reject contract: a hard-failed subproblem (IPM far from
    # its central path) freezes that problem's iterate
    hard_fail = (~conv_v) & (~torch.isfinite(mu_v)
                             | (mu_v > 1e2 * _tol_eff(tol_exp, tol_dyn, mu_v)))
    return _accept(state, warm_in, X_new, U_new, warm_new, hard_fail, res_tol) + (stats,)


def _struct_scp_step(state, warm_in, probs_c, bounds_c, socs_c, ex_c, *, dyn, Nc, N, has_u,
                     has_x, has_soc, has_ex, iters, tol_exp, kappa, tau, adaptive, res_tol):
    """One batched SCP iteration on the structured route: linearize, the
    condensed assembly, the arrow IPM with the cones and the extras rows
    (`ipm.ExtraRows`, bordering its Newton system) and the recovery, each
    one call over the B problems (the JAX function vmaps them; `ipm_core`
    freezes each problem on convergence, so its loop runs to the batch's
    slowest). No dense cone program is built. Returns (state, warm, the
    IPM stats)."""
    X_p, U_p = state[:2]
    pc = probs_c
    x_at = torch.cat([pc["x0"][:, :, None, :], X_p[:, :, :-1, :]], 2)
    f, fx, fu = linearize(dyn, x_at, U_p)
    tol_dyn = _adaptive_tol(state[2]) if adaptive else None
    cqp = assemble_condensed(pc["x0"], f, fx, fu, X_p, U_p, pc["Q"], pc["R"], pc["X_ref"],
                             pc["U_ref"], pc["reg_x"], pc["reg_u"], pc["slew_reg"],
                             pc["slew_reg0"], pc["slew_um1"], Nc=Nc)
    ex = map_extras_rows(cqp, *ex_c) if has_ex else None
    uc, uf, stats = ipm_core(cqp, bounds_c, has_u=has_u, has_x=has_x, iters=iters,
                             tol_exp=tol_exp, kappa=kappa, tau=tau, warm=warm_in,
                             tol_dynamic=tol_dyn, socs=socs_c, has_soc=has_soc, ex=ex,
                             has_ex=has_ex)
    X_new, U_new = recover_XU(cqp, uc, uf, N=N)
    warm_new = (uc, uf, stats["s"], stats["lam"]) \
        + ((stats["sq"], stats["zq"]) if has_soc else ())
    mu_v, conv_v = stats["mu"], stats["converged"]
    # the composed step's hard-fail contract: an unconverged IPM whose
    # duality measure is far from its target never produced a usable
    # iterate (infeasible rows drive mu to a plateau, not to tol)
    hard_fail = stats["failed"] | ~torch.isfinite(mu_v) \
        | ((~conv_v) & (mu_v > 1e2 * _tol_eff(tol_exp, tol_dyn, mu_v)))
    return _accept(state, warm_in, X_new, U_new, warm_new, hard_fail, res_tol) + (stats,)


_DYNAMICS_MSG = ("batched cone solves need the torch dynamics: build f_fx_fu_fn with "
                 "pmpc_tpu_torch.make_f_fx_fu_fn(step_fn), or put the step function "
                 "f(x, u) -> x_next under the problem key 'dynamics'")


def _torch_dynamics(p: Dict[str, Any]):
    """The problem's step: ``f_fx_fu_fn.__wrapped_dynamics__`` (the JAX
    function's protocol), else the key ``dynamics``."""
    dyn = getattr(p.get("f_fx_fu_fn"), "__wrapped_dynamics__", None)
    if dyn is None:
        dyn = p.get("dynamics")
    if not callable(dyn):
        raise ValueError(_DYNAMICS_MSG)
    return dyn


def _check_torch_step(dyn, x0: torch.Tensor, udim: int) -> None:
    """One call of the step at one x0 (xdim,), on the route's device and in
    its dtype, checks that it maps torch tensors to a torch tensor (a JAX
    step, such as the JAX package's ``make_f_fx_fu_fn`` keeps, does not)."""
    try:
        out = dyn(x0, x0.new_zeros(udim))
    except Exception as e:  # any failure of a foreign step: say what is wanted
        raise ValueError(f"{_DYNAMICS_MSG} (calling it on torch tensors raised {e!r})") from e
    if not isinstance(out, torch.Tensor):
        raise ValueError(f"{_DYNAMICS_MSG} (it returned {type(out).__name__} for torch tensors)")


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
    dynamics (``f_fx_fu_fn.__wrapped_dynamics__``, as ``make_f_fx_fu_fn``
    sets it, else the problem key ``dynamics``), an identical extras
    signature (the numbers may differ per problem).

    Boxes, per-stage control-norm cones and linear-only extras take the
    structured route (the arrow IPM over the batch, the working dtype
    ``solver_settings["dtype"]``, else torch's default; ``ipm_iters`` 30,
    ``ipm_tol_exp`` -8 in f64 and -5 otherwise, ``ipm_kappa`` 0 in f64 and
    1e-7 otherwise, and ``ipm_tau``, which the JAX route ignores) on
    ``device``, or on the CPU with ``solver_settings["struct_device"] =
    "cpu"``. Every other signature runs the composed
    cone program in ``cone_dtype`` (float64 by default) on ``device``; with
    none given, on ``solver_settings["cone_device"]`` when the problems name
    one. Either route goes to the card when no device is named (which
    raises where there is none: pass ``device="cpu"`` for the CPU).
    ``stats``, a dict, receives ``ipm_iters`` (SCP iterations x B, the IPM
    iterations of every lane in every SCP iteration; the phase-II centerings
    of the barrier method), ``ipm_converged`` (the same shape, the inner
    solve's flag), ``newton_steps`` with exponential cones (the same shape,
    the barrier method's Newton steps), ``t_step`` (the seconds of each
    SCP iteration), ``scp_iters`` (B,), the SCP iterations each problem ran
    before it was done, and ``structured`` (which route ran). Returns the
    JAX function's per-problem ``(X, U, data)``, or ``(None, None, None)``
    for a problem whose subproblem failed hard."""
    p0 = problems[0]
    dyn = _torch_dynamics(p0)
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

    # STRUCTURED route: boxes + per-stage control cones + linear-only extras
    # never need the dense composed cone program: each subproblem is the
    # arrow IPM, the extras rows bordering its Newton system
    lin_only = all(q == () and e == 0 and na == 0 for (_, q, e, na) in sig)
    c_left_zero = all(np.all(arrs[i][3] == 0.0) for arrs in arrays for i in range(len(sig)))
    struct_base = (not has_cvar and not smooth and not extras_q_np and c_left_zero
                   and ss0.get("mu_target") is None
                   and bool(ss0.get("extras_structured", True))
                   and "cone_dtype" not in ss0 and "cone_device" not in ss0)
    struct_ok = struct_base and lin_only
    if struct_base and not lin_only:
        # per-stage control-norm SOC extras -> u_soc_r cones on the structured
        # route (the serial dispatch's detection); every problem's blocks must match
        dets = [split_stage_u_cones(sig, arrays[b], M, N, Nc, udim) for b in range(B)]
        if all(d is not None for d in dets):
            r_stack = np.stack([d[0] for d in dets])  # (B, M, N)
            prev = bounds_np.get("u_soc_r")
            if prev is not None:
                r_stack = np.minimum(prev, r_stack)
            bounds_np["u_soc_r"] = r_stack
            ltot = dets[0][1].shape[0]
            if ltot:
                # one linear entry per problem: (G_l, G_r, h, c_l, c_r). The
                # JAX function drops this nesting level and raises IndexError
                # here (ROADMAP §3 R4)
                n_cols = dets[0][1].shape[1]
                sig = ((ltot, (), 0, 0),)
                arrays = tuple(((d[1], np.zeros((ltot, 0)), d[2], np.zeros(n_cols),
                                 np.zeros(0)),) for d in dets)
            else:
                sig, arrays = (), tuple(() for _ in range(B))
            struct_ok = True
    if stats is not None:
        stats["structured"] = struct_ok
    if struct_ok:
        X_np, U_np, resid_b, failed_b, iters_used, t_aff = _run_struct_batched(
            probs_np, bounds_np, cps, sig, arrays, dyn=dyn, B=B, M=M, N=N, udim=udim,
            Nc=Nc, ss0=ss0, max_it=max_it, res_tol=res_tol, device=device, stats=stats)
        return _emit(problems, probs_np, X_np, U_np, resid_b, failed_b, iters_used, t_aff,
                     res_tol, split)

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
    _check_torch_step(dyn, probs["x0"][0, 0], udim)
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
    step = lambda st, warm: _cone_scp_step(
        st, warm, probs, bounds, ecs, extras_q, alpha, beta, kv, eps, dyn=dyn, dims=dims,
        sig=sig, smooth_method=smooth, Nc=Nc, has_cvar=has_cvar, iters=iters, tol_exp=tol_exp,
        kappa=kappa, adaptive=adaptive, res_tol=res_tol)
    X_np, U_np, resid_b, failed_b, iters_used, t_aff = _scp_loop(step, state, max_it, stats)
    return _emit(problems, probs_np, X_np, U_np, resid_b, failed_b, iters_used, t_aff,
                 res_tol, split)


def _scp_loop(step, state, max_it, stats):
    """Run ``step(state, warm) -> (state, warm, IPM stats)`` until every
    problem is done or ``max_it``, with one host sync an iteration (are all
    problems done). Returns (X, U, resid, failed) as numpy, the SCP
    iterations run and the seconds of each; fills ``stats`` (see
    `solve_problems_cone`)."""
    warm, t_aff = None, []
    hist = {"ipm_iters": [], "ipm_converged": [], "newton_steps": []}
    lane_its = torch.zeros(state[3].shape, dtype=torch.int32, device=state[3].device)
    for _ in range(max_it):
        t0 = time.perf_counter()
        lane_its += (~state[3]).to(torch.int32)
        state, warm, st = step(state, warm)
        done_all = bool(state[3].all())  # the one host sync of an iteration
        t_aff.append(time.perf_counter() - t0)
        hist["ipm_iters"].append(st["iters"])
        hist["ipm_converged"].append(st["converged"])
        if "newton" in st:
            hist["newton_steps"].append(st["newton"])
        if done_all:
            break
    X_np, U_np, resid_b, _, failed_b = (z.cpu().numpy() for z in state)
    if stats is not None:
        stats.update({k: torch.stack(v).cpu().numpy() for k, v in hist.items() if v})
        stats["t_step"] = list(t_aff)
        stats["scp_iters"] = lane_its.cpu().numpy()
    return X_np, U_np, resid_b, failed_b, len(t_aff), t_aff


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


def _run_struct_batched(probs_np, bounds_np, cps, sig, arrays, *, dyn, B, M, N, udim, Nc,
                        ss0, max_it, res_tol, device, stats):
    """Drive the structured batched SCP loop (`_struct_scp_step`) on
    ``device`` (the card when None; the CPU with ``struct_device="cpu"``)
    in the working dtype. Returns `_scp_loop`'s results."""
    dtype = numpy_dtype(ss0.get("dtype", default_dtype()))
    f64 = dtype == np.float64
    tdt = torch.float64 if f64 else torch.float32
    has_u = any(bounds_np.get(k) is not None for k in ("u_l", "u_u"))
    has_x = any(bounds_np.get(k) is not None for k in ("x_l", "x_u"))
    has_soc = bounds_np.get("u_soc_r") is not None
    has_ex = len(sig) > 0
    iters = int(ss0.get("ipm_iters", 30))
    tol_exp = int(ss0.get("ipm_tol_exp", -8 if f64 else -5))
    kappa = float(ss0.get("ipm_kappa", 0.0 if f64 else 1e-7))
    # ipm_tau (a setting of the host IPM and of `build_scp_solver`) reaches
    # the IPM here too; the JAX route drops it (ROADMAP §3 F13)
    tau = float(ss0["ipm_tau"]) if ss0.get("ipm_tau") is not None else None
    adaptive = bool(ss0.get("ipm_adaptive_tol", "ipm_tol_exp" not in ss0))
    if str(ss0.get("struct_device", "auto")) == "cpu":
        dev = torch.device("cpu")
    else:
        dev = default_device() if device is None else torch.device(device)

    cast = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt, device=dev)
    nc, nf = Nc * udim, (N - Nc) * udim
    NX = N * cps[0]["xdim"]
    blist = [_layout_bounds(cp["u_l"], cp["u_u"], cp["x_l"], cp["x_u"], M, N, NX, nc, nf,
                            udim, dtype, device=dev) for cp in cps]
    bounds = BoxBounds(*(torch.cat(xs) for xs in zip(*blist)))
    socs = layout_socs(cast(bounds_np["u_soc_r"]), Nc) if has_soc else None
    ex = None
    if has_ex:
        ex = (cast(np.stack([np.concatenate([arrays[b][i][0] for i in range(len(sig))])
                             for b in range(B)])),
              cast(np.stack([np.concatenate([arrays[b][i][2] for i in range(len(sig))])
                             for b in range(B)])))
    probs = {k: cast(probs_np[k]) for k in
             ("x0", "Q", "R", "X_ref", "U_ref", "X_prev", "U_prev", "reg_x", "reg_u",
              "slew_reg", "slew_reg0", "slew_um1")}
    _check_torch_step(dyn, probs["x0"][0, 0], udim)
    state = (probs["X_prev"], probs["U_prev"], cast(np.full((B,), np.inf)),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    step = lambda st, warm: _struct_scp_step(
        st, warm, probs, bounds, socs, ex, dyn=dyn, Nc=Nc, N=N, has_u=has_u, has_x=has_x,
        has_soc=has_soc, has_ex=has_ex, iters=iters, tol_exp=tol_exp, kappa=kappa, tau=tau,
        adaptive=adaptive, res_tol=res_tol)
    with matmul_precision_scope():
        return _scp_loop(step, state, max_it, stats)
