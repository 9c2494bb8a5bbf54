"""Where a batched structured cone solve stops a lane at its IPM cap.

    python3 -m pmpc_tpu_torch.ipm_crawl [--tau 0.99] [--cap 100] [--out ipm_crawl_lane.pt]

Runs `chip_smoke.py` phase 24 (b)'s agreement instance (B = 8 Dubins
problems, M = 1, N = 20, box +-1, ||u_j|| <= 0.9 as SOC extras plus one
linear row, f64, 25 SCP iterations, ``ipm_tol_exp`` -10) through
`solve_problems(fused=True)` on the card and on the CPU from the same
inputs, with every call of the structured route's IPM recorded. For each
device it prints the lanes whose IPM reached its cap and their duality
measure, the lanes frozen by the hard-fail rule (mu > 1e2 * 1e-10 when not
converged) and each lane's distance from the composed route. Then it
re-solves the first frozen lane's subproblem (else the first capped one) alone, from the recorded
inputs (warm start included), on the card and on the CPU, with the card's
factor kernel and with its plain version, at the cap and at four times it,
at ``--tau`` and at 0.95, and writes that subproblem (CPU tensors) to
``--out`` for a test to hand to the JAX IPM. Run from the repository root
(it builds the instance with `chip_smoke`). Needs a CUDA device.
"""

import argparse
import time

import numpy as np
import torch

import pmpc_tpu_torch
from . import conebatch
from .flagship import dubins
from .ops import chol_inv, linalg
from .utils import matmul_precision_scope


def _lane(obj, k, copies=1):
    """Lane ``k``, ``copies`` times over as a batch, of a tensor or of a
    dict or (named) tuple of them."""
    if isinstance(obj, torch.Tensor):
        return obj[[k] * copies]
    if isinstance(obj, dict):
        return {key: _lane(v, k, copies) for key, v in obj.items()}
    if isinstance(obj, tuple):
        parts = [_lane(o, k, copies) for o in obj]
        return type(obj)(*parts) if hasattr(obj, "_fields") else tuple(parts)
    return obj


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {key: _to(v, dev) for key, v in obj.items()}
    if isinstance(obj, tuple):
        parts = [_to(o, dev) for o in obj]
        return type(obj)(*parts) if hasattr(obj, "_fields") else tuple(parts)
    return obj


def _recorded_run(problems, dev):
    """`solve_problems` with every structured IPM call recorded: (out, the
    calls as (cqp, bounds, keywords, mu, iters, converged), stats)."""
    calls, stats, real_ipm, real_batch = [], {}, conebatch.ipm_core, conebatch.solve_problems_cone

    def ipm(cqp, bounds, **kw):
        uc, uf, st = real_ipm(cqp, bounds, **kw)
        calls.append((cqp, bounds, kw, st["mu"], st["iters"], st["converged"]))
        return uc, uf, st

    conebatch.ipm_core = ipm
    conebatch.solve_problems_cone = lambda *a, **k: real_batch(*a, stats=stats, **k)
    try:
        out = pmpc_tpu_torch.solve_problems(problems, fused=True, device=dev)
    finally:
        conebatch.ipm_core, conebatch.solve_problems_cone = real_ipm, real_batch
    return out, calls, stats


def _alone(call, k, dev, iters, tau, plain=False, copies=1):
    """Lane ``k`` of a recorded call re-solved alone (or ``copies`` times
    over in one batch) on ``dev``: (iters, converged, mu) of each copy."""
    cqp, bounds, kw = (_to(_lane(x, k, copies), dev) for x in call[:3])
    kw = dict(kw, iters=iters, tau=tau)
    real = linalg.inv_cholesky
    if plain:
        linalg.inv_cholesky = chol_inv.inv_cholesky_plain
    try:
        _, _, st = conebatch.ipm_core(cqp, bounds, **kw)
    finally:
        linalg.inv_cholesky = real
    return [(int(i), bool(c), float(m))
            for i, c, m in zip(st["iters"].tolist(), st["converged"].tolist(), st["mu"].tolist())]


def lane_subproblem(call, k):
    """Lane ``k`` of a recorded call as CPU tensors: the IPM's inputs
    (``cqp``, ``bounds``, ``socs``, ``ex`` as dicts of (1, ...) tensors,
    ``warm``, ``kappa``, ``tol_exp``)."""
    cqp, bounds, kw = (_to(_lane(x, k), "cpu") for x in call[:3])
    return dict(cqp=cqp._asdict(), bounds=bounds._asdict(), socs=kw["socs"]._asdict(),
                ex=kw["ex"]._asdict(), warm=kw["warm"], kappa=kw["kappa"],
                tol_exp=kw["tol_exp"])


def main():
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--tau", type=float, default=None, help="ipm_tau (default: the IPM's, 0.99)")
    ap.add_argument("--cap", type=int, default=100)
    ap.add_argument("--out", default="ipm_crawl_lane.pt")
    args = ap.parse_args()
    tau = 0.99 if args.tau is None else args.tau
    card = torch.device("cuda", 0)
    ss = dict(ipm_tol_exp=-10, ipm_iters=args.cap)
    if args.tau is not None:
        ss["ipm_tau"] = args.tau
    runs = {}
    with matmul_precision_scope():
        for name, dev in (("card", card), ("cpu", torch.device("cpu"))):
            f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
            probs = [{k: v for k, v in p.items() if k not in ("reg_x", "reg_u")}
                     for p in cs.served_cone_problems(cs.B_AGREE_STRUCT, f_fn, np.float64, 25,
                                                      0.0, **ss)]
            t0 = time.perf_counter()
            out, calls, stats = _recorded_run(probs, dev)
            dt = time.perf_counter() - t0
            comp = [dict(p, solver_settings=dict(p["solver_settings"], extras_structured=False))
                    for p in probs]
            out_c = pmpc_tpu_torch.solve_problems(comp, fused=True, device=dev)
            gap = [float(np.abs(a[1] - b[1]).max()) for a, b in zip(out, out_c)]
            print(f"[{name}] structured B={len(probs)} tau {tau} cap {args.cap} tol 1e-10: "
                  f"{dt:.1f} s, {len(calls)} SCP iterations; SCP iterations per lane "
                  f"{stats['scp_iters'].tolist()}; |U_structured - U_composed|_inf per lane "
                  f"{['%.3e' % g for g in gap]}")
            frozen, capped_all = [], []
            for t, (_, _, _, mu, it, conv) in enumerate(calls):
                mu, it, conv = mu.cpu().numpy(), it.cpu().numpy(), conv.cpu().numpy()
                capped = np.flatnonzero(it >= args.cap)
                hard = np.flatnonzero(~conv & (mu > 1e2 * 1e-10))
                if len(capped) or len(hard):
                    print(f"    SCP iteration {t}: at the cap {capped.tolist()} (mu "
                          f"{['%.3e' % mu[k] for k in capped]}), frozen {hard.tolist()}; "
                          f"IPM iterations {it.tolist()}")
                frozen += [(t, int(k)) for k in hard]
                capped_all += [(t, int(k)) for k in capped]
            runs[name] = (calls, frozen or capped_all)
        src = next((name for name in runs if runs[name][1]), None)
        if src is None:
            print("no lane reached its cap on either device")
            return
        t, k = runs[src][1][0]
        call = runs[src][0][t]
        other = runs["cpu" if src == "card" else "card"][0]
        if t < len(other):
            d = max(float((a - b.to(a.device)).abs().max()) for a, b in
                    zip(_lane(call[0], k), _lane(other[t][0], k)) if a.numel())
            print(f"lane {k} at SCP iteration {t}: its condensed QP on the card and on the CPU "
                  f"differ by {d:.3e}")
        print(f"lane {k}'s subproblem of SCP iteration {t} ({src} run) re-solved from the "
              f"same inputs, alone and as four identical lanes of one batch (per copy: "
              f"IPM iterations, converged, mu):")
        for dev in (card, torch.device("cpu")):
            for plain in ((False, True) if dev.type == "cuda" else (False,)):
                for cap in (args.cap, 4 * args.cap):
                    for ta in (tau, 0.95):
                        for copies in (1, 4):
                            r = _alone(call, k, dev, cap, ta, plain, copies)
                            what = dev.type + (" plain factor" if plain else "")
                            print(f"    {what:<18} cap {cap:<4} tau {ta} x{copies}: " + "; ".join(
                                f"{i}, {c}, {m:.3e}" for i, c, m in r))
        torch.save(dict(lane_subproblem(call, k), lane=k, scp_iteration=t, run=src), args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
