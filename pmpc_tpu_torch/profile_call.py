"""Where one batched solver call spends its time on the card.

    python3 -m pmpc_tpu_torch.profile_call flagship|podscale|podscale64|podscale64_1e-3|unbounded|riccati_flagship|long140|long280|config3|cvar|exp_extras

Builds the named configuration as `chip_smoke.py` does, runs one warm-up call
and one timed call, then one call under ``torch.profiler`` with the program's
spans recorded (`tracing.recording`), and prints: the wall time of the timed
call, the device's busy share of the profiled call (the union of its device
intervals over its own wall time), the number of device operations, the
kernels that take most device time, and the host self time of each span
(its duration less what its child spans cover). Where the path has spans
(every `build_scp_solver` configuration; IPM iterations on the condensed
route) the batched SCP and IPM iterations of the call are their spans' work
units, and it prints the kernels an SCP and an IPM iteration. The Riccati
configurations' IPM has no spans: their batched IPM iterations are read
from a further call built with ``collect_stats=True`` (per SCP iteration the
slowest lane's count), with the kernels per IPM iteration and horizon
stage. ``cvar`` is `chip_smoke.py`
phase 17's batched CVaR program (`conebatch.solve_problems_cone`, B=64, f64):
its batched IPM iterations are the K2 launches of the call less its one
cold-start factor, and it prints the kernels per IPM iteration. ``exp_extras``
is phase 20's program with exponential cones (B=64, f64, the barrier method):
its batched Newton steps are the K4 launches less two an SCP iteration (the
phase-I factor and the final centering test), and it prints the kernels per
Newton step. Needs a CUDA
device. The profiler records the device's activity only, and the process
leaves through ``os._exit`` once the report is flushed: with the host's ops
recorded too, the profiler's processing took most of a config-3 run's three
minutes and the interpreter's exit, which frees its events, another 15-20 s.
"""

import collections
import os
import sys
import time

import torch

from . import tracing
from .conebatch import solve_problems_cone
from .flagship import HEADLINE_KW, baseline_config, cvar_batch, extras_batch, flagship, \
    long_horizon, podscale, stack_varied
from .ops import chol_inv
from .utils import default_device

# name -> (build(**options) -> (solver, data), batch, x0 spread, horizon of a
#          Riccati configuration or None)
CONFIGS = {
    "flagship": (lambda **kw: flagship(dtype=torch.float32, **HEADLINE_KW, **kw), 64, 0.05, None),
    "podscale": (lambda **kw: podscale(torch.float32, **kw), 32, 0.02, None),
    "podscale64": (lambda **kw: podscale(torch.float64, **kw), 32, 0.02, None),
    # config 5 held to the flagship's bar instead of its own 2.5e-3
    "podscale64_1e-3": (lambda **kw: podscale(torch.float64, res_tol=1e-3, **kw), 32, 0.02, None),
    "unbounded": (lambda **kw: podscale(torch.float32, bounded=False, **kw), 32, 0.02, None),
    # the O(N) route: the headline program, and the long-horizon configuration
    # as its bench runs it (one unvaried problem, 4 SCP iterations)
    "riccati_flagship": (lambda **kw: flagship(dtype=torch.float32, method="riccati",
                                               **HEADLINE_KW, **kw), 64, 0.05, 30),
    "long140": (lambda **kw: long_horizon(140, **kw), 1, 0.0, 140),
    "long280": (lambda **kw: long_horizon(280, **kw), 1, 0.0, 280),
    # BASELINE config 3 at its batch: box controls and the cone ||u_j|| <= 0.9
    "config3": (lambda **kw: baseline_config(3, torch.float32, **kw)[:2], 512, 0.02, None),
    # the batched CVaR program of chip_smoke.py phase 17: problem dicts, f64
    "cvar": (lambda **kw: (None, cvar_batch(64)), 64, None, None),
    # phase 20's extras program with an exponential cone per particle, f64
    "exp_extras": (lambda **kw: (None, extras_batch(64, exp_speed=True)), 64, None, None),
}


def busy_ns(events) -> int:
    """The union of the device intervals ``(name, start ns, duration ns)``,
    given in start order."""
    busy, end = 0, None
    for _, start, dur in events:
        stop = start + dur
        if end is None or start > end:
            busy, end = busy + dur, stop
        elif stop > end:
            busy, end = busy + stop - end, stop
    return busy


def self_times(spans) -> dict:
    """{span name: [host self ns, spans, work units]} of the recorded
    ``spans``: a span's self time is its duration less its child spans'."""
    child = [0] * len(spans)
    for _, t0, t1, parent, _, _ in spans:
        if parent >= 0:
            child[parent] += t1 - t0
    out = {}
    for i, (name, t0, t1, _, _, n) in enumerate(spans):
        e = out.setdefault(name, [0, 0, 0])
        e[0] += t1 - t0 - child[i]
        e[1] += 1
        e[2] += n
    return out


def main(name: str) -> None:
    dev = default_device()  # raises without a card
    build, B, scale, N = CONFIGS[name]
    solver, data = build()
    if solver is None:  # the cone batch: problem dicts for solve_problems_cone
        problems = data

        def solve(_):
            out = solve_problems_cone(problems, device=dev)
            conv = torch.tensor([d is not None and d["converged"] for _, _, d in out])
            resid = torch.tensor([d["resid"] if d else float("nan") for _, _, d in out])
            its = torch.tensor([d["iters"] if d else 0 for _, _, d in out])
            return None, None, dict(iters=its, converged=conv, resid=resid)
        solver, stack = solve, None
    else:
        stack = stack_varied(data, B, scale=scale)

    def call():
        t0 = time.perf_counter()
        out = solver(stack)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    call()
    chol_inv.reset_launch_counts()
    wall, (_, _, info) = call()
    launches = dict(chol_inv.LAUNCHES)
    # the device's activity alone: the report reads only device rows, and
    # recording every host-side op as well made the profiler's processing of
    # config 3's 297,342 kernels take minutes; the raw events, since the
    # profiler's event objects take minutes to build for a million kernels
    t_prof = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof, \
            tracing.recording() as spans:
        wall_prof, _ = call()
    events = sorted(((e.name(), e.start_ns(), e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA), key=lambda e: e[1])
    t_prof = time.perf_counter() - t_prof
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in events:
        by_name[e[0]][0] += e[2]
        by_name[e[0]][1] += 1
    n_kern = len(events)
    print(f"{name}: B={B}, {torch.cuda.get_device_name(0)}; unprofiled call "
          f"{wall * 1e3:.1f} ms, scp iters max {info['iters'].max().item()}, "
          f"converged_frac {info['converged'].float().mean().item():.4f}, "
          f"resid max {info['resid'].max().item():.3e}")
    print(f"profiled call {wall_prof * 1e3:.1f} ms ({t_prof:.1f} s with the profiler's "
          f"processing); device time {sum(e[2] for e in events) / 1e6:.1f} ms in {n_kern} "
          f"operations: device busy {100 * busy_ns(events) / (wall_prof * 1e9):.1f}% of the "
          f"profiled call")
    for key, (ns, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ns / 1e6:9.2f} ms {count:7d} x  {key[:90]}")
    spent = self_times(spans)
    for key, (ns, count, n) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(f"  host self {ns / 1e6:9.2f} ms {count:7d} spans {n:7d} units  {key}")
    scp_its = spent["scp.iter"][2] if "scp.iter" in spent else int(info["iters"].max())
    if "ipm.iter" in spent:
        n_ipm = spent["ipm.iter"][2]
        print(f"{scp_its} SCP iterations, {n_ipm} batched IPM iterations (spans): "
              f"{n_kern / scp_its:.0f} device operations an SCP iteration, "
              f"{n_kern / n_ipm:.0f} an IPM iteration")
    elif N is not None:
        # every lane runs each batched IPM loop to the slowest lane's count,
        # for as many SCP iterations as the call's slowest lane took
        ipm_its = build(collect_stats=True)[0](stack)[2]["scan_stats"]["ipm_iters"]
        n_ipm = int(ipm_its.amax(0)[:scp_its].sum())
        print(f"{scp_its} SCP iterations, {n_ipm} batched IPM iterations: "
              f"{n_kern / scp_its:.0f} kernels an SCP iteration, {n_kern / n_ipm:.0f} an "
              f"IPM iteration, {n_kern / n_ipm / N:.1f} an IPM iteration and stage (N={N})")
    if name == "cvar":
        # one K2 factor an IPM iteration, and one for the first SCP
        # iteration's cold start
        n_ipm = launches["inv_cholesky"] - 1
        print(f"{scp_its} SCP iterations, {n_ipm} batched IPM iterations (K2 launches "
              f"{launches}): {n_kern / scp_its:.0f} kernels an SCP iteration, "
              f"{n_kern / n_ipm:.0f} an IPM iteration")
    if name == "exp_extras":
        # one K4 factor a batched Newton step, plus the phase-I start and the
        # final centering test of every SCP iteration
        n_newton = launches["inv_cholesky_big"] - 2 * scp_its
        print(f"{scp_its} SCP iterations, {n_newton} batched Newton steps (K4 launches "
              f"{launches}): {n_kern / scp_its:.0f} kernels an SCP iteration, "
              f"{n_kern / n_newton:.0f} a Newton step")


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in CONFIGS:
        sys.exit(f"usage: python3 -m pmpc_tpu_torch.profile_call {'|'.join(CONFIGS)}")
    main(sys.argv[1])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
