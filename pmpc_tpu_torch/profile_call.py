"""Where one batched solver call spends its time on the card.

    python3 -m pmpc_tpu_torch.profile_call flagship|podscale|podscale64|podscale64_1e-3|unbounded|riccati_flagship|long140|long280|config3|cvar

Builds the named configuration as `chip_smoke.py` does, runs one warm-up call
and one timed call, then one call under ``torch.profiler`` and prints: the
wall time of the timed call, the device's busy share (the profiled call's sum
of kernel time over the unprofiled call's wall time: the profiler slows the
host, not the kernels), the number of kernels, and the kernels that take most
device time. For the Riccati configurations it also prints the batched IPM
iterations of the call (read from a further call built with
``collect_stats=True``: per SCP iteration the slowest lane's count) and the
kernels per IPM iteration and horizon stage. ``cvar`` is `chip_smoke.py`
phase 17's batched CVaR program (`conebatch.solve_problems_cone`, B=64, f64):
its batched IPM iterations are the K2 launches of the call less its one
cold-start factor, and it prints the kernels per IPM iteration. Needs a CUDA
device. The profiler records the device's activity only, and the process
leaves through ``os._exit`` once the report is flushed: with the host's ops
recorded too, the profiler's processing took most of a config-3 run's three
minutes and the interpreter's exit, which frees its events, another 15-20 s.
"""

import os
import sys
import time

import torch

from .conebatch import solve_problems_cone
from .flagship import HEADLINE_KW, baseline_config, cvar_batch, flagship, long_horizon, \
    podscale, stack_varied
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
}


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
    # the device's activity alone: the report reads only kernel rows, and
    # recording every host-side op as well made the profiler's processing of
    # config 3's 297,342 kernels take minutes
    t_prof = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = call()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    t_prof = time.perf_counter() - t_prof
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"{name}: B={B}, {torch.cuda.get_device_name(0)}; unprofiled call "
          f"{wall * 1e3:.1f} ms, scp iters max {info['iters'].max().item()}, "
          f"converged_frac {info['converged'].float().mean().item():.4f}, "
          f"resid max {info['resid'].max().item():.3e}")
    print(f"profiled call {wall_prof * 1e3:.1f} ms ({t_prof:.1f} s with the profiler's "
          f"processing); device kernel time "
          f"{dev_us / 1e3:.1f} ms in {sum(e.count for e in events)} kernels: "
          f"device busy {100 * dev_us / (wall * 1e6):.1f}% of the unprofiled call")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} x  {e.key[:90]}")
    if N is not None:
        # every lane runs each batched IPM loop to the slowest lane's count,
        # for as many SCP iterations as the call's slowest lane took
        scp_its = int(info["iters"].max())
        ipm_its = build(collect_stats=True)[0](stack)[2]["scan_stats"]["ipm_iters"]
        n_ipm = int(ipm_its.amax(0)[:scp_its].sum())
        n_kern = sum(e.count for e in events)
        print(f"{scp_its} SCP iterations, {n_ipm} batched IPM iterations: "
              f"{n_kern / scp_its:.0f} kernels an SCP iteration, {n_kern / n_ipm:.0f} an "
              f"IPM iteration, {n_kern / n_ipm / N:.1f} an IPM iteration and stage (N={N})")
    if name == "cvar":
        # one K2 factor an IPM iteration, and one for the first SCP
        # iteration's cold start
        n_ipm = launches["inv_cholesky"] - 1
        scp_its = int(info["iters"].max())
        n_kern = sum(e.count for e in events)
        print(f"{scp_its} SCP iterations, {n_ipm} batched IPM iterations (K2 launches "
              f"{launches}): {n_kern / scp_its:.0f} kernels an SCP iteration, "
              f"{n_kern / n_ipm:.0f} an IPM iteration")


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in CONFIGS:
        sys.exit(f"usage: python3 -m pmpc_tpu_torch.profile_call {'|'.join(CONFIGS)}")
    main(sys.argv[1])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
