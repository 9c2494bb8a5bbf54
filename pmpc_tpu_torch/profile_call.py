"""Where one batched solver call spends its time on the card.

    python3 -m pmpc_tpu_torch.profile_call flagship|podscale|podscale64|podscale64_1e-3|unbounded

Builds the named configuration as `chip_smoke.py` does, runs one warm-up call
and one timed call, then one call under ``torch.profiler`` and prints: the
wall time of the timed call, the device's busy share (the profiled call's sum
of kernel time over the unprofiled call's wall time: the profiler slows the
host, not the kernels), the number of kernels, and the kernels that take most
device time. Needs a CUDA device.
"""

import sys
import time

import torch

from .flagship import HEADLINE_KW, flagship, podscale, stack_varied
from .utils import default_device

CONFIGS = {
    "flagship": lambda: (flagship(dtype=torch.float32, **HEADLINE_KW), 64, 0.05),
    "podscale": lambda: (podscale(torch.float32), 32, 0.02),
    "podscale64": lambda: (podscale(torch.float64), 32, 0.02),
    # config 5 held to the flagship's bar instead of its own 2.5e-3
    "podscale64_1e-3": lambda: (podscale(torch.float64, res_tol=1e-3), 32, 0.02),
    "unbounded": lambda: (podscale(torch.float32, bounded=False), 32, 0.02),
}


def main(name: str) -> None:
    default_device()  # raises without a card
    (solver, data), B, scale = CONFIGS[name]()
    stack = stack_varied(data, B, scale=scale)

    def call():
        t0 = time.perf_counter()
        out = solver(stack)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    call()
    wall, (_, _, info) = call()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof, _ = call()
    # device-side rows only: the host-side op rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"{name}: B={B}, {torch.cuda.get_device_name(0)}; unprofiled call "
          f"{wall * 1e3:.1f} ms, scp iters max {info['iters'].max().item()}, "
          f"converged_frac {info['converged'].float().mean().item():.4f}, "
          f"resid max {info['resid'].max().item():.3e}")
    print(f"profiled call {wall_prof * 1e3:.1f} ms; device kernel time "
          f"{dev_us / 1e3:.1f} ms in {sum(e.count for e in events)} kernels: "
          f"device busy {100 * dev_us / (wall * 1e6):.1f}% of the unprofiled call")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} x  {e.key[:90]}")


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in CONFIGS:
        sys.exit(f"usage: python3 -m pmpc_tpu_torch.profile_call {'|'.join(CONFIGS)}")
    main(sys.argv[1])
