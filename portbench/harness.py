"""One run of one cell: set-up, the measured (or traced) window, the check,
the metrics, and the result line.

A run's set-up (``setup_s``) runs from the process's start to the window's:
imports, the CUDA context, the kernel loaded from the checkout's build
cache, the inputs, and the traffic's warm-up at the cell's own shapes. The
window then runs the traffic's closed loop for ``--seconds``; a traced run
(``--trace 1``) records at most ``TRACE_SECONDS`` of it under the profiler,
which reads the per-layer metrics. After the window the peak memory is
read, the program's state freed, and the reference judges what the window
returned (`check`).
"""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from portbench import check, find, kernels, program
from portbench import trace as tracing

TRACE_SECONDS = 5.0  # the longest traced window: events are reduced in memory
FORBIDDEN = ("jax", "jaxlib", "flax", "pmpc_tpu")  # top-level modules the run never loads


@dataclass
class Run:
    """What the traffic's generator works with."""
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    build: Callable
    marks: list = field(default_factory=list)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name):
        """The end of a part of set-up, on the host clock."""
        self.sync()
        self.marks.append((name, time.perf_counter()))


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``pmpc_tpu_torch`` is not ``pmpc_tpu``."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def record(recs, setup_s, launches, shapes, traced, device):
    """What the metric readers read: host times, counts, counter deltas and
    the trace."""
    solves = [dict(n=r["n"], converged=int(r["converged"].sum()) if "converged" in r else 0,
                   iters=r["iters"].tolist() if "iters" in r else [])
              for r in recs]
    return dict(setup_s=setup_s,
                window_s=recs[-1]["t1"] - recs[0]["t0"], solves=solves,
                launches=launches, shapes=shapes, trace=traced,
                peaks=kernels.peaks(torch.cuda.get_device_name(device))
                if device.type == "cuda" else None)


def execute(cell, seed, seconds, trace, t0, device, build=program.build, marks=()):
    """Run the cell once on ``device``; returns (result dict, the numbers
    compared {name: (value, limit)}, notes). ``build`` makes the solver under
    test (the program's unless a check puts another in its place); ``marks``
    are the parts of set-up done before the call, (name, host time)."""
    cfg, mix = cell["config"], cell["traffic"]
    gen = find.module("generators", mix["generator"])
    run = Run(cfg, mix, seed, device, build, list(marks))
    st = gen.setup(run)
    run.mark("rest")
    setup_s = run.marks[-1][1] - t0
    l0, s0 = program.counters()
    if trace:
        with tracing.recording() as tr:
            recs = gen.window(run, st, min(seconds, TRACE_SECONDS))
    else:
        recs = gen.window(run, st, seconds)
    l1, s1 = program.counters()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = None
    if trace:
        window = recs[-1]["t1"] - recs[0]["t0"]
        traced = dict(tracing.reduce(tr["events"], window), events=tr["events"])
    ans = gen.answers(run, recs)
    del st  # the program's state goes before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    n_failed_calls = sum(r["n"] for r in recs if "error" in r)
    numbers, correct, failed, notes = check.judge(cfg, cell["check"], ans, seed, n_failed_calls)
    notes["errors"] = sorted({r["error"] for r in recs if "error" in r})[:3]
    ends = [t0] + [t for _, t in run.marks]
    notes["setup_parts_s"] = {name: t - ends[i] for i, (name, t) in enumerate(run.marks)}
    rec = record(recs, setup_s,
                 {k: l1[k] - l0.get(k, 0) for k in l1},
                 {k: v - s0.get(k, 0) for k, v in s1.items() if v - s0.get(k, 0)},
                 traced, device)
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = find.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=sum(r["n"] for r in recs), failed=failed,
                  metrics=metrics, device=dev)
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = dict(device_ops=traced["device_ops"],
                                   idle_gaps=traced["idle_gaps"])
    # last, so that the end of the line shows them; inf (nothing converged)
    # as a string, which JSON can hold
    result["compared"] = {k: dict(value=v if v != float("inf") else "inf", limit=lim)
                          for k, (v, lim) in numbers.items()}
    return result, numbers, notes


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(args, t0, device=None) -> int:
    """One run of the cell ``args.workload``: 0 with the result printed, 2
    without a card, 3 where the process holds JAX or the JAX package once
    everything has run. ``device`` (a test's CPU) skips the look for a card."""
    marks = [("imports", time.perf_counter())]
    cell = find.cell(args.workload)
    if device is None:
        chips = cell["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.zeros((), device=device)
        torch.cuda.synchronize(device)
        marks.append(("cuda_context", time.perf_counter()))
    torch.set_num_threads(1)  # the host's few cores go to the launching thread
    result, numbers, notes = execute(cell, args.seed, args.seconds, args.trace, t0, device,
                                     marks=marks)
    if device.type == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    print(f"notes: {json.dumps(notes)}", file=sys.stderr)
    for name, (value, limit) in numbers.items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    found = forbidden_modules()  # last: the check and the readers have run
    if found:
        print(f"portbench: the run loaded {found}: the benchmark never loads JAX or the "
              "JAX package; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
