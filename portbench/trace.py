"""The device trace of a traced window, reduced in memory: ``torch.profiler``
records the device's activity alone (kernels, copies, fills), and nothing
is written to disk. Busy time is the union of the device intervals; the idle
gaps are named by the operations on either side of them."""

from __future__ import annotations

import collections
from contextlib import contextmanager

import torch

TOP = 10  # entries of each list of the breakdown


def _events(prof):
    """(name, start ns, duration ns) of every device event, in start order,
    from the profiler's raw results (its event objects take minutes to
    build for a million kernels)."""
    ev = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    return sorted(ev, key=lambda e: e[1])


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@contextmanager
def recording():
    """Record the device's activity; yields a dict that holds, once the block
    has ended, ``events``: [(name, start ns, duration ns)]."""
    out = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield out
    out["events"] = _events(prof)


def reduce(events, window_s):
    """busy_s (the union of the device intervals), and the breakdown: the
    device operations that took most time, and the longest idle gaps
    summed by the pair of operations around them."""
    busy_ns, end = 0, None
    gaps = collections.Counter()
    by_name = collections.Counter()
    prev = None
    for name, start, dur in events:
        by_name[name] += dur
        stop = start + dur
        if end is None or start > end:
            if end is not None:
                gaps[f"{prev[:60]} -> {name[:60]}"] += start - end
            busy_ns += dur
            end = stop
        elif stop > end:
            busy_ns += stop - end
            end = stop
        if end == stop:
            prev = name
    return dict(busy_s=busy_ns * 1e-9, window_s=window_s,
                device_ops=[[n, t * 1e-9] for n, t in by_name.most_common(TOP)],
                idle_gaps=[[n, t * 1e-9] for n, t in gaps.most_common(TOP)])
