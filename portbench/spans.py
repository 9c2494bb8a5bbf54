"""The program's spans in a traced window, reduced against the device trace
of the same window: what the host was doing while the device idled, and
which host span launched the device's work.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell's set-up and a traced window as ``run.py --trace 1`` does (at
most ``harness.TRACE_SECONDS``), with the program's span recorder
(`pmpc_tpu_torch.tracing.recording`) on as well, and prints one JSON line:
the cell's per-layer metrics as the harness reads them, the seven span
metrics of `METRICS`, the harness's breakdown with three lists more
(`breakdown`), and the checks of the reduction (`idle_s` against
``window_s - busy_s``, the share of device operations whose launch record
was found). The harness does not run this yet: the traced run of
``run.py`` records the device alone.

The record, beside the harness's: ``spans``, the recorder's tuples (name,
start ns, end ns, parent index, call index, work units n); in ``trace``,
``corr`` (the correlation id of each device event, in the order of
``events``), ``launches`` ({correlation id: host stamp ns of the runtime
call that issued it}) and ``window_ns`` (the window's ends on the spans'
clock). Spans and launch records share ``time.time_ns``'s clock; device
stamps drift from it (`idle_intervals`).

Three reductions, all computed here and none by the program:
- host self time of each span: its duration less what its child spans cover;
- device idle time by the innermost span open on the host (``(no span)``
  outside every span), over the complement of the same union of device
  intervals that ``device_idle_pct.batch`` uses, each gap placed on the
  host clock by the launch that closed it (`idle_intervals`), so the parts
  sum to the window's idle time;
- device time by the innermost span open when each operation was launched,
  matched by correlation id, not by time: the device runs behind the host.
"""

from __future__ import annotations

import bisect
import collections
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

NAME, T0, T1, PARENT, CALL, N = range(6)  # the fields of a span tuple
NO_SPAN, NO_LAUNCH = "(no span)", "(no launch record)"
TOP = 10


@contextmanager
def recording(device):
    """Record the device's activity, the host's launch records and the
    program's spans; yields a dict that holds, once the block has ended,
    ``events`` [(name, start ns, duration ns)] in start order (as
    `portbench.trace.recording` gives them), ``corr``, ``launches`` and
    ``spans``. The CPU records no device activity: its lists are empty."""
    from pmpc_tpu_torch import tracing
    acts = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    out = {}
    with torch.profiler.profile(activities=acts) as prof, tracing.recording() as spans:
        yield out
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    dev = sorted(((e.name(), e.start_ns(), e.duration_ns(), e.correlation_id())
                  for e in raw if e.device_type() == cuda), key=lambda e: e[1])
    out.update(events=[e[:3] for e in dev], corr=[e[3] for e in dev], spans=spans,
               launches={e.correlation_id(): e.start_ns() for e in raw
                         if e.device_type() != cuda and e.correlation_id()})


def innermost(spans):
    """[(t ns, index of the innermost open span, -1 for none)] in time
    order, each entry holding until the next. Spans nest and are listed in
    the order they opened (the recorder's)."""
    seg, stack = [], []

    def close_until(t):
        while stack and spans[stack[-1]][T1] <= t:
            seg.append((spans[stack.pop()][T1], stack[-1] if stack else -1))

    for i, s in enumerate(spans):
        close_until(s[T0])
        stack.append(i)
        seg.append((s[T0], i))
    close_until(float("inf"))
    return seg


def idle_intervals(tr, w0, w1):
    """The device's idle parts of the window [w0, w1) on the host clock, in
    start order; their lengths sum to the window less the union of the
    device intervals. The profiler's device stamps drift from the host clock
    within one recording (on the card by up to 1.3% of the time elapsed);
    its launch records do not. So each gap between device intervals is
    placed to end at the launch stamp of the operation that closes it,
    which the idle device started as it was launched, and keeps its length
    on the device's clock. Before the first operation the window idles from
    its start to that operation's launch; the rest of its idle time lies at
    its end, after the last operation."""
    out, end, busy = [], None, 0
    for (_, s, dur), c in zip(tr["events"], tr["corr"]):
        if end is None or s > end:
            h = tr["launches"].get(c)
            if end is None:
                out.append((w0, max(w0, h if h is not None else s)))
            else:
                h = s if h is None else h
                out.append((h - (s - end), h))
            busy, end = busy + dur, s + dur
        elif s + dur > end:
            busy, end = busy + s + dur - end, s + dur
    rest = (w1 - w0) - busy - sum(b - a for a, b in out)
    if rest > 0:
        out.append((w1 - rest, w1))
    return sorted((a, b) for a, b in out if b > a)


def split(intervals, seg):
    """{span index or -1: ns} of ``intervals`` (in time order) by the
    innermost span open on the host."""
    times = [t for t, _ in seg]
    out = collections.Counter()
    k = 0
    for a, b in intervals:
        k = bisect.bisect_right(times, a, lo=k) - 1
        cur = seg[k][1] if k >= 0 else -1
        t, j = a, k + 1
        while j < len(seg) and seg[j][0] < b:
            out[cur] += seg[j][0] - t
            t, cur = seg[j][0], seg[j][1]
            j += 1
        out[cur] += b - t
        k = max(k, 0)
    return out


def by_launch(tr, seg):
    """({span index: device ns}, {(span index, operation): device ns}) by
    the innermost span open when each device operation was launched (-1: no
    span; -2: no launch record of its correlation id)."""
    times = [t for t, _ in seg]
    spans, ops = collections.Counter(), collections.Counter()
    for (name, _, dur), c in zip(tr["events"], tr["corr"]):
        h = tr["launches"].get(c)
        if h is None:
            key = -2
        else:
            k = bisect.bisect_right(times, h) - 1
            key = seg[k][1] if k >= 0 else -1
        spans[key] += dur
        ops[key, name] += dur
    return spans, ops


def self_ns(spans):
    """Each span's host self time: its duration less its children's."""
    own = [s[T1] - s[T0] for s in spans]
    for s in spans:
        if s[PARENT] >= 0:
            own[s[PARENT]] -= s[T1] - s[T0]
    return own


def under(spans, name):
    """For each span: is it ``name`` or inside one."""
    out = []
    for s in spans:
        out.append(s[NAME] == name or (s[PARENT] >= 0 and out[s[PARENT]]))
    return out


def reduce(rec):
    """The per-span reductions of a record with spans and a trace, or None."""
    spans, tr = rec.get("spans"), rec.get("trace")
    if not spans or tr is None or "launches" not in tr:
        return None
    seg = innermost(spans)
    w0, w1 = tr["window_ns"]
    dev, ops = by_launch(tr, seg)
    return dict(spans=spans, own=self_ns(spans), window=w1 - w0, device=dev, ops=ops,
                idle=split(idle_intervals(tr, w0, w1), seg))


def _label(spans, key):
    return spans[key][NAME] if key >= 0 else NO_SPAN if key == -1 else NO_LAUNCH


def _top(counter, n=None):
    return [[k, v * 1e-9] for k, v in counter.most_common(n)]


def breakdown(red):
    """The three lists of a result line's breakdown, each by span name
    (every name, heaviest first), and the ten heaviest pairs of launching
    span and device operation; in s."""
    spans = red["spans"]
    host, idle, dev, ops = (collections.Counter() for _ in range(4))
    for i, s in enumerate(spans):
        host[s[NAME]] += red["own"][i]
    for key, ns in red["idle"].items():
        idle[_label(spans, key)] += ns
    for key, ns in red["device"].items():
        dev[_label(spans, key)] += ns
    for (key, name), ns in red["ops"].items():
        ops[f"{_label(spans, key)} <- {name[:60]}"] += ns
    return dict(host_by_span=_top(host), idle_by_span=_top(idle), device_by_span=_top(dev),
                device_by_span_op=_top(ops, TOP))


def _units(spans, name):
    return sum(s[N] for s in spans if s[NAME] == name)


def scp_rounds(red):
    """Batched SCP iterations a call: work units of ``scp.iter`` over the
    ``scp.call`` spans (a call runs to its slowest lane)."""
    calls = sum(1 for s in red["spans"] if s[NAME] == "scp.call")
    return _units(red["spans"], "scp.iter") / calls if calls else None


def _host_pct(name):
    def read(red):
        return 100.0 * sum(o for s, o in zip(red["spans"], red["own"]) if s[NAME] == name) \
            / red["window"]
    read.__doc__ = f"Host self time of ``{name}`` spans over the traced window, %."
    return read


def ipm_iter_host_us(red):
    """Host time of ``ipm.iter`` spans over their work units, us an
    iteration."""
    n = _units(red["spans"], "ipm.iter")
    return sum(s[T1] - s[T0] for s in red["spans"] if s[NAME] == "ipm.iter") / n * 1e-3 \
        if n else None


def ipm_iter_device_ms(red):
    """Device time of the operations launched inside ``ipm.iter`` spans
    (matched by correlation) over their work units, ms an iteration."""
    n = _units(red["spans"], "ipm.iter")
    if not n or not red["device"]:
        return None
    inside = under(red["spans"], "ipm.iter")
    return sum(ns for k, ns in red["device"].items() if k >= 0 and inside[k]) / n * 1e-6


def idle_in_ipm_pct(red):
    """Device idle while the innermost host span is ``ipm.iter`` or inside
    one (a loop test, ``host_read``, excepted), over the window, %."""
    inside, spans = under(red["spans"], "ipm.iter"), red["spans"]
    return 100.0 * sum(ns for k, ns in red["idle"].items()
                       if k >= 0 and inside[k] and spans[k][NAME] != "host_read") / red["window"]


def idle_outside_call_pct(red):
    """Device idle while no ``scp.call`` span is open (inputs built and
    sent, the result's synchronisation), over the window, %."""
    inside = under(red["spans"], "scp.call")
    return 100.0 * sum(ns for k, ns in red["idle"].items() if k < 0 or not inside[k]) \
        / red["window"]


METRICS = {
    "scp_rounds.batch": scp_rounds,
    "linearize_host_pct.batch": _host_pct("scp.linearize"),
    "assemble_host_pct.batch": _host_pct("scp.assemble"),
    "ipm_iter_host_us.batch": ipm_iter_host_us,
    "ipm_iter_device_ms.batch": ipm_iter_device_ms,
    "idle_in_ipm_pct.batch": idle_in_ipm_pct,
    "idle_outside_call_pct.batch": idle_outside_call_pct,
}


def metrics(rec):
    """{name: value} of the span metrics that read something in ``rec``."""
    red = reduce(rec)
    if red is None:
        return {}
    out = {name: read(red) for name, read in METRICS.items()}
    return {k: v for k, v in out.items() if v is not None}


def run_cell(cell, seed, seconds, device):
    """Set up ``cell`` (`find.cell`) and run one traced window with the
    spans recorded; returns the result dict."""
    from portbench import find, harness, program
    from portbench import trace as tracing
    gen = find.module("generators", cell["traffic"]["generator"])
    run = harness.Run(cell["config"], cell["traffic"], seed, device, program.build)
    st = gen.setup(run)
    l0, s0 = program.counters()
    with recording(device) as tr:
        to_wall = time.time_ns() - time.perf_counter_ns()
        recs = gen.window(run, st, min(seconds, harness.TRACE_SECONDS))
    l1, s1 = program.counters()
    window = recs[-1]["t1"] - recs[0]["t0"]
    traced = dict(tracing.reduce(tr["events"], window), events=tr["events"])
    rec = harness.record(recs, 0.0, {k: l1[k] - l0.get(k, 0) for k in l1},
                         {k: v - s0.get(k, 0) for k, v in s1.items() if v - s0.get(k, 0)},
                         traced, device)
    values = {m["name"]: find.module("metrics", m["name"]).read(rec) for m in cell["per_layer"]}
    traced.update(corr=tr["corr"], launches=tr["launches"],
                  window_ns=(round(recs[0]["t0"] * 1e9) + to_wall,
                             round(recs[-1]["t1"] * 1e9) + to_wall))
    rec["spans"] = tr["spans"]
    values.update(metrics(rec))
    red = reduce(rec)
    matched = sum(1 for c in tr["corr"] if c in tr["launches"])
    return dict(workload=cell["workload"]["name"], seed=seed,
                attempted=sum(r["n"] for r in recs),
                metrics=values, busy_s=traced["busy_s"], window_s=window,
                idle_s=sum(red["idle"].values()) * 1e-9 if red else None,
                launched_share=matched / len(tr["corr"]) if tr["corr"] else None,
                breakdown=dict(device_ops=traced["device_ops"], idle_gaps=traced["idle_gaps"],
                               **(breakdown(red) if red else {})))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    from portbench import find
    if not torch.cuda.is_available():
        print("portbench: spans.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as the harness: the host's cores to the launching thread
    out = run_cell(find.cell(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    import os
    os._exit(code)  # the profiler's events make the interpreter's teardown slow
