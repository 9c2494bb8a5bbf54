"""The span reductions of `portbench/spans.py`: self times of nested spans,
idle time by host span summing to the window's idle time, each gap placed
on the host clock by the launch that closes it, device time by
the launching span matched by correlation id (also for an operation that
runs after its span closed), the seven span metrics, the harness's readers
unchanged by the new keys of a record, a run of a cut cell on the CPU, and
on the card that device events and launch records lie within the span that
issued them (one clock)."""

import pytest
import torch

from portbench import find, harness, spans
from portbench import trace as tracing
from portbench.tests._tiny import tiny_cell

def _rec():
    """A synthetic window [0, 100): one call 0-90 with an SCP iteration 5-80
    holding linearize 5-15, assemble 15-25 and two IPM iterations of 2 and 1
    units (30-50, 50-70) with a factor inside the first (32-40); a loop test
    70-72. The device: kernels 1-3 (launched in the call before the
    iteration), 35-40 (the factor), 45-60 (launched in the first IPM
    iteration, running past its end), 85-88 (no launch record)."""
    sp = [("scp.call", 0, 90, -1, 0, 1), ("scp.iter", 5, 80, 0, 0, 1),
          ("scp.linearize", 5, 15, 1, 0, 1), ("scp.assemble", 15, 25, 1, 0, 1),
          ("ipm.iter", 30, 50, 1, 0, 2), ("ipm.factor", 32, 40, 4, 0, 1),
          ("ipm.iter", 50, 70, 1, 0, 1), ("host_read", 70, 72, 1, 0, 1)]
    events = [("k1", 1, 2, None), ("chol", 35, 5, None), ("gemv", 45, 15, None),
              ("copy", 85, 3, None)]
    corr = [11, 12, 13, 14]
    launches = {11: 1, 12: 35, 13: 45}
    return dict(spans=sp, trace=dict(events=[e[:3] for e in events], corr=corr,
                                     launches=launches, window_ns=(0, 100)))


def test_self_times_of_nested_spans():
    rec = _rec()
    assert spans.self_ns(rec["spans"]) == [15, 13, 10, 10, 12, 8, 20, 2]
    assert sum(spans.self_ns(rec["spans"])) == 90


def test_idle_by_span_sums_to_the_window_idle():
    rec = _rec()
    red = spans.reduce(rec)
    busy = 2 + 5 + 15 + 3
    assert sum(red["idle"].values()) == 100 - busy
    idle = dict(spans.breakdown(red)["idle_by_span"])
    # 0-1 call, 3-5 call, 5-15 lin, 15-25 asm, 25-30 iter, 30-32 ipm, 32-35 factor,
    # 40-45 ipm, 60-70 ipm, 70-72 read, 72-80 iter, 80-85 call, 88-90 call, 90-100 none
    ns = {"scp.call": 1 + 2 + 5 + 2, "scp.linearize": 10, "scp.assemble": 10,
          "scp.iter": 5 + 8, "ipm.iter": 2 + 5 + 10, "ipm.factor": 3, "host_read": 2,
          spans.NO_SPAN: 10}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in ns.items()})


def test_idle_gaps_end_at_the_launch_that_closes_them():
    """Device stamps 50 ns off the host clock. On the host: a launched at
    100 runs 100-110; b, launched at 102, queues behind it and runs 111-121;
    c launched at 180 runs 180-185; the window is 90-200. Each gap keeps its
    device length and ends at the launch of the operation after it (the gap
    before a queued operation, at its launch); the window's rest of idle
    time lies at its end."""
    tr = dict(events=[("a", 150, 10), ("b", 161, 10), ("c", 230, 5)], corr=[1, 2, 3],
              launches={1: 100, 2: 102, 3: 180})
    idle = spans.idle_intervals(tr, 90, 200)
    assert idle == [(90, 100), (101, 102), (121, 180), (185, 200)]
    assert sum(b - a for a, b in idle) == 110 - 25
    assert spans.idle_intervals(dict(events=[], corr=[], launches={}), 90, 200) == [(90, 200)]


def test_device_time_goes_to_the_launching_span_by_correlation():
    rec = _rec()
    red = spans.reduce(rec)
    # gemv runs 45-60, past its ipm.iter (30-50) into the next: it counts for the first
    assert red["device"] == {0: 2, 5: 5, 4: 15, -2: 3}
    ops = dict(spans.breakdown(red)["device_by_span_op"])
    assert ops["ipm.iter <- gemv"] == pytest.approx(15e-9)


def test_span_metrics():
    m = spans.metrics(_rec())
    assert m["scp_rounds.batch"] == 1
    assert m["linearize_host_pct.batch"] == pytest.approx(10.0)
    assert m["assemble_host_pct.batch"] == pytest.approx(10.0)
    assert m["ipm_iter_host_us.batch"] == pytest.approx(40 / 3 * 1e-3)
    assert m["ipm_iter_device_ms.batch"] == pytest.approx((5 + 15) / 3 * 1e-6)
    assert m["idle_in_ipm_pct.batch"] == pytest.approx(20.0)  # 2 + 3 + 5 + 10
    assert m["idle_outside_call_pct.batch"] == pytest.approx(10.0)
    assert spans.metrics({"trace": None}) == {} and spans.metrics(dict(_rec(), spans=[])) == {}


def test_existing_readers_ignore_the_new_keys():
    rec = _rec()
    window = 100e-9
    traced = dict(tracing.reduce(rec["trace"]["events"], window), events=rec["trace"]["events"])
    recs = [dict(n=4, t0=0.0, t1=window, converged=torch.ones(4, dtype=torch.bool),
                 iters=torch.tensor([3, 4, 5, 5]))]
    plain = harness.record(recs, 1.0, {"inv_cholesky_diag": 2}, {}, traced,
                           torch.device("cpu"))
    names = [m["name"] for m in find.bench()["end_to_end"] + find.bench()["per_layer"]]
    before = {n: find.module("metrics", n).read(plain) for n in names}
    plain["trace"].update({k: rec["trace"][k] for k in ("corr", "launches", "window_ns")})
    plain["spans"] = rec["spans"]
    assert {n: find.module("metrics", n).read(plain) for n in names} == before
    assert before["device_idle_pct.batch"] == pytest.approx(75.0)


def test_a_cut_cell_runs_with_spans_on_the_cpu():
    torch.set_num_threads(2)
    out = spans.run_cell(tiny_cell("m32n30.b64"), 2**31 + 9, 0.5, torch.device("cpu"))
    m = out["metrics"]
    for name in ("scp_rounds.batch", "linearize_host_pct.batch", "assemble_host_pct.batch",
                 "ipm_iter_host_us.batch", "idle_in_ipm_pct.batch",
                 "idle_outside_call_pct.batch", "scp_iters.batch"):
        assert m[name] > 0, name
    assert m["scp_rounds.batch"] >= m["scp_iters.batch"]
    assert "ipm_iter_device_ms.batch" not in m  # the CPU records no device activity
    # no device events: the window idles throughout, each part under some span
    assert out["busy_s"] == 0 and out["idle_s"] == pytest.approx(out["window_s"], rel=1e-6)
    b = out["breakdown"]
    assert sum(v for _, v in b["idle_by_span"]) == pytest.approx(out["idle_s"], rel=1e-3)
    assert {n for n, _ in b["host_by_span"]} >= {"ipm.iter", "scp.linearize", "scp.assemble"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_events_lie_within_their_span_on_one_clock(cuda):
    """The profiler's launch records are on ``time.time_ns``'s clock, the
    spans' clock: every runtime call that issued a device operation inside a
    span that ends with a synchronise is stamped inside it. (Its device
    stamps drift from that clock, so `idle_intervals` places the device's
    gaps through the launch records.)"""
    from pmpc_tpu_torch import tracing as program_tracing
    A = torch.randn(64, 50, 50, device=cuda)
    v = torch.randn(64, 50, 1, device=cuda)
    for _ in range(3):
        (A @ v).relu_().sum()
    torch.cuda.synchronize()
    with spans.recording(cuda) as tr:
        with program_tracing.span("work"):
            for _ in range(20):
                (A @ v).relu_().sum()
            torch.cuda.synchronize()
    ((_, t0, t1, *_),) = tr["spans"]
    assert len(tr["events"]) >= 60 and all(c in tr["launches"] for c in tr["corr"])
    # the device operations' launch records (the profiler's own runtime calls
    # at its start and stop lie outside the span)
    assert all(t0 <= tr["launches"][c] <= t1 for c in tr["corr"])
    idle = spans.idle_intervals(tr, t0, t1)
    busy = round(tracing.reduce(tr["events"], 1.0)["busy_s"] * 1e9)
    assert all(t0 <= a < b <= t1 for a, b in idle)
    assert abs(sum(b - a for a, b in idle) - (t1 - t0 - busy)) <= len(tr["events"])
