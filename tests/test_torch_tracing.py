"""The span recorder (`pmpc_tpu_torch.tracing`) and the spans of the
condensed box path, on the CPU:

- off, `span` hands back one shared object, reads no clock, allocates
  nothing and records nothing;
- a solve gives the same bits with the recorder on and off;
- spans nest (each inside its parent, siblings apart, one call id a
  `scp.call`), so the self times of a call sum to its duration;
- the work units of `scp.iter` and `ipm.iter` are the batched SCP and IPM
  iterations the call ran, held against the solver's own counts
  (``info["iters"]`` and the ``collect_stats`` IPM counts);
- `COUNTS["host_read"]` counts `pany` calls, and the stream's ``host_reads``
  stat reads it;
- a `torch.profiler` range inside a span lies within the span's stamps
  (the profiler stamps events on the recorder's clock).
"""

import itertools
import tracemalloc

import numpy as np
import pytest
import torch

from pmpc_tpu_torch import tracing
from pmpc_tpu_torch.flagship import HEADLINE_KW, _instance, flagship, stack_varied
from pmpc_tpu_torch.particles import pany
from pmpc_tpu_torch.profile_call import busy_ns, self_times
from pmpc_tpu_torch.stream import solve_stream
from pmpc_tpu_torch.torch_scp import build_scp_solver

torch.set_num_threads(2)
NAME, T0, T1, PARENT, CALL, N = range(6)
BOX_PATH = {"scp.call", "scp.iter", "scp.linearize", "scp.assemble", "scp.accel", "ipm.iter",
            "ipm.factor", "ipm.residual", "ipm.solve", "host_read"}


def _problem(B=3, scale=0.05):
    """The headline program (box controls, AA, 8 IPM iterations a
    subproblem) cut to M = 4, N = 8, f64."""
    solver, data = flagship(M=4, N=8, Nc=2, dtype=torch.float64, device="cpu", **HEADLINE_KW)
    return solver, stack_varied(data, B, scale=scale)


def _spin(k, n=3):
    for _ in itertools.repeat(None, k):
        with tracing.span("ipm.iter", n):
            pass


def test_off_span_is_one_object_and_records_nothing():
    a, b = tracing.span("scp.call"), tracing.span("ipm.iter", 4)
    assert a is b is tracing.OFF
    with tracing.span("scp.iter"):
        with tracing.recording() as rec:
            pass
    assert rec == []


def test_off_span_reads_no_clock_and_allocates_nothing(monkeypatch):
    def clock():
        raise AssertionError("the clock was read")

    def grown(k):  # the most memory held while k spans run
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        _spin(k)
        return tracemalloc.get_traced_memory()[1] - base

    monkeypatch.setattr(tracing, "_clock", clock)
    tracemalloc.start()
    try:
        _spin(100)
        one, many = grown(1), grown(20000)
    finally:
        tracemalloc.stop()
    assert many == one  # the loop's own few bytes, none a span
    # on, the same loop reads the clock: the check above can fail
    with pytest.raises(AssertionError, match="clock"), tracing.recording():
        _spin(1)


def test_on_span_records_name_stamps_parent_call_and_units():
    with tracing.recording() as rec:
        with tracing.span("scp.call"):
            with tracing.span("ipm.iter", 5):
                pass
        with tracing.span("scp.call"):
            pass
    assert [(s[NAME], s[PARENT], s[CALL], s[N]) for s in rec] == \
        [("scp.call", -1, 0, 1), ("ipm.iter", 0, 0, 5), ("scp.call", -1, 2, 1)]
    assert all(0 < s[T0] <= s[T1] for s in rec)
    assert tracing.span("x") is tracing.OFF  # off again after the block


def test_an_exception_turns_the_recorder_off():
    with pytest.raises(RuntimeError), tracing.recording() as rec:
        with tracing.span("scp.call"):
            raise RuntimeError
    assert [s[NAME] for s in rec] == ["scp.call"] and rec[0][T0] <= rec[0][T1]
    assert tracing.span("x") is tracing.OFF


def test_recording_changes_no_bit_of_the_solve():
    solver, stack = _problem()
    X0, U0, i0 = solver(stack)
    with tracing.recording() as rec:
        X1, U1, i1 = solver(stack)
    assert {s[NAME] for s in rec} == BOX_PATH
    assert torch.equal(X0, X1) and torch.equal(U0, U1)
    assert i0.keys() == i1.keys() and all(torch.equal(i0[k], i1[k]) for k in i0)


def test_spans_nest_and_self_times_sum_to_the_call():
    solver, stack = _problem()
    with tracing.recording() as rec:
        solver(stack)
        solver(stack._replace(x0=stack.x0 * 1.1))
    calls = [i for i, s in enumerate(rec) if s[NAME] == "scp.call"]
    assert len(calls) == 2
    children = {}
    for i, s in enumerate(rec):
        assert s[CALL] in calls and (s[PARENT] == -1) == (i in calls)
        if s[PARENT] >= 0:
            p = rec[s[PARENT]]
            assert s[PARENT] < i and s[CALL] == p[CALL]
            assert p[T0] <= s[T0] <= s[T1] <= p[T1]
            children.setdefault(s[PARENT], []).append(s)
    for kids in children.values():  # siblings never overlap
        assert all(a[T1] <= b[T0] for a, b in zip(kids, kids[1:]))
    parent_of = lambda s: rec[s[PARENT]][NAME]
    assert {parent_of(s) for s in rec if s[NAME].startswith("ipm.") and s[NAME] != "ipm.iter"} \
        == {"ipm.iter"}
    assert {parent_of(s) for s in rec if s[NAME] == "ipm.iter"} == {"scp.iter"}
    assert {parent_of(s) for s in rec if s[NAME] == "host_read"} == {"scp.call", "scp.iter"}
    covered = [0] * len(rec)  # what a span's children cover
    for s in rec:
        if s[PARENT] >= 0:
            covered[s[PARENT]] += s[T1] - s[T0]
    for c in calls:
        own = sum(s[T1] - s[T0] - covered[i] for i, s in enumerate(rec) if s[CALL] == c)
        assert own == rec[c][T1] - rec[c][T0]
    spent = self_times(rec)
    assert sum(v[0] for v in spent.values()) == sum(rec[c][T1] - rec[c][T0] for c in calls)
    assert spent["scp.call"][1:] == [2, 2] and all(v[0] >= 0 for v in spent.values())


def test_span_units_count_the_batched_iterations():
    """`scp.iter` spans of a call: its slowest lane's SCP iterations;
    `ipm.iter` units: the batched IPM iterations, which `collect_stats`
    counts independently (each round's slowest lane, summed over the
    rounds the early-exit call ran)."""
    solver, stack = _problem(B=4, scale=0.3)
    reads0 = tracing.COUNTS["host_read"]
    with tracing.recording() as rec:
        _, _, info = solver(stack)
    n_reads = tracing.COUNTS["host_read"] - reads0
    K = int(info["iters"].max())
    scp_iters = [s for s in rec if s[NAME] == "scp.iter"]
    assert len(scp_iters) == sum(s[N] for s in scp_iters) == K
    assert int(info["iters"].min()) < K  # lanes differ: the call runs to the slowest
    ipm = solver.rebuild(collect_stats=True)(stack)[2]["scan_stats"]["ipm_iters"]
    per_round = ipm.amax(0)[:K].tolist()
    assert sum(s[N] for s in rec if s[NAME] == "ipm.iter") == sum(per_round)
    by_round = [sum(1 for s in rec if s[NAME] == "ipm.iter" and s[PARENT] == rec.index(r))
                for r in scp_iters]
    assert by_round == per_round
    # a loop test for each SCP round and the exit, and for each IPM iteration
    # and the exit of each IPM loop
    reads = (K + 1) + sum(n + 1 for n in per_round)
    assert sum(1 for s in rec if s[NAME] == "host_read") == reads
    assert n_reads == reads


def test_pany_counts_one_host_read():
    c0 = tracing.COUNTS["host_read"]
    assert pany(torch.tensor([False, True])) and not pany(torch.zeros(3, dtype=torch.bool))
    assert tracing.COUNTS["host_read"] - c0 == 2


def _dub(x, u):
    return x + 0.1 * torch.cat([x[2:4], u])


def test_stream_host_reads_stat():
    """The stream's ``host_reads``: one a chunk, the final transfer and the
    IPM loop tests inside the chunks (244 on this stream, as `pany` counted
    them before the count moved into `tracing.COUNTS`)."""
    solver = build_scp_solver(_dub, N=8, xdim=4, udim=2, M=1, Nc=0, max_it=20, res_tol=1e-5,
                              has_u_bounds=True, accel="AA")
    rng = np.random.default_rng(5)
    x0 = np.ones((7, 1, 4)) + (0.1 + 0.25 * (np.arange(7) % 4))[:, None, None] \
        * rng.normal(size=(7, 1, 4))
    stream = [_instance(x0[i], 8, 2, torch.float64, "cpu") for i in range(7)]
    stats = {}
    with tracing.recording() as rec:
        solve_stream(solver, stream, B=3, chunk_it=3, stats=stats)
    reads = sum(1 for s in rec if s[NAME] == "host_read")
    assert stats["host_reads"] == stats["rounds"] + 1 + reads == 244


def test_profiler_range_inside_a_span_lies_within_its_stamps():
    """`torch.profiler` stamps its events with the recorder's clock
    (``time.time_ns``): a range opened inside a span lies within it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            with tracing.span("outer"):
                with torch.profiler.record_function("inner"):
                    torch.ones(1000).cumsum(0)
    (outer,) = rec
    (inner,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert outer[T0] <= inner.start_ns() <= inner.end_ns() <= outer[T1]


def test_busy_is_the_union_of_device_intervals():
    ev = [("a", 0, 10), ("b", 5, 10), ("c", 6, 2), ("d", 30, 5), ("e", 35, 1)]
    assert busy_ns(ev) == 15 + 6
    assert busy_ns([]) == 0
