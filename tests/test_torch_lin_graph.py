"""A fresh SCP sub-iteration's linearization and condensed assembly as CUDA
graphs (`torch_scp._LinGraphs`, `torch_scp._LinGraph`):

- the graph path engages only on a CUDA device, with the condensed method
  and without a particle group (a table), and never on the CPU;
- a key is captured at its second sighting and not before, the cache keeps
  `LIN_GRAPH_CACHE` graphs a solver, and a key whose capture raised runs
  eagerly from then on, with the eager results;
- the solver on the graph path (here a stand-in replays the captured
  Python) gives the eager solver's f, fx, fu, every `CondensedQP` field,
  X, U and info bit for bit, with and without per-particle parameters, with
  and without ``lin_cost_fn``, and with ``relin_stale=1``, while each
  replay poisons the outputs of the one before (nothing may read them past
  the next replay);
- a call counts one capture and a replay for every fresh SCP round after
  the first sighting, and the Riccati routes never reach the graph;
- on the card (the ``cuda`` marker): graph and eager agree bit for bit on
  the headline batch (B = 64, M = 32, N = 30, f32) and on the pod-scale
  configuration (B = 4, M = 64, N = 50, f64): U, X, the SCP iteration
  counts and the IPM iteration counts of every subproblem; a call replays
  once for each fresh SCP round; the profiler's K1 (headline) and K3
  (pod-scale) events equal their counters' increase; a dynamics that
  synchronizes the device fails its capture and runs eagerly.

The card cases run with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_lin_graph.py``.
"""

import re

import pytest
import torch

import pmpc_tpu_torch.torch_scp as torch_scp
from pmpc_tpu_torch import tracing
from pmpc_tpu_torch.flagship import HEADLINE_KW, dubins, flagship, podscale, stack_varied
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.solvers import ipm
from pmpc_tpu_torch.solvers.reduced import CondensedQP
from pmpc_tpu_torch.torch_scp import _LinGraphs, _lin_engages

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _counts():
    return tracing.COUNTS["lin_graph_capture"], tracing.COUNTS["lin_graph_replay"]


class StandIn:
    """A CUDA graph's stand-in on the CPU: the capture runs the captured
    Python once, a replay runs it again (its launches and spans not
    recorded, as a replay runs no Python)."""

    def capture(self, fn):
        self.fn = fn
        fn()

    def replay(self):
        with chol_inv.tally(), tracing.recording():
            self.fn()


class Refusing(StandIn):
    """A capture that raises once it has run, as a capture that meets a
    host read raises at its end; ``attempts`` counts the captures tried."""

    attempts = 0

    def capture(self, fn):
        Refusing.attempts += 1
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")


def _poison(out):
    """NaN into every floating output of a replay (f, fx, fu and the QP)."""
    f, fx, fu, cqp = out
    for t in (f, fx, fu, *cqp):
        if t.is_floating_point():
            t.fill_(torch.nan)


@pytest.fixture
def graphs(monkeypatch):
    """``graphs(graph=StandIn)`` puts the linearization and assembly on the
    graph path on the CPU: the engage rule passes where it would on a card
    (the real rule with the device taken for CUDA), ``graph`` takes the
    graph's place, and each replay first poisons the outputs of the replay
    before."""
    def engage(graph=StandIn):
        monkeypatch.setattr(torch_scp, "_lin_engages",
                            lambda device_type, method, group: _lin_engages("cuda", method, group))
        monkeypatch.setattr(ipm, "_new_graph", graph)
        real_run = torch_scp._LinGraph.run

        def run(self, ins):
            _poison(self.out)
            return real_run(self, ins)

        monkeypatch.setattr(torch_scp._LinGraph, "run", run)

    return engage


@pytest.fixture
def recorded(monkeypatch):
    """Clones of (f, fx, fu, cqp) of every fresh sub-iteration, in order."""
    rec, real = [], torch_scp._LinGraphs.__call__

    def call(self, ins, engage):
        out = real(self, ins, engage)
        f, fx, fu, cqp = out
        rec.append((f.clone(), fx.clone(), fu.clone(),
                    CondensedQP(*(t.clone() for t in cqp))))
        return out

    monkeypatch.setattr(torch_scp._LinGraphs, "__call__", call)
    return rec


# -- the engage rule and the cache ------------------------------------------------

@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("method", ["condensed", "riccati", "priccati"])
@pytest.mark.parametrize("group", [None, object()], ids=["no_group", "group"])
def test_engage_rule(device_type, method, group):
    engages = device_type == "cuda" and method == "condensed" and group is None
    assert _lin_engages(device_type, method, group) is engages


def _toy(calls):
    """A `_LinGraphs` over a function that counts its calls and returns
    (f, fx, fu, cqp)-shaped outputs: sums of its inputs."""
    def fn(a, b):
        calls.append(a.shape)
        s = a.sum() + b.sum()
        return s[None], (2 * s)[None], (3 * s)[None], CondensedQP(*[s[None]] * 12)

    return _LinGraphs(fn)


def test_a_key_is_captured_at_its_second_sighting(monkeypatch):
    monkeypatch.setattr(ipm, "_new_graph", StandIn)
    calls = []
    lin = _toy(calls)
    a, b = torch.ones(3), torch.ones(2)
    c0, r0 = _counts()
    out = lin((a, b), True)
    assert _counts() == (c0, r0) and not lin.cache.graphs and out[0].item() == 5
    out = lin((a, b), True)  # the capture, then its first replay
    assert _counts() == (c0 + 1, r0 + 1) and len(lin.cache.graphs) == 1
    out = lin((2 * a, b), True)  # the same key: a replay over the new inputs
    assert _counts() == (c0 + 1, r0 + 2) and out[0].item() == 8
    lin((a, b), False)  # not engaged: eager, nothing counted
    assert _counts() == (c0 + 1, r0 + 2)


def test_the_cache_keeps_lin_graph_cache_graphs(monkeypatch):
    monkeypatch.setattr(ipm, "_new_graph", StandIn)
    lin = _toy([])
    sizes = range(1, torch_scp.LIN_GRAPH_CACHE + 2)
    c0, _ = _counts()
    for n in sizes:
        for _ in range(2):
            lin((torch.ones(n), torch.ones(2)), True)
    assert _counts()[0] == c0 + len(sizes)
    assert len(lin.cache.graphs) == torch_scp.LIN_GRAPH_CACHE
    assert all(key[0][0][0] != (1,) for key in lin.cache.graphs)  # the oldest key went first
    lin((torch.ones(1), torch.ones(2)), True)  # dropped: met anew, not captured
    assert _counts()[0] == c0 + len(sizes)


def test_a_refused_capture_runs_eager_from_then_on(monkeypatch):
    monkeypatch.setattr(ipm, "_new_graph", Refusing)
    calls = []
    lin = _toy(calls)
    a, b = torch.ones(3), torch.ones(2)
    Refusing.attempts = 0
    c0, r0 = _counts()
    outs = [lin((k * a, b), True)[0].item() for k in (1, 2, 3, 4)]
    assert outs == [5.0, 8.0, 11.0, 14.0]
    assert Refusing.attempts == 1 and _counts() == (c0, r0) and not lin.cache.graphs
    assert lin.cache.refused
    # the failed capture ran the function once, and its sub-iteration again
    assert len(calls) == 5


# -- the solver on the graph path -------------------------------------------------

def _flagship(B=3, **kw):
    """The headline program (box controls, AA, 8 IPM iterations a
    subproblem) cut to M = 4, N = 8, f64, over B lanes."""
    solver, data = flagship(M=4, N=8, Nc=2, dtype=torch.float64, device="cpu",
                            **dict(HEADLINE_KW, **kw))
    return solver, stack_varied(data, B, scale=0.3)


def _dubins_p(x, u, p):
    return dubins(x, u, (p[0], p[1], 0.3))


def _with_params(solver, data):
    """The same program with per-particle (v_scale, w_scale) parameters."""
    B, M = data.x0.shape[:2]
    p = 1.0 + 0.1 * torch.linspace(-1.0, 1.0, B * M * 2, dtype=data.Q.dtype)
    return torch_scp.build_scp_solver(_dubins_p, **solver.build_args), \
        data._replace(params=p.reshape(B, M, 2))


def _unbounded(solver, data):
    """The same program without its control box (`solve_eq`)."""
    return solver.rebuild(has_u_bounds=False), data


def _lin_cost(X, U, data):
    """A pull of every state's first coordinate toward 2 and of the
    controls toward 0.1, as gradients at the iterate."""
    cx = torch.zeros_like(X)
    cx[..., 0] = 0.5 * (X[..., 0] - 2.0)
    return cx, 0.05 * (U - 0.1)


CASES = {
    "plain": lambda: _flagship(),
    "params": lambda: _with_params(*_flagship()),
    "lin_cost_fn": lambda: _flagship(lin_cost_fn=_lin_cost),
    "relin_stale": lambda: _flagship(relin_stale=1),
    "unbounded": lambda: _unbounded(*_flagship()),
}


def _same_lin(a, b):
    assert len(a) == len(b)
    for r, (x, y) in enumerate(zip(a, b)):
        for name, s, t in zip(("f", "fx", "fu"), x[:3], y[:3]):
            assert torch.equal(s, t), (r, name)
        for name, s, t in zip(CondensedQP._fields, x[3], y[3]):
            assert s.dtype == t.dtype and torch.equal(s, t), (r, name)


@pytest.mark.parametrize("case", list(CASES))
def test_graph_path_matches_eager(case, graphs, recorded):
    """Each fresh sub-iteration's f, fx, fu and QP, and the call's X, U and
    info, on the graph path (two calls: the capture falls in the first's
    second round) against the eager solver, bit for bit."""
    solver, data = CASES[case]()
    X0, U0, info0 = solver(data)
    eager = list(recorded)
    recorded.clear()
    graphs()
    c0, r0 = _counts()
    for _ in range(2):
        X, U, info = solver(data)
        assert torch.equal(X, X0) and torch.equal(U, U0)
        assert info.keys() == info0.keys()
        for name in info0:
            assert torch.equal(info[name], info0[name]), name
        _same_lin(recorded, eager)
        recorded.clear()
    assert _counts() == (c0 + 1, r0 + 2 * len(eager) - 1)  # len(eager): the rounds


def test_collect_stats_and_return_state_match_eager(graphs):
    """``collect_stats`` (every round's IPM stats) and ``return_state`` (the
    IPM's warm tuple) on the graph path against the eager solver."""
    solver, data = _flagship(collect_stats=True, return_state=True)
    _, U0, info0 = solver(data)
    graphs()
    _, U, info = solver(data)
    assert torch.equal(U, U0)
    for name, st in info0["scan_stats"].items():
        assert torch.equal(info["scan_stats"][name], st), name
    for a, b in zip(info["solver_state"], info0["solver_state"]):
        assert torch.equal(a, b)


def test_a_refused_capture_gives_the_eager_solve(graphs):
    solver, data = _flagship()
    X0, U0, info0 = solver(data)
    graphs(Refusing)
    Refusing.attempts = 0
    c0, r0 = _counts()
    for _ in range(2):
        X, U, info = solver(data)
        assert torch.equal(X, X0) and torch.equal(U, U0)
        assert torch.equal(info["iters"], info0["iters"])
    assert Refusing.attempts == 1 and _counts() == (c0, r0)


@pytest.mark.parametrize("method", ["riccati", "priccati"])
def test_riccati_routes_never_reach_the_graph(graphs, method):
    solver, data = _flagship(method=method)
    graphs()
    c0, r0 = _counts()
    for _ in range(2):
        solver(data)
    assert _counts() == (c0, r0)


def test_cpu_never_captures(monkeypatch):
    """The CPU runs eager under the real engage rule, even with a graph
    object at hand."""
    monkeypatch.setattr(ipm, "_new_graph", StandIn)
    solver, data = _flagship()
    c0, r0 = _counts()
    for _ in range(3):
        solver(data)
    assert _counts() == (c0, r0)


def test_spans_of_a_capture_and_a_replay(graphs):
    """The capture's eager spans sit inside ``scp.capture``; a replay is an
    ``scp.linearize`` (the copy in) and an ``scp.assemble`` (the replay)
    with nothing inside, both under ``scp.iter``."""
    solver, data = _flagship()
    graphs()
    with tracing.recording() as rec:
        solver(data)
    name, parent = (lambda s: s[0]), (lambda s: rec[s[3]][0] if s[3] >= 0 else None)
    assert [parent(s) for s in rec if name(s) == "scp.capture"] == ["scp.iter"]
    lin = [s for s in rec if name(s) in ("scp.linearize", "scp.assemble")]
    assert {parent(s) for s in lin} == {"scp.iter", "scp.capture"}
    inside = [s for s in lin if parent(s) == "scp.capture"]
    assert [name(s) for s in inside] == ["scp.linearize", "scp.assemble"]
    parents = {s[3] for s in rec}
    replays = [i for i, s in enumerate(rec) if name(s) in ("scp.linearize", "scp.assemble")
               and parent(s) == "scp.iter"]
    assert replays and not parents.intersection(replays)  # no span inside a replay


# -- on the card ------------------------------------------------------------------

def _headline(dev):
    solver, data = flagship(dtype=torch.float32, device=dev, **HEADLINE_KW)
    return solver, stack_varied(data, 64)


def _pod(dev):
    """BASELINE config 5 as the benchmark's ``dubins_m64_n50_f64`` runs it
    (f64, res_tol 1e-3, 12 IPM iterations a subproblem), over 4 lanes."""
    solver, data = podscale(dtype=torch.float64, device=dev, res_tol=1e-3)
    return solver, stack_varied(data, 4, scale=0.02)


PROGRAMS = {"headline": _headline, "pod": _pod}


def _solve_recording_ipm(solver, data, monkeypatch):
    """(X, U, SCP iterations, the IPM iterations of each subproblem (S, B))."""
    its, real = [], torch_scp.ipm_core

    def record(*args, **kw):
        uc, uf, st = real(*args, **kw)
        its.append(st["iters"].clone())
        return uc, uf, st

    monkeypatch.setattr(torch_scp, "ipm_core", record)
    X, U, info = solver(data)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch_scp, "ipm_core", real)
    return X, U, info["iters"], torch.stack(its)


@pytest.mark.cuda
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_graph_matches_eager_on_the_card(cuda, monkeypatch, program):
    """The same kernels on the same inputs: U, X, the SCP and the IPM
    iteration counts bit for bit; a warm call replays once a fresh SCP
    round."""
    solver, data = PROGRAMS[program](cuda)
    solver(data)  # the first sighting, then the capture
    c0, r0 = _counts()
    X, U, its, ipm_its = _solve_recording_ipm(solver, data, monkeypatch)
    assert _counts() == (c0, r0 + int(its.max()))
    monkeypatch.setattr(torch_scp, "_lin_engages", lambda *a: False)
    X0, U0, its0, ipm_its0 = _solve_recording_ipm(solver, data, monkeypatch)
    assert _counts() == (c0, r0 + int(its.max()))
    assert torch.equal(its, its0)
    assert torch.equal(ipm_its, ipm_its0)
    assert torch.equal(U, U0) and torch.equal(X, X0)


K1 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,\s*32\s*,")
K3 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,\s*64\s*,")


@pytest.mark.cuda
@pytest.mark.parametrize("program,kernel,route", [
    ("headline", K1, "inv_cholesky_diag"), ("pod", K3, "inv_cholesky_diag_big")])
def test_profiler_counts_match_with_both_graphs(cuda, program, kernel, route):
    """Over a call on both graph paths, the K1 (headline) or K3 (pod-scale)
    events in the profiler's device trace are their counter's increase."""
    solver, data = PROGRAMS[program](cuda)
    solver(data)  # the captures, outside the trace, as the benchmark's warm-up
    torch.cuda.synchronize()
    n0, (c0, r0) = chol_inv.LAUNCHES[route], _counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solver(data)
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and kernel.search(e.name())]
    assert _counts()[0] == c0 and _counts()[1] > r0
    assert len(events) == chol_inv.LAUNCHES[route] - n0 > 0


@pytest.mark.cuda
def test_a_synchronizing_dynamics_runs_eager_on_the_card(cuda):
    """A dynamics that synchronizes the device cannot be captured: its key
    runs eagerly, with the eager results, and the solver works on."""
    def synced(x, u):
        torch.cuda.synchronize()
        return dubins(x, u)

    solver, data = _headline(cuda)
    X0, U0, info0 = solver(data)
    solver = torch_scp.build_scp_solver(synced, **solver.build_args)
    c0, r0 = _counts()
    for _ in range(2):
        X, U, info = solver(data)
        torch.cuda.synchronize()
        assert torch.equal(U, U0) and torch.equal(X, X0)
        assert torch.equal(info["iters"], info0["iters"])
    assert _counts() == (c0, r0)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
