"""A fresh SCP sub-iteration's linearization and condensed assembly as CUDA
graphs (`torch_scp._LinGraphs`); the mechanism under
them is held in `test_torch_graphs.py`. The linearization's half of the
engage rule; the solver on the graph path (a stand-in replays the captured
Python and poisons the last replay's outputs, which nothing may read past
the next replay) against the eager solver bit for bit, f, fx, fu, every
`CondensedQP` field, X, U and info, with params, ``lin_cost_fn``,
``relin_stale=1``, unbounded, a refused capture; one replay a fresh SCP
round; the Riccati routes never reach the graph; the spans. On the card
(the ``cuda`` marker): graph against eager bit for bit on the headline and
pod-scale programs, the profiler's K1 and K3 events against their
counters, a synchronizing dynamics that stays eager:
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_lin_graph.py``.
"""

import pytest
import torch

import pmpc_tpu_torch.torch_scp as torch_scp
from pmpc_tpu_torch import graphs, tracing
from pmpc_tpu_torch.flagship import dubins
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.solvers.reduced import CondensedQP
from pmpc_tpu_torch.torch_scp import _lin_engages
from torch_graph_standins import K1, K3, PROGRAMS, Refusing, StandIn, cuda, headline, \
    same, small_flagship, solve_recording_ipm, traced_call  # noqa: F401

torch.set_num_threads(2)


def _counts():
    return tracing.COUNTS["lin_graph_capture"], tracing.COUNTS["lin_graph_replay"]


def _poison(out):
    """NaN into every floating output of a replay (f, fx, fu and the QP)."""
    f, fx, fu, cqp = out
    for t in (f, fx, fu, *cqp):
        if t.is_floating_point():
            t.fill_(torch.nan)


@pytest.fixture
def graph_path(monkeypatch):
    """``graph_path(graph=StandIn)``: the real engage rule with the device
    taken for CUDA, ``graph`` in the graph's place, and each replay first
    poisons the outputs of the replay before."""
    def engage(graph=StandIn):
        monkeypatch.setattr(torch_scp, "_lin_engages",
                            lambda device_type, method, group: _lin_engages("cuda", method, group))
        monkeypatch.setattr(graphs, "CudaGraph", graph)
        real_copy_in = graphs.Captured.copy_in

        def copy_in(self, ins):  # before the copy: an output may alias an input
            _poison(self.out)
            real_copy_in(self, ins)

        monkeypatch.setattr(graphs.Captured, "copy_in", copy_in)

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


@pytest.mark.parametrize("method,engages", [
    ("condensed", True), ("riccati", False), ("priccati", False)])
def test_engage_rule(method, engages):
    """The linearization's own half, on a CUDA device with no particle
    group (the shared half: `test_torch_graphs.py`): the condensed method."""
    assert _lin_engages("cuda", method, None) is engages


# -- the solver on the graph path -------------------------------------------------

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
    "plain": lambda: small_flagship(),
    "params": lambda: _with_params(*small_flagship()),
    "lin_cost_fn": lambda: small_flagship(lin_cost_fn=_lin_cost),
    "relin_stale": lambda: small_flagship(relin_stale=1),
    "unbounded": lambda: _unbounded(*small_flagship()),
}


def _same_lin(a, b):
    assert len(a) == len(b)
    names = ("f", "fx", "fu", *CondensedQP._fields)
    for r, (x, y) in enumerate(zip(a, b)):
        same((*x[:3], *x[3]), (*y[:3], *y[3]), [(r, n) for n in names])


@pytest.mark.parametrize("case", list(CASES))
def test_graph_path_matches_eager(case, graph_path, recorded):
    """Each fresh sub-iteration's f, fx, fu and QP, and the call's X, U and
    info, on the graph path (two calls: the capture falls in the first's
    second round) against the eager solver, bit for bit."""
    solver, data = CASES[case]()
    X0, U0, info0 = solver(data)
    eager = list(recorded)
    recorded.clear()
    graph_path()
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


def test_collect_stats_and_return_state_match_eager(graph_path):
    """``collect_stats`` (every round's IPM stats) and ``return_state`` (the
    IPM's warm tuple) on the graph path against the eager solver."""
    solver, data = small_flagship(collect_stats=True, return_state=True)
    _, U0, info0 = solver(data)
    graph_path()
    _, U, info = solver(data)
    assert torch.equal(U, U0)
    for name, st in info0["scan_stats"].items():
        assert torch.equal(info["scan_stats"][name], st), name
    for a, b in zip(info["solver_state"], info0["solver_state"]):
        assert torch.equal(a, b)


def test_a_refused_capture_gives_the_eager_solve(graph_path):
    solver, data = small_flagship()
    X0, U0, info0 = solver(data)
    graph_path(Refusing)
    Refusing.attempts = 0
    c0, r0 = _counts()
    for _ in range(2):
        X, U, info = solver(data)
        assert torch.equal(X, X0) and torch.equal(U, U0)
        assert torch.equal(info["iters"], info0["iters"])
    assert Refusing.attempts == 1 and _counts() == (c0, r0)


@pytest.mark.parametrize("method", ["riccati", "priccati"])
def test_riccati_routes_never_reach_the_graph(graph_path, method):
    solver, data = small_flagship(method=method)
    graph_path()
    c0, r0 = _counts()
    for _ in range(2):
        solver(data)
    assert _counts() == (c0, r0)


def test_spans_of_a_capture_and_a_replay(graph_path):
    """The capture's eager spans sit inside ``scp.capture``; a replay is an
    ``scp.linearize`` (the copy in) and an ``scp.assemble`` (the replay)
    with nothing inside, both under ``scp.iter``."""
    solver, data = small_flagship()
    graph_path()
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

@pytest.mark.cuda
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_graph_matches_eager_on_the_card(cuda, monkeypatch, program):
    """The same kernels on the same inputs: U, X, the SCP and the IPM
    iteration counts bit for bit; a warm call replays once a fresh SCP
    round."""
    solver, data = PROGRAMS[program](cuda)
    solver(data)  # the first sighting, then the capture
    c0, r0 = _counts()
    X, U, its, ipm_its = solve_recording_ipm(solver, data, monkeypatch)
    assert _counts() == (c0, r0 + int(its.max()))
    monkeypatch.setattr(torch_scp, "_lin_engages", lambda *a: False)
    X0, U0, its0, ipm_its0 = solve_recording_ipm(solver, data, monkeypatch)
    assert _counts() == (c0, r0 + int(its.max()))
    assert torch.equal(its, its0)
    assert torch.equal(ipm_its, ipm_its0)
    assert torch.equal(U, U0) and torch.equal(X, X0)


@pytest.mark.cuda
@pytest.mark.parametrize("program,kernel,route", [
    ("headline", K1, "inv_cholesky_diag"), ("pod", K3, "inv_cholesky_diag_big")])
def test_profiler_counts_match_with_both_graphs(cuda, program, kernel, route):
    """Over a call on both graph paths, the K1 (headline) or K3 (pod-scale)
    events in the profiler's device trace are their counter's increase."""
    events, (launches, counts) = traced_call(*PROGRAMS[program](cuda), kernel)
    c0, r0 = counts["lin_graph_capture"], counts["lin_graph_replay"]
    assert _counts()[0] == c0 and _counts()[1] > r0
    assert len(events) == chol_inv.LAUNCHES[route] - launches[route] > 0


@pytest.mark.cuda
def test_a_synchronizing_dynamics_runs_eager_on_the_card(cuda):
    """A dynamics that synchronizes the device cannot be captured: its key
    runs eagerly, with the eager results, and the solver works on."""
    def synced(x, u):
        torch.cuda.synchronize()
        return dubins(x, u)

    solver, data = headline(cuda)
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
