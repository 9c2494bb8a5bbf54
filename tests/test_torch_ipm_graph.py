"""The box IPM's loop in chunks of iterations (`solvers.ipm._chunk`) and
their CUDA graphs (`solvers.ipm._ChunkGraph`):

- k turns of the chunk, k in {1, 2, 3, 8}, give the bits of the loop with a
  host test each turn, on lanes that converge at different iterations, a
  lane at the cap and a lane frozen by a bad step; so does the graph path
  of `ipm_core` (here a stand-in runs the captured Python), and the fused
  SCP solver on it;
- the graph path engages only on a CUDA device, on the box-only path,
  without a particle group or a central-path target, and on a key's second
  sighting; the cache of graphs keeps `GRAPH_CACHE` keys; a key whose
  capture raised runs the eager loop from then on;
- a capture adds nothing to `chol_inv.LAUNCHES` or `SHAPES`, each replay
  adds the captured launches once, and `COUNTS` counts captures and
  replays;
- a chunk runs the fewest replays of at most its longest length that
  cover the cap, each as short as they allow (`ipm._chunk_len`);
- on the card (the ``cuda`` marker): graph and eager agree on the
  headline batch (B = 64, M = 32, N = 30, f32) and on the pod-scale
  configuration (B = 4, M = 64, N = 50, f64, cap 12), and the profiler's
  K1 events (headline) and K3 events (pod-scale) over a graph-path call
  equal their counter's increase.

The card cases run with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_ipm_graph.py``.
"""

import re

import pytest
import torch

import pmpc_tpu_torch.torch_scp as torch_scp
from pmpc_tpu_torch import tracing
from pmpc_tpu_torch.flagship import HEADLINE_KW, flagship, podscale, stack_varied
from pmpc_tpu_torch.ops import chol_inv, linalg
from pmpc_tpu_torch.solvers import ipm
from pmpc_tpu_torch.solvers.ipm import IPMState, _Opts
from pmpc_tpu_torch.utils import lane_where

torch.set_num_threads(2)
CAP = 6
BOX = _Opts(has_u=True, has_x=False, has_soc=False, has_ex=False, tol_exp=-8, kappa=0.0,
            mu_target=0.0, tau=0.99, gondzio=0, predictor=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def no_graphs(monkeypatch):
    """Each test runs on a cache of its own: no captured chunk, no sighting."""
    monkeypatch.setattr(ipm, "_CACHE", ipm._GraphCache(ipm.GRAPH_CACHE))


class StandIn:
    """A CUDA graph's stand-in on the CPU. The capture runs the chunk's
    Python once (under `chol_inv.tally`, as the real capture does); a
    replay runs it again, its launches not counted, as a replay runs no
    Python."""

    def capture(self, fn):
        self.fn = fn
        fn()

    def replay(self):
        with chol_inv.tally():
            self.fn()


@pytest.fixture
def graphs(monkeypatch):
    """``graphs(k)`` puts the IPM on the graph path on the CPU: the engage
    rule passes, the stand-in takes the graph's place, chunks run k
    iterations."""
    def engage(k):
        monkeypatch.setattr(ipm, "_engages", lambda *a: True)
        monkeypatch.setattr(ipm, "_new_graph", StandIn)
        monkeypatch.setattr(ipm, "_chunk_len", lambda lanes, cap: k)

    return engage


def _flagship(B=5):
    """The headline program (box controls, AA, 8 IPM iterations a
    subproblem) cut to M = 4, N = 8, f64, over B lanes."""
    solver, data = flagship(M=4, N=8, Nc=2, dtype=torch.float64, device="cpu", **HEADLINE_KW)
    return solver, stack_varied(data, B, scale=0.3)


@pytest.fixture(scope="module")
def subproblem():
    """The flagship's second (warm-started) subproblem over 5 lanes with
    the cap at 6 and per-lane tolerances that end lanes 0-2 at iterations
    1, 3 and 5, keep lane 3 to the cap, and a NaN cost that freezes lane
    4 at its first step: (cqp, bounds, ipm_core keywords)."""
    solver, data = _flagship()
    calls, real = [], torch_scp.ipm_core

    def record(cqp, bounds, **kw):
        calls.append((cqp, bounds, kw))
        return real(cqp, bounds, **kw)

    torch_scp.ipm_core = record
    try:
        solver(data)
    finally:
        torch_scp.ipm_core = real
    cqp, bounds, kw = calls[1]
    qf = cqp.qf.clone()
    qf[4] = torch.nan
    kw = dict(kw, iters=CAP, tol_exp=-12,
              tol_dynamic=torch.tensor([1e-1, 1e-4, 1e-8, 0.0, 0.0], dtype=torch.float64))
    return cqp._replace(qf=qf), bounds, kw


def _eager(subproblem):
    cqp, bounds, kw = subproblem
    return ipm.ipm_core(cqp, bounds, **kw)


def test_the_subproblem_has_every_kind_of_lane(subproblem):
    _, _, st = _eager(subproblem)
    assert st["iters"].tolist() == [1, 3, 5, CAP, 1]
    assert st["converged"].tolist() == [True, True, True, False, False]
    assert st["failed"].tolist() == [False, False, False, False, True]


def _same(a: IPMState, b: IPMState):
    for name, x, y in zip(IPMState._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_chunk_turns_match_the_loop(subproblem, k):
    """ceil(cap / k) chunks of k turns, with no host read, against the loop
    that tests on the host before each turn (as `ipm_core` ran it before
    chunks): the same state, bit for bit."""
    cqp, bounds, kw = subproblem
    opts = BOX._replace(tol_exp=kw["tol_exp"])
    init, body, _ = ipm._core(cqp, bounds, kw["tol_dynamic"], None, None, opts)
    state = init(kw["warm"])
    while True:
        active = ~state.done & (state.iters < CAP)
        if not bool(active.any()):
            break
        new = body(state)
        state = IPMState(*(lane_where(active, n, o) for n, o in zip(new, state)))

    chunked = init(kw["warm"])
    active = ipm._active(chunked, CAP)
    for _ in range(-(-CAP // k)):
        chunked, active = ipm._chunk(body, chunked, active, k, CAP)
    _same(chunked, state)
    assert not bool(active.any())


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_graph_path_matches_eager(subproblem, graphs, k):
    """`ipm_core` on the graph path (a key's third call) against the eager
    loop: uc, uf and every stat bit for bit. Its host reads are the tests
    between replays: none where a chunk covers the cap."""
    uc0, uf0, st0 = _eager(subproblem)
    graphs(k)
    cqp, bounds, kw = subproblem
    for _ in range(2):  # first sighting (eager), then the capture
        ipm.ipm_core(cqp, bounds, **kw)
    reads, replays = tracing.COUNTS["host_read"], tracing.COUNTS["ipm_graph_replay"]
    uc, uf, st = ipm.ipm_core(cqp, bounds, **kw)
    replays = tracing.COUNTS["ipm_graph_replay"] - replays
    assert torch.equal(uc, uc0) and torch.equal(uf, uf0)
    assert st.keys() == st0.keys()
    for name in st:
        assert torch.equal(st[name], st0[name]), name
    assert replays == -(-CAP // k)  # lane 3 runs to the cap
    assert tracing.COUNTS["host_read"] - reads == replays - 1


@pytest.mark.parametrize("k", [2, 8])
def test_solver_on_the_graph_path_matches_eager(graphs, k):
    """The fused SCP solver with its IPM on the graph path gives the eager
    solver's X, U and info bit for bit, and captures one chunk."""
    solver, data = _flagship()
    X0, U0, info0 = solver(data)
    graphs(k)
    captures = tracing.COUNTS["ipm_graph_capture"]
    X, U, info = solver(data)
    assert tracing.COUNTS["ipm_graph_capture"] - captures == 1
    assert torch.equal(X, X0) and torch.equal(U, U0)
    for name in info0:
        assert torch.equal(info[name], info0[name]), name


@pytest.mark.parametrize("device_type,changes,group,engages", [
    ("cuda", {}, None, True),
    ("cpu", {}, None, False),
    ("cuda", {}, object(), False),
    ("cuda", dict(has_x=True), None, False),
    ("cuda", dict(has_soc=True), None, False),
    ("cuda", dict(has_ex=True), None, False),
    ("cuda", dict(mu_target=1e-3), None, False),
    ("cuda", dict(has_u=False), None, False),
    ("cuda", dict(gondzio=2, predictor=False, tau=0.95), None, True),
])
def test_engage_rule(device_type, changes, group, engages):
    assert ipm._engages(device_type, BOX._replace(**changes), group) is engages


@pytest.mark.parametrize("cap,below,above", [(8, 8, 2), (12, 6, 2), (15, 8, 2), (5, 5, 2),
                                               (1, 1, 1)])
def test_chunk_len_divides_the_cap(cap, below, above):
    """On both sides of `CHUNK_LANES` (the headline cell's B M = 2,048 and the
    Monte-Carlo one's 32,768 among them), a chunk is the fewest replays of
    at most the side's longest chunk that cover the cap, each as short as
    they allow: caps up to 8 keep min(cap, 8) and min(cap, 2), cap 12 runs
    two replays of 6 (not of 8) below and six of 2 above."""
    for lanes, kmax, k in ((2048, ipm.CHUNK_MAX, below), (ipm.CHUNK_LANES, ipm.CHUNK_MAX, below),
                           (ipm.CHUNK_LANES + 1, ipm.CHUNK_ABOVE, above),
                           (32768, ipm.CHUNK_ABOVE, above)):
        assert ipm._chunk_len(lanes, cap) == k
        replays = -(-cap // k)
        assert k <= kmax and replays == -(-cap // kmax)
        assert k == -(-cap // replays)


def test_cpu_never_captures(subproblem):
    cqp, bounds, kw = subproblem
    captures = tracing.COUNTS["ipm_graph_capture"]
    for _ in range(3):
        ipm.ipm_core(cqp, bounds, **kw)
    assert tracing.COUNTS["ipm_graph_capture"] == captures and not ipm._CACHE.graphs


def test_a_key_is_captured_at_its_second_sighting(subproblem, graphs):
    """The first call of a key runs eager, the second captures, the third
    replays; another cap is another key; the cache keeps `GRAPH_CACHE`."""
    graphs(CAP)
    cqp, bounds, kw = subproblem
    count = lambda: (tracing.COUNTS["ipm_graph_capture"], tracing.COUNTS["ipm_graph_replay"])
    c0, r0 = count()
    ipm.ipm_core(cqp, bounds, **kw)
    assert count() == (c0, r0)
    ipm.ipm_core(cqp, bounds, **kw)
    assert count() == (c0 + 1, r0 + 1)
    ipm.ipm_core(cqp, bounds, **kw)
    assert count() == (c0 + 1, r0 + 2)
    for cap in range(CAP + 1, CAP + 1 + ipm.GRAPH_CACHE):
        for _ in range(2):
            ipm.ipm_core(cqp, bounds, **dict(kw, iters=cap))
    assert tracing.COUNTS["ipm_graph_capture"] == c0 + 1 + ipm.GRAPH_CACHE
    assert len(ipm._CACHE.graphs) == ipm.GRAPH_CACHE
    assert all(key[4] != CAP for key in ipm._CACHE.graphs)  # the oldest key went first


def test_a_refused_capture_runs_the_eager_loop(subproblem, graphs, monkeypatch):
    """A capture that raises leaves its key to the eager loop for good: the
    eager results, no capture counted, no second attempt."""
    uc0, uf0, st0 = _eager(subproblem)
    graphs(CAP)
    attempts = []

    class Refusing(StandIn):
        def capture(self, fn):
            attempts.append(fn)
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(ipm, "_new_graph", Refusing)
    cqp, bounds, kw = subproblem
    captures = tracing.COUNTS["ipm_graph_capture"]
    for _ in range(4):
        uc, uf, st = ipm.ipm_core(cqp, bounds, **kw)
        assert torch.equal(uc, uc0) and torch.equal(uf, uf0)
        assert all(torch.equal(st[name], st0[name]) for name in st0)
    assert len(attempts) == 1 and not ipm._CACHE.graphs
    assert tracing.COUNTS["ipm_graph_capture"] == captures


def test_tally_holds_a_capture_and_a_replay_counts_it_once():
    A = torch.eye(50).expand(8, 50, 50)
    key = ("inv_cholesky_diag", 8, 50, torch.float32)
    launches, shapes = dict(chol_inv.LAUNCHES), chol_inv.SHAPES.copy()
    with chol_inv.tally() as t:
        chol_inv._count("inv_cholesky_diag", A)
        chol_inv._count("inv_cholesky_diag", A)
    assert t == {key: 2}
    assert chol_inv.LAUNCHES == launches and chol_inv.SHAPES == shapes
    chol_inv.count_replay(t)
    chol_inv.count_replay(t)
    assert chol_inv.LAUNCHES["inv_cholesky_diag"] == launches["inv_cholesky_diag"] + 4
    assert chol_inv.SHAPES[key] == shapes[key] + 4


@pytest.fixture
def counted(monkeypatch):
    """The CPU's factors counted as the card's launches are."""
    def wrap(name, plain):
        def factor(A, *args, **kw):
            chol_inv._count(name + chol_inv._route(A.shape[-1]), A)
            return plain(A, *args, **kw)
        return factor

    monkeypatch.setattr(linalg, "inv_cholesky", wrap("inv_cholesky", chol_inv.inv_cholesky_plain))
    monkeypatch.setattr(linalg, "inv_cholesky_diag",
                        wrap("inv_cholesky_diag", chol_inv.inv_cholesky_diag_plain))


@pytest.mark.parametrize("k", [2, CAP])
def test_capture_counts_nothing_and_each_replay_counts_once(subproblem, graphs, counted, k):
    """The eager loop counts a K1 and a K2 launch an iteration; a capture
    counts nothing; each replay counts the chunk's k of each."""
    graphs(k)
    cqp, bounds, kw = subproblem
    n = cqp.Hff.shape[0] * cqp.M
    k1 = ("inv_cholesky_diag", n, cqp.nf, torch.float64)
    k2 = ("inv_cholesky", cqp.Hff.shape[0], cqp.nc, torch.float64)
    read = lambda: (chol_inv.LAUNCHES["inv_cholesky_diag"], chol_inv.SHAPES[k1],
                    chol_inv.SHAPES[k2], tracing.COUNTS["ipm_graph_capture"],
                    tracing.COUNTS["ipm_graph_replay"])
    before = read()
    ipm.ipm_core(cqp, bounds, **kw)  # eager: one K1 and one K2 a loop turn
    assert [a - b for a, b in zip(read(), before)] == [CAP, CAP, CAP, 0, 0]

    captured = []
    real_init = ipm._ChunkGraph.__init__

    def init(self, *args):
        mid = read()
        real_init(self, *args)
        captured.append([a - b for a, b in zip(read(), mid)])

    ipm._ChunkGraph.__init__ = init
    try:
        before = read()
        ipm.ipm_core(cqp, bounds, **kw)
    finally:
        ipm._ChunkGraph.__init__ = real_init
    assert captured == [[0, 0, 0, 1, 0]]  # the capture: the count of captures alone
    graph = next(iter(ipm._CACHE.graphs.values()))
    assert graph.chunk.launches == {k1: k, k2: k} and not graph.layout.launches
    replays = -(-CAP // k)
    assert [a - b for a, b in zip(read(), before)] == [
        k * replays, k * replays, k * replays, 1, replays]


# -- on the card ----------------------------------------------------------------

def _headline(dev):
    solver, data = flagship(dtype=torch.float32, device=dev, **HEADLINE_KW)
    return solver, stack_varied(data, 64)


def _pod(dev):
    """BASELINE config 5 as the benchmark's ``dubins_m64_n50_f64`` runs it
    (f64, res_tol 1e-3, 12 IPM iterations a subproblem), over 4 lanes: K3 at
    (256, 90, 90), chunks of 6."""
    solver, data = podscale(dtype=torch.float64, device=dev, res_tol=1e-3)
    return solver, stack_varied(data, 4, scale=0.02)


PROGRAMS = {"headline": (_headline, 1e-6), "pod": (_pod, 1e-10)}


def _solve_recording_ipm(solver, data, monkeypatch):
    """(U, SCP iterations, the IPM iterations of each subproblem (S, B))."""
    its, real = [], torch_scp.ipm_core

    def record(*args, **kw):
        uc, uf, st = real(*args, **kw)
        its.append(st["iters"].clone())
        return uc, uf, st

    monkeypatch.setattr(torch_scp, "ipm_core", record)
    _, U, info = solver(data)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch_scp, "ipm_core", real)
    return U, info["iters"], torch.stack(its)


@pytest.mark.cuda
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_graph_matches_eager_on_the_card(cuda, monkeypatch, program):
    """The headline batch (f32, chunks of the cap 8) and the pod-scale one
    (f64, chunks of 6 under the cap 12): the same SCP and IPM iteration
    counts lane by lane, and U within 1e-6 in f32, 1e-10 in f64 (the same
    kernels on the same inputs; a bound, not bit equality, in case a
    library picks another algorithm under capture)."""
    make, tol = PROGRAMS[program]
    solver, data = make(cuda)
    solver(data)  # the capture
    replays = tracing.COUNTS["ipm_graph_replay"]
    U, its, ipm_its = _solve_recording_ipm(solver, data, monkeypatch)
    assert tracing.COUNTS["ipm_graph_replay"] > replays
    monkeypatch.setattr(ipm, "_engages", lambda *a: False)
    U0, its0, ipm_its0 = _solve_recording_ipm(solver, data, monkeypatch)
    assert torch.equal(its, its0)
    assert torch.equal(ipm_its, ipm_its0)
    assert (U - U0).abs().max().item() <= tol


@pytest.mark.cuda
def test_profiler_counts_the_replayed_k1(cuda):
    """Over a call on the graph path, the K1 kernels in the profiler's
    device trace are the K1 counter's increase, as the benchmark's
    ``k1_roofline_pct.batch`` needs."""
    solver, data = _headline(cuda)
    solver(data)  # the capture, outside the trace, as the benchmark's warm-up
    torch.cuda.synchronize()
    k1 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,")
    n0, r0 = chol_inv.LAUNCHES["inv_cholesky_diag"], tracing.COUNTS["ipm_graph_replay"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solver(data)
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and k1.search(e.name())]
    assert tracing.COUNTS["ipm_graph_replay"] > r0
    assert len(events) == chol_inv.LAUNCHES["inv_cholesky_diag"] - n0 > 0


@pytest.mark.cuda
def test_profiler_counts_the_replayed_k3(cuda):
    """Over a pod-scale call on the graph path (nf = 90: every IPM iteration
    factors with K3), the K3 kernels in the profiler's device trace are the
    K3 counter's increase, as the benchmark's ``k3_roofline_pct.pod`` needs,
    and no K1 runs."""
    solver, data = _pod(cuda)
    solver(data)  # the capture, outside the trace, as the benchmark's warm-up
    torch.cuda.synchronize()
    k3 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,\s*64\s*,")
    n0, r0 = chol_inv.LAUNCHES["inv_cholesky_diag_big"], tracing.COUNTS["ipm_graph_replay"]
    k1 = chol_inv.LAUNCHES["inv_cholesky_diag"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solver(data)
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and k3.search(e.name())]
    assert tracing.COUNTS["ipm_graph_replay"] > r0
    assert len(events) == chol_inv.LAUNCHES["inv_cholesky_diag_big"] - n0 > 0
    assert chol_inv.LAUNCHES["inv_cholesky_diag"] == k1
