"""The box IPM's loop in chunks of iterations (`solvers.ipm._chunk`) and
their CUDA graphs (`solvers.ipm._ChunkGraph`); the mechanism under them is
held in `test_torch_graphs.py`. Chunks of k in {1, 2, 3, 8} turns give the
loop's bits on lanes that converge at different iterations, reach the cap
or freeze on a bad step, as do `ipm_core` and the fused solver on the graph
path (a stand-in runs the captured Python); the IPM's half of the engage
rule; the launches a capture and a replay count; the chunk length
(`ipm._chunk_len`). On the card (the ``cuda`` marker): graph against eager
on the headline batch and the pod-scale one, and the profiler's K1 and K3
events against their counters:
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_ipm_graph.py``.
"""

import pytest
import torch

from pmpc_tpu_torch import graphs, tracing
from pmpc_tpu_torch.ops import chol_inv, linalg
from pmpc_tpu_torch.solvers import ipm
from pmpc_tpu_torch.solvers.ipm import IPMState
from pmpc_tpu_torch.utils import lane_where
from torch_graph_standins import BOX, CAP, K1, K3, PROGRAMS, StandIn, cuda, headline, \
    pod, same, small_flagship, solve_recording_ipm, subproblem, traced_call  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_graphs(monkeypatch):
    """Each test runs on a cache of its own: no captured chunk, no sighting."""
    c = ipm._CACHE
    monkeypatch.setattr(ipm, "_CACHE", graphs.Cache(c.size, c.name, c.counter))


@pytest.fixture
def graph_path(monkeypatch):
    """``graph_path(k)`` puts the IPM on the graph path on the CPU: the
    engage rule passes, the stand-in takes the graph's place, chunks run k
    iterations."""
    def engage(k):
        monkeypatch.setattr(ipm, "_engages", lambda *a: True)
        monkeypatch.setattr(graphs, "CudaGraph", StandIn)
        monkeypatch.setattr(ipm, "_chunk_len", lambda lanes, cap: k)

    return engage


def _eager(subproblem):
    cqp, bounds, kw = subproblem
    return ipm.ipm_core(cqp, bounds, **kw)


def test_the_subproblem_has_every_kind_of_lane(subproblem):
    _, _, st = _eager(subproblem)
    assert st["iters"].tolist() == [1, 3, 5, CAP, 1]
    assert st["converged"].tolist() == [True, True, True, False, False]
    assert st["failed"].tolist() == [False, False, False, False, True]


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
    same(chunked, state, IPMState._fields)
    assert not bool(active.any())


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_graph_path_matches_eager(subproblem, graph_path, k):
    """`ipm_core` on the graph path (a key's third call) against the eager
    loop: uc, uf and every stat bit for bit. Its host reads are the tests
    between replays: none where a chunk covers the cap."""
    uc0, uf0, st0 = _eager(subproblem)
    graph_path(k)
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
def test_solver_on_the_graph_path_matches_eager(graph_path, k):
    """The fused SCP solver with its IPM on the graph path gives the eager
    solver's X, U and info bit for bit, and captures one chunk."""
    solver, data = small_flagship(B=5)
    X0, U0, info0 = solver(data)
    graph_path(k)
    captures = tracing.COUNTS["ipm_graph_capture"]
    X, U, info = solver(data)
    assert tracing.COUNTS["ipm_graph_capture"] - captures == 1
    assert torch.equal(X, X0) and torch.equal(U, U0)
    for name in info0:
        assert torch.equal(info[name], info0[name]), name


@pytest.mark.parametrize("changes,engages", [
    ({}, True),
    (dict(has_x=True), False),
    (dict(has_soc=True), False),
    (dict(has_ex=True), False),
    (dict(mu_target=1e-3), False),
    (dict(has_u=False), False),
    (dict(gondzio=2, predictor=False, tau=0.95), True),
])
def test_engage_rule(changes, engages):
    """The IPM's own half, on a CUDA device with no particle group (the
    shared half: `test_torch_graphs.py`): control bounds alone, no
    central-path target; the other options do not matter."""
    assert ipm._engages("cuda", BOX._replace(**changes), None) is engages


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
def test_capture_counts_nothing_and_each_replay_counts_once(subproblem, graph_path, counted,
                                                            k):
    """The eager loop counts a K1 and a K2 launch an iteration; a capture
    counts nothing; each replay counts the chunk's k of each."""
    graph_path(k)
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

    captured, real_get = [], ipm._CACHE.get

    def get(key, capture):  # the call's one lookup: here, the capture
        mid = read()
        graph = real_get(key, capture)
        captured.append([a - b for a, b in zip(read(), mid)])
        return graph

    ipm._CACHE.get = get  # the test's own cache (`no_graphs`)
    before = read()
    ipm.ipm_core(cqp, bounds, **kw)
    assert captured == [[0, 0, 0, 1, 0]]  # the capture: the count of captures alone
    graph = next(iter(ipm._CACHE.graphs.values()))
    assert graph.chunk.launches == {k1: k, k2: k} and not graph.layout.launches
    replays = -(-CAP // k)
    assert [a - b for a, b in zip(read(), before)] == [
        k * replays, k * replays, k * replays, 1, replays]


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_graph_matches_eager_on_the_card(cuda, monkeypatch, program):
    """The headline batch (f32, chunks of the cap 8) and the pod-scale one
    (f64, chunks of 6 under the cap 12): the same SCP and IPM iteration
    counts lane by lane, and U within 1e-6 in f32, 1e-10 in f64 (the same
    kernels on the same inputs; a bound, not bit equality, in case a
    library picks another algorithm under capture)."""
    solver, data = PROGRAMS[program](cuda)
    tol = {"headline": 1e-6, "pod": 1e-10}[program]
    solver(data)  # the capture
    replays = tracing.COUNTS["ipm_graph_replay"]
    _, U, its, ipm_its = solve_recording_ipm(solver, data, monkeypatch)
    assert tracing.COUNTS["ipm_graph_replay"] > replays
    monkeypatch.setattr(ipm, "_engages", lambda *a: False)
    _, U0, its0, ipm_its0 = solve_recording_ipm(solver, data, monkeypatch)
    assert torch.equal(its, its0)
    assert torch.equal(ipm_its, ipm_its0)
    assert (U - U0).abs().max().item() <= tol


@pytest.mark.cuda
def test_profiler_counts_the_replayed_k1(cuda):
    """Over a call on the graph path, the K1 kernels in the profiler's
    device trace are the K1 counter's increase, as the benchmark's
    ``k1_roofline_pct.batch`` needs."""
    events, (launches, counts) = traced_call(*headline(cuda), K1)
    assert tracing.COUNTS["ipm_graph_replay"] > counts["ipm_graph_replay"]
    assert len(events) == chol_inv.LAUNCHES["inv_cholesky_diag"] \
        - launches["inv_cholesky_diag"] > 0


@pytest.mark.cuda
def test_profiler_counts_the_replayed_k3(cuda):
    """Over a pod-scale call on the graph path (nf = 90: every IPM iteration
    factors with K3), the K3 kernels in the profiler's device trace are the
    K3 counter's increase, as the benchmark's ``k3_roofline_pct.pod`` needs,
    and no K1 runs."""
    events, (launches, counts) = traced_call(*pod(cuda), K3)
    assert tracing.COUNTS["ipm_graph_replay"] > counts["ipm_graph_replay"]
    assert len(events) == chol_inv.LAUNCHES["inv_cholesky_diag_big"] \
        - launches["inv_cholesky_diag_big"] > 0
    assert chol_inv.LAUNCHES["inv_cholesky_diag"] == launches["inv_cholesky_diag"]
