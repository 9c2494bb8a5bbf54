"""The cone IPM (`ipm_core` with ``has_soc``) on the CUDA-graph path
(`solvers.ipm._ChunkGraph`), at BASELINE config 3's shape as the benchmark's
``n20.soc.b512`` runs it (``portbench/configs/dubins_n20_soc.json``: M = 1,
N = 20, Nc = 0, box +-1, ||u_j|| <= 0.9 on every stage, f32, ``ipm_tau``
0.95), cut to a few lanes.

On the CPU a stand-in replays the captured Python in the graph's place
(`torch_graph_standins.StandIn`): chunks with cones give the eager loop's
bits, one cached graph holds each call's own radii, the fused solver on
the graph path gives the eager solver's bits, the span ``ipm.cone`` and
the counter ``ipm_cone_replay``; the SCP's retry from fresh duals after an
IPM gives up (``ipm_fresh_retry``, the cell's setting: on the card, config
3's lanes otherwise stalled there to ``max_it``) and, without it, the JAX
solver's retry from the warm start that gave up, on both routes; and the port against the KKT point of the
benchmark's plain reference (``portbench/reference/scp.py``) under the
cell's limits. On the card (the ``cuda`` marker), at (512, 40, 40):
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cone_graph.py``.
"""

import re

import pytest
import torch

import pmpc_tpu_torch.torch_scp as torch_scp
from pmpc_tpu_torch import graphs, tracing
from pmpc_tpu_torch.flagship import SOC_R3, baseline_config, stack_varied
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.solvers import ipm
from portbench import check, find, program
from portbench.reference import scp as reference
from torch_graph_standins import StandIn, cuda, same, small_flagship, \
    solve_recording_ipm, traced_call  # noqa: F401

torch.set_num_threads(2)

CELL = "n20.soc.b512"
TAU = 0.95  # the configuration's fraction to the boundary (ROADMAP F7)
# the benchmark's own pattern (``k2_roofline_pct.soc``)
K2 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*false\s*,\s*32\s*,")


@pytest.fixture(autouse=True)
def no_graphs(monkeypatch):
    """Each test runs on a cache of its own: no captured chunk, no sighting."""
    c = ipm._CACHE
    monkeypatch.setattr(ipm, "_CACHE", graphs.Cache(c.size, c.name, c.counter))


@pytest.fixture
def graph_path(monkeypatch):
    """``graph_path(k)`` puts the IPM on the graph path on the CPU: the
    engage rule passes, the stand-in takes the graph's place, chunks run k
    iterations (None: `ipm._chunk_len`'s)."""
    def engage(k=None):
        monkeypatch.setattr(ipm, "_engages", lambda *a: True)
        monkeypatch.setattr(graphs, "CudaGraph", StandIn)
        if k is not None:
            monkeypatch.setattr(ipm, "_chunk_len", lambda lanes, cap: k)

    return engage


def config3(B, device="cpu"):
    """Config 3 in f32 at tau 0.95 over B lanes (``stack_varied`` at the
    scale ``benchmarks/configs.py`` draws)."""
    solver, data, _ = baseline_config(3, torch.float32, device=device, ipm_tau=TAU)
    return solver, stack_varied(data, B, scale=0.02)


@pytest.fixture(scope="module")
def cone_subproblem():
    """Config 3's second (warm-started, with the cones' slacks and duals)
    subproblem over 4 lanes: (cqp, bounds, ipm_core keywords)."""
    solver, data = config3(4)
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
    assert kw["has_soc"] and len(kw["warm"]) == 6 and kw["tau"] == TAU
    assert cqp.Hff.shape[-1] == 40 and cqp.M == 1 and cqp.nc == 0
    return cqp, bounds, kw


def _call(sub, **changes):
    cqp, bounds, kw = sub
    return ipm.ipm_core(cqp, bounds, **dict(kw, **changes))


def _same_result(a, b):
    (uc, uf, st), (uc0, uf0, st0) = a, b
    assert torch.equal(uc, uc0) and torch.equal(uf, uf0)
    assert st.keys() == st0.keys()
    for name in st:
        assert torch.equal(st[name], st0[name]), name


def _counts():
    return {k: tracing.COUNTS[k] for k in ("ipm_graph_capture", "ipm_graph_replay",
                                          "ipm_cone_replay", "host_read")}


@pytest.mark.parametrize("k", [1, 7, 20])
def test_cone_chunks_match_the_eager_loop(cone_subproblem, graph_path, k):
    """`ipm_core` with cones on the graph path (a key's third call) against
    the eager loop: uc, uf and every stat (the cones' sq, zq among them)
    bit for bit; every replay counts as a cone replay."""
    eager = _call(cone_subproblem)
    assert eager[2]["converged"].all()
    graph_path(k)
    for _ in range(2):  # first sighting (eager), then the capture
        _call(cone_subproblem)
    before = _counts()
    out = _call(cone_subproblem)
    moved = {name: c - before[name] for name, c in _counts().items()}
    _same_result(out, eager)
    assert moved["ipm_graph_capture"] == 0
    assert moved["ipm_cone_replay"] == moved["ipm_graph_replay"] > 0
    # a host test between replays, and one after the last where it ends early
    replays, cap = moved["ipm_graph_replay"], cone_subproblem[2]["iters"]
    assert moved["host_read"] == replays - (replays == -(-cap // k))


def test_one_cached_graph_holds_each_calls_radii(cone_subproblem, graph_path):
    """The radii are inputs of the graph, copied in at every call: a graph
    captured at r = 0.9 replays a call at r = 0.75 (the same shapes, so the
    same key) to the eager loop's answer at 0.75, not the capture's."""
    socs = cone_subproblem[2]["socs"]
    tight = socs._replace(r_f=torch.full_like(socs.r_f, 0.75))
    eager, eager_tight = _call(cone_subproblem), _call(cone_subproblem, socs=tight)
    uf_norm = lambda out: out[1].reshape(-1, 2).norm(dim=-1).max()
    assert uf_norm(eager) > 0.85 and uf_norm(eager_tight) < 0.76  # the cone binds
    graph_path(7)
    _call(cone_subproblem)
    _call(cone_subproblem)  # the capture, at r = 0.9
    before = _counts()
    _same_result(_call(cone_subproblem, socs=tight), eager_tight)
    _same_result(_call(cone_subproblem), eager)
    moved = {name: c - before[name] for name, c in _counts().items()}
    assert moved["ipm_graph_capture"] == 0 and len(ipm._CACHE.graphs) == 1
    assert moved["ipm_cone_replay"] > 0


def test_box_keys_carry_no_radii(cone_subproblem, graph_path):
    """A call without cones keys its graph by what it keyed before the
    cones took the graph path: the inputs, the options, chunk and cap; a
    call with cones adds its radii's shapes."""
    graph_path(7)
    cqp, bounds, kw = cone_subproblem
    box_kw = dict(kw, has_soc=False, socs=None, warm=kw["warm"][:4])
    for _ in range(2):
        ipm.ipm_core(cqp, bounds, **box_kw)
    opts = ipm._Opts(True, False, False, False, kw["tol_exp"], kw["kappa"], 0.0, TAU, 0, True)
    assert list(ipm._CACHE.graphs) == [graphs.key([*cqp, *bounds, kw["tol_dynamic"]], opts,
                                                  7, kw["iters"])]
    for _ in range(2):
        _call(cone_subproblem)
    socs = kw["socs"]
    assert list(ipm._CACHE.graphs)[1] == graphs.key(
        [*cqp, *bounds, kw["tol_dynamic"], socs.r_c, socs.r_f], opts._replace(has_soc=True),
        7, kw["iters"])


def test_solver_with_cones_on_the_graph_path_matches_eager(graph_path):
    """The fused SCP solver at config 3 with its IPM on the graph path (the
    chunk length of `ipm._chunk_len`) gives the eager solver's X, U and
    info bit for bit; its subproblems replay chunks with cones."""
    solver, data = config3(4)
    X0, U0, info0 = solver(data)
    graph_path()
    before = _counts()
    X, U, info = solver(data)
    moved = {name: c - before[name] for name, c in _counts().items()}
    assert moved["ipm_graph_capture"] == 1
    assert moved["ipm_cone_replay"] == moved["ipm_graph_replay"] > 0
    same((X, U), (X0, U0), ("X", "U"))
    for name in info0:
        assert torch.equal(info[name], info0[name]), name


def test_cone_span_eager_and_at_the_capture(cone_subproblem, graph_path):
    """``ipm.cone`` opens inside every eager ``ipm.iter`` (the scaling and
    the blocks once, the step lengths once a direction: three times an
    iteration with the predictor); on the graph path only at the capture,
    inside ``ipm.capture``, and a replay records none."""
    with tracing.recording() as spans:
        _, _, st = _call(cone_subproblem)
    names = [s[0] for s in spans]
    iters = int(st["iters"].max())
    assert names.count("ipm.iter") == iters and names.count("ipm.cone") == 3 * iters
    assert all(spans[s[3]][0] == "ipm.iter" for s in spans if s[0] == "ipm.cone")
    graph_path(20)
    _call(cone_subproblem)
    with tracing.recording() as spans:
        _call(cone_subproblem)  # the capture
        n_capture = len(spans)
        _call(cone_subproblem)  # a replay
    parents = {spans[s[3]][0] for s in spans[:n_capture] if s[0] == "ipm.cone"}
    assert parents == {"ipm.capture"}
    assert "ipm.cone" not in [s[0] for s in spans[n_capture:]]


def _warms_with_lane0_given_up(monkeypatch, program, name):
    """The warm starts the IPM (``torch_scp.<name>``) got in a call's first
    three rounds, with lane 0's second IPM reported as given up or not."""
    solver, data = program()
    real = getattr(torch_scp, name)
    out = {}
    for give_up in (False, True):
        warms = []

        def ipm(*args, **kw):
            *rest, stats = real(*args, **kw)
            warms.append(kw["warm"])
            if give_up and len(warms) == 2:
                lane0 = torch.arange(len(stats["failed"])) == 0
                stats = dict(stats, failed=stats["failed"] | lane0)
            return (*rest, stats)

        monkeypatch.setattr(torch_scp, name, ipm)
        solver(data)
        out[give_up] = warms[:3]
    return out


RETRY_PROGRAMS = pytest.mark.parametrize("program,name", [
    (lambda **kw: small_flagship(B=3, **kw), "ipm_core"),
    (lambda **kw: baseline_config(3, torch.float64, device="cpu", **kw)[:2], "ipm_core"),
    (lambda **kw: baseline_config(3, torch.float64, device="cpu", method="riccati", **kw)[:2],
     "riccati_ipm_solve_scp"),
], ids=["box", "cones", "riccati_cones"])


@RETRY_PROGRAMS
def test_a_given_up_ipm_retries_from_fresh_duals(monkeypatch, program, name):
    """With ``ipm_fresh_retry``: a lane whose IPM gives up keeps its
    iterate, so its next round solves the same subproblem; from the warm
    start that gave up the IPM could give up again, round after round. That
    lane's next warm start keeps the primal point and starts the slacks and
    multipliers afresh (ones, the cones at the unit point e); the other
    lanes' warm starts are what they were."""
    out = _warms_with_lane0_given_up(
        monkeypatch, lambda: _stacked(lambda: program(ipm_fresh_retry=True)), name)
    (w1, w2, w3), (g1, g2, g3) = out[False], out[True]
    same(w1, g1)  # the first two rounds are the same
    same(w2, g2)
    same([t[1:] for t in g3], [t[1:] for t in w3])  # lanes 1, 2 as before
    assert torch.equal(g3[0][0], g2[0][0]) and torch.equal(g3[1][0], g2[1][0])  # the primal
    assert not (g2[2][0] == 1).all()  # the warm start that gave up is not the fresh one
    assert (g3[2][0] == 1).all() and (g3[3][0] == 1).all()
    if len(g3) == 6:
        e = torch.zeros_like(g3[4][0])
        e[:, 0] = 1.0
        assert torch.equal(g3[4][0], e) and torch.equal(g3[5][0], e)
        assert not torch.equal(g2[4][0], e)


@RETRY_PROGRAMS
def test_without_the_retry_a_given_up_ipm_keeps_its_warm_start(monkeypatch, program, name):
    """By default, as in the JAX solver, the round after a give-up starts
    from the warm start that gave up, slacks and multipliers too; the other
    lanes' warm starts are what they were."""
    out = _warms_with_lane0_given_up(monkeypatch, lambda: _stacked(program), name)
    (w1, w2, w3), (g1, g2, g3) = out[False], out[True]
    same(w1, g1)
    same(w2, g2)
    same([t[1:] for t in g3], [t[1:] for t in w3])
    same([t[0] for t in g3], [t[0] for t in g2])
    assert not (g3[2][0] == 1).all()


def _stacked(program):
    solver, data = program()
    if data.x0.dim() == 2:  # one (M, ...) problem: three lanes
        data = stack_varied(data, 3, scale=0.02)
    return solver, data


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_port_meets_the_reference_at_config3(seed):
    """The benchmark's cell at B = 8 on the CPU, from its traffic's draw:
    the port's U against the KKT point of the same problem, box and cones,
    that the plain f64 reference reaches from it, under the cell's
    ``u_err`` limit; every stage inside its cone by the configuration's
    ``soc_tol``. A lane's answer held against another lane's KKT point
    breaks the limit."""
    cell = find.cell(CELL)
    cfg, limit = cell["config"], cell["check"]["limits"]["u_err"]
    assert cfg["solver"]["ipm_tau"] == TAU and cfg["u_soc_r"] == SOC_R3
    mix = dict(cell["traffic"], B=8)
    x0 = torch.from_numpy(find.module("generators", mix["generator"]).x0_batch(cfg, mix, seed, 1))
    data = program.inputs(cfg, mix["B"], torch.device("cpu"))
    X, U, info = program.build(cfg)(data._replace(x0=x0.to(data.Q.dtype)))
    assert U.dtype == torch.float32 and info["converged"].all()
    assert (U.norm(dim=-1) - cfg["u_soc_r"]).max() <= cfg["soc_tol"]
    assert U.abs().max() <= cfg["u_hi"] + cfg["box_tol"]
    U_star, _, conv, its = reference.solve(
        program.dynamics(cfg), x0, data.X_ref.double(), data.U_ref.double(), cfg["q"],
        cfg["r"], cfg["u_lo"], cfg["u_hi"], cfg["Nc"], check.REF_TOL, check.REF_MAX_IT,
        check.REF_QP_TOL, U0=U.double(), soc_r=cfg["u_soc_r"])
    assert conv.all() and (its < check.REF_MAX_IT).all(), its
    assert ((U_star.norm(dim=-1) - SOC_R3).abs() < 1e-6).any()  # the cone binds
    assert (U.double() - U_star).abs().max() < limit
    assert (U[1].double() - U_star[0]).abs().max() > 2 * limit


def test_the_benchmarks_k5_reader_divides_by_cone_ipm_iterations():
    """``hessian_apply_us.soc``: K5's traced device time (ns in the trace)
    over the K2 launches (one a cone IPM iteration), in us; nothing where K5
    has no event (a program without it), no trace or no IPM iteration."""
    read = find.module("metrics", "hessian_apply_us.soc").read
    events = [("void (anonymous namespace)::hessian_apply_kernel<float, 4, true>(...)", 0, 3000),
              ("void (anonymous namespace)::hessian_apply_kernel<float, 4, true>(...)", 9, 5000),
              ("void chol_inv_kernel<float, false, 32, 8>(...)", 20, 7000)]
    rec = dict(trace=dict(events=events), launches=dict(inv_cholesky=4, inv_cholesky_diag=4))
    assert read(rec) == pytest.approx(2.0)
    assert read(dict(rec, trace=dict(events=events[2:]))) is None
    assert read(dict(rec, trace=None)) is None
    assert read(dict(rec, launches=dict(inv_cholesky_diag=4))) is None


def test_the_k2_roofline_reader_counts_k2s_own_bytes():
    """``k2_roofline_pct.soc`` at config 3's shape: the bound counts the
    lower triangle read and the block written, and not the diagonal of
    `portbench.kernels.chol_inv_bytes` that K2 never reads (at n = 40 f32
    K2 is bytes-bound, so the share is 2420/2460 of the count with it);
    where the trace lost K2 records and every launch has one shape, that
    shape's bound over the events it holds; nothing where it holds more
    events than launches, or fewer over two shapes, or there is no trace or
    no peak."""
    from portbench.kernels import PEAKS, chol_inv_bound_s

    read = find.module("metrics", "k2_roofline_pct.soc").read
    peak = PEAKS["H100"]
    k2 = ("void (anonymous namespace)::chol_inv_kernel<float, false, 32, 8>(...)", 0, 20000)
    k1 = ("void (anonymous namespace)::chol_inv_kernel<float, true, 32, 8>(...)", 5, 90000)
    rec = dict(trace=dict(events=[k2, k2, k2, k1]), peaks=peak,
               launches=dict(inv_cholesky=3, inv_cholesky_diag=1),
               shapes={("inv_cholesky", 512, 40, torch.float32): 3,
                       ("inv_cholesky_diag", 512, 40, torch.float32): 1})
    own = 512 * (40 * 41 // 2 + 40 * 40) * 4 / peak["bytes_per_s"]
    assert read(rec) == pytest.approx(100.0 * 3 * own / 60e-6, rel=1e-12)
    with_w = 100.0 * 3 * chol_inv_bound_s(512, 40, torch.float32, peak) / 60e-6
    assert read(rec) == pytest.approx(with_w * 2420 / 2460, rel=1e-12)
    # a lost record: one shape, so the bound of the events the trace holds
    assert read(dict(rec, trace=dict(events=[k2, k2, k1]))) == pytest.approx(
        100.0 * 2 * own / 40e-6, rel=1e-12)
    # fewer events over two shapes, or more events than launches: nothing
    two = {**rec["shapes"], ("inv_cholesky", 512, 20, torch.float32): 1}
    assert read(dict(rec, trace=dict(events=[k2, k2, k1]), shapes=two,
                     launches=dict(inv_cholesky=4, inv_cholesky_diag=1))) is None
    assert read(dict(rec, trace=dict(events=[k2] * 4 + [k1]))) is None
    assert read(dict(rec, trace=None)) is None
    assert read(dict(rec, peaks=None)) is None


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cone_graph_matches_eager_on_the_card(cuda, monkeypatch):
    """Config 3 at B = 512 (K2 at (512, 40, 40), chunks of 7 under the cap
    20): the graph path replays chunks with cones and gives the eager
    loop's SCP and IPM iteration counts lane by lane and its U bit for bit
    (the same kernels on the same inputs)."""
    solver, data = config3(512, cuda)
    solver(data)  # the capture
    before = _counts()
    _, U, its, ipm_its = solve_recording_ipm(solver, data, monkeypatch)
    moved = {name: c - before[name] for name, c in _counts().items()}
    assert moved["ipm_cone_replay"] == moved["ipm_graph_replay"] > 0
    assert moved["ipm_graph_capture"] == 0
    monkeypatch.setattr(ipm, "_engages", lambda *a: False)
    _, U0, its0, ipm_its0 = solve_recording_ipm(solver, data, monkeypatch)
    assert torch.equal(its, its0)
    assert torch.equal(ipm_its, ipm_its0)
    assert torch.equal(U, U0)


@pytest.mark.cuda
def test_profiler_counts_the_replayed_k2(cuda):
    """Over a config-3 call on the graph path, the K2 kernels in the
    profiler's device trace are at most the K2 counter's increase (the
    profiler may lose a few of a call's ~340,000 records), all at the one
    shape (512, 40, 40), as the benchmark's ``k2_roofline_pct.soc`` needs,
    and no K1 runs."""
    shapes = dict(chol_inv.SHAPES)
    events, (launches, counts) = traced_call(*config3(512, cuda), K2)
    assert tracing.COUNTS["ipm_cone_replay"] > counts["ipm_cone_replay"]
    assert 0 < len(events) <= chol_inv.LAUNCHES["inv_cholesky"] - launches["inv_cholesky"]
    assert chol_inv.LAUNCHES["inv_cholesky_diag"] == launches["inv_cholesky_diag"]
    assert {s for s, c in chol_inv.SHAPES.items() if c != shapes.get(s, 0)} == {
        ("inv_cholesky", 512, 40, torch.float32)}
