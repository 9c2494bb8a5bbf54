"""The CUDA-graph mechanism (`pmpc_tpu_torch.graphs`), each case for both
users where it holds for both, the box IPM (`solvers.ipm`) and the SCP
round's linearization (`torch_scp._LinGraphs`), with a stand-in
(`torch_graph_standins.StandIn`) in the graph's place: engage rule, second
sighting, cache size, refusal, CPU, launch tally, copy-in and key."""

import pytest
import torch

import pmpc_tpu_torch.torch_scp as torch_scp
from pmpc_tpu_torch import graphs, tracing
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.solvers import ipm
from pmpc_tpu_torch.solvers.reduced import CondensedQP
from torch_graph_standins import BOX, CAP, Refusing, StandIn, same, small_flagship, \
    subproblem  # noqa: F401

torch.set_num_threads(2)


class IPMUser:
    """`ipm_core` on the subproblem, keys by the cap ``CAP + v``, values by
    a scale ``x`` of the tolerances; a call replays one chunk of the cap."""

    counters = ("ipm_graph_capture", "ipm_graph_replay")
    size = ipm.GRAPH_CACHE

    def __init__(self, monkeypatch, subproblem):
        self.monkeypatch, self.subproblem = monkeypatch, subproblem
        c = ipm._CACHE
        self.cache = graphs.Cache(c.size, c.name, c.counter)
        monkeypatch.setattr(ipm, "_CACHE", self.cache)

    def engages(self, device_type, group):
        return ipm._engages(device_type, BOX, group)

    def engage(self):
        self.monkeypatch.setattr(ipm, "_engages", lambda *a: True)
        self.monkeypatch.setattr(ipm, "_chunk_len", lambda lanes, cap: cap)

    def call(self, v, x=1.0):
        cqp, bounds, kw = self.subproblem
        uc, uf, st = ipm.ipm_core(cqp, bounds, **dict(
            kw, iters=CAP + v, tol_dynamic=x * kw["tol_dynamic"]))
        return (uc, uf, *st.values())

    def solve(self):
        """Runs a call; the cache it held."""
        self.call(0)
        return self.cache


class LinUser:
    """A `_LinGraphs` over a toy (f, fx, fu, cqp) of sums of its inputs,
    keys by the first input's length ``v + 1``, values by its scale ``x``."""

    counters = ("lin_graph_capture", "lin_graph_replay")
    size = torch_scp.LIN_GRAPH_CACHE

    def __init__(self, monkeypatch, subproblem):
        def fn(a, b):
            s = a.sum() + b.sum()
            return s[None], (2 * s)[None], (3 * s)[None], CondensedQP(*[s[None]] * 12)

        self.lin, self.engaged = torch_scp._LinGraphs(fn), False
        self.cache, self.monkeypatch = self.lin.cache, monkeypatch

    def engages(self, device_type, group):
        return torch_scp._lin_engages(device_type, "condensed", group)

    def engage(self):
        self.engaged = True

    def call(self, v, x=1.0):
        f, fx, fu, cqp = self.lin((x * torch.ones(v + 1), torch.ones(2)), self.engaged)
        return (f, fx, fu, *cqp)

    def solve(self):
        """Builds and runs the small flagship; its `_LinGraphs`' cache."""
        made, real = [], torch_scp._LinGraphs
        self.monkeypatch.setattr(torch_scp, "_LinGraphs",
                                 lambda fn: made.append(real(fn)) or made[0])
        solver, data = small_flagship()
        self.monkeypatch.setattr(torch_scp, "_LinGraphs", real)
        solver(data)
        return made[0].cache


@pytest.fixture(params=["ipm", "lin"])
def user(request, monkeypatch, subproblem):
    monkeypatch.setattr(graphs, "CudaGraph", StandIn)
    return {"ipm": IPMUser, "lin": LinUser}[request.param](monkeypatch, subproblem)


def _counts(user):
    return tuple(tracing.COUNTS[c] for c in user.counters)


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("group", [None, object()], ids=["no_group", "group"])
def test_engage_rule(user, device_type, group):
    """Each user's rule, its own half holding, is the shared half."""
    engages = device_type == "cuda" and group is None
    assert graphs.engages(device_type, group) is engages
    assert user.engages(device_type, group) is engages


def test_a_key_is_captured_at_its_second_sighting(user):
    """The first call of a key runs eager, the second captures and replays,
    the third replays over its own inputs; each gives the eager results."""
    eager = user.call(0), user.call(0, 2.0)  # not engaged: eager, unseen
    user.engage()
    c0, r0 = _counts(user)
    same(user.call(0), eager[0])
    assert _counts(user) == (c0, r0) and not user.cache.graphs
    same(user.call(0), eager[0])
    assert _counts(user) == (c0 + 1, r0 + 1) and len(user.cache.graphs) == 1
    same(user.call(0, 2.0), eager[1])  # the same key: a replay over new inputs
    assert _counts(user) == (c0 + 1, r0 + 2)


def test_the_cache_keeps_its_size(user):
    """Of size + 1 keys captured the cache keeps the last size; the first,
    dropped, is met anew: eager, neither captured nor replayed."""
    user.engage()
    assert user.cache.size == user.size
    c0, _ = _counts(user)
    for v in range(user.size + 1):
        for _ in range(2):
            user.call(v)
    assert _counts(user)[0] == c0 + user.size + 1 and len(user.cache.graphs) == user.size
    before = _counts(user)
    user.call(0)
    assert _counts(user) == before


def test_a_refused_capture_stays_eager(user, monkeypatch):
    """A capture that raises leaves its key to the eager path for good: the
    eager results, no capture or replay counted, no second attempt."""
    scales = (1.0, 2.0, 3.0, 4.0)
    eager = [user.call(0, x) for x in scales]
    monkeypatch.setattr(graphs, "CudaGraph", Refusing)
    user.engage()
    Refusing.attempts = 0
    c0, r0 = _counts(user)
    for x, ref in zip(scales, eager):
        same(user.call(0, x), ref)
    assert Refusing.attempts == 1 and _counts(user) == (c0, r0)
    assert not user.cache.graphs and len(user.cache.refused) == 1


def test_cpu_never_captures(user):
    """Under the real engage rule the CPU runs eager, even with a graph
    object at hand: the cache the solve holds is never consulted."""
    c0, r0 = _counts(user)
    caches = [user.solve() for _ in range(3)]
    assert _counts(user) == (c0, r0)
    assert not any(c.graphs or c.seen for c in caches)


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


def test_static_copies_and_the_copy_in(monkeypatch):
    """`Captured` runs ``fn`` over clones of its inputs (None stays None)
    and keeps what it returned; `copy_in` skips None and copies the rest as
    one `torch._foreach_copy_` a dtype, in the order met."""
    monkeypatch.setattr(graphs, "CudaGraph", StandIn)
    ins = [torch.ones(2), None, torch.arange(3, dtype=torch.int32), torch.full((1,), 2.0),
           torch.ones(2, dtype=torch.bool)]
    cap = graphs.Captured(lambda *ts: ts, ins)
    st = cap.ins
    assert st[1] is None and cap.out == tuple(st)
    assert all(s.data_ptr() != t.data_ptr() and torch.equal(s, t)
               for s, t in zip(st, ins) if t is not None)
    calls, real = [], torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda ds, ss: (calls.append([d.dtype for d in ds]), real(ds, ss)))
    new = [torch.full((2,), 5.0), None, torch.full((3,), 7, dtype=torch.int32),
           torch.full((1,), -1.0), torch.zeros(2, dtype=torch.bool)]
    cap.copy_in(new)
    assert calls == [[torch.float32] * 2, [torch.int32], [torch.bool]]
    assert all(torch.equal(s, t) for s, t in zip(st, new) if t is not None)


A, I = torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32)
KEY_CASES = {  # `graphs.key`'s arguments against ((A, I, None), 8)
    "values": ((torch.ones(2, 3), I + 1, None), 8), "shape": ((torch.zeros(3, 3), I, None), 8),
    "dtype": ((A.double(), I, None), 8), "absent": ((A, I, torch.zeros(1)), 8),
    "extra": ((A, I, None), 6), "precision": ((A, I, None), 8)}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_the_key_separates(case):
    """Shapes, dtypes, an absent input, the matmul precision and the
    user's extras each separate keys; the inputs' values do not."""
    prec = torch.get_float32_matmul_precision()
    k0 = graphs.key((A, I, None), 8)
    if case == "precision":
        torch.set_float32_matmul_precision("high" if prec == "medium" else "medium")
    try:
        k1 = graphs.key(*KEY_CASES[case])
    finally:
        torch.set_float32_matmul_precision(prec)
    assert (k1 != k0) is (case != "values")
    assert k0[1:] == (torch.device("cpu"), prec, 8)
