"""CUDA graphs of the solver's host-bound phases: a function captured at its
key's second sighting and replayed over static copies of its inputs.

Its users, the box IPM's chunks of iterations (`solvers.ipm._ChunkGraph`)
and a fresh SCP round's linearization and assembly (`torch_scp._LinGraphs`),
keep caches of different scope. The IPM's, one for the process, holds 4: its
key names all that a chunk's graph records, so any solver of the same shapes
and options may replay it. The linearization's holds 2 a solver: its graph
records the solver's dynamics, which no key names.
"""

import collections

import torch

from .ops import chol_inv, hessian_apply
from .tracing import COUNTS, span


def engages(device_type: str, group) -> bool:
    """The rule both users share: a CUDA device and no particle group (its
    all-reduces stay eager)."""
    return device_type == "cuda" and group is None


def key(ins, *extra) -> tuple:
    """A graph's key: the inputs' shapes and dtypes (None for an absent
    input), their device, the matmul precision and the user's ``extra``."""
    return (tuple(None if t is None else (tuple(t.shape), t.dtype) for t in ins),
            next(t.device for t in ins if t is not None),
            torch.get_float32_matmul_precision(), *extra)


def copy_in(dst, src) -> None:
    """``d.copy_(s)`` for each pair whose ``d`` is not None, as one
    multi-tensor copy a dtype."""
    groups = {}
    for d, s in zip(dst, src):
        if d is not None:
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class Cache:
    """Captured graphs by key, at most ``size``, the least recently used
    dropped first. A key is captured at its second sighting, so a shape met
    once never pays for a capture; a key whose capture raised stays eager.
    A capture runs in the user's span ``name`` and counts in its counter."""

    SEEN_MAX = 64

    def __init__(self, size: int, name: str, counter: str):
        self.size, self.name, self.counter = size, name, counter
        self.graphs = collections.OrderedDict()  # key -> graph
        self.seen = collections.OrderedDict()  # keys met once and not captured
        self.refused = set()  # keys whose capture raised

    def get(self, key, capture):
        """The graph of ``key`` (made by ``capture()``); None: run eagerly."""
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph
        if key in self.refused:
            return None
        if self.seen.pop(key, None) is None:
            self.seen[key] = True
            if len(self.seen) > self.SEEN_MAX:
                self.seen.popitem(last=False)
            return None
        try:
            with span(self.name):
                graph = capture()
        except Exception:  # noqa: BLE001 - any refusal of the capture: run eager
            self.refused.add(key)
            return None
        COUNTS[self.counter] += 1
        self.graphs[key] = graph
        if len(self.graphs) > self.size:
            self.graphs.popitem(last=False)
        return graph


class CudaGraph(torch.cuda.CUDAGraph):
    """`torch.cuda.CUDAGraph` with the capture that `Captured` makes (the
    CPU tests put a stand-in in its place)."""

    def capture(self, fn):
        stream = torch.cuda.current_stream()
        try:
            with torch.cuda.graph(self):
                fn()
        finally:
            # a capture that fails in its end leaves the capture stream current
            torch.cuda.set_stream(stream)


class Captured:
    """``fn(*ins)`` captured as a graph over static copies of ``ins`` (None
    stays None), which `copy_in` fills; ``out``, what the capture returned,
    is written over at each replay. The kernel launches the capture recorded
    (`chol_inv.tally`, `hessian_apply.tally`) are counted at each replay."""

    def __init__(self, fn, ins=()):
        self.ins = [None if t is None else t.clone() for t in ins]
        self.graph = CudaGraph()

        def run():
            self.out = fn(*self.ins)

        with chol_inv.tally() as self.launches, hessian_apply.tally() as self.k5_launches:
            self.graph.capture(run)

    def copy_in(self, ins) -> None:
        copy_in(self.ins, ins)

    def replay(self):
        self.graph.replay()
        chol_inv.count_replay(self.launches)
        hessian_apply.count_replay(self.k5_launches)
        return self.out
