"""Spans at the layer boundaries of the solver, recorded in memory, and the
always-on counters.

``span(name, n)`` marks one piece of work: a batched SCP call, an SCP or IPM
iteration, a phase inside one. It is off unless a caller holds
`recording()` open: off, it hands back one shared object whose ``with`` does
nothing (no clock read, no allocation); on, it records

    (name, start_ns, end_ns, parent, call, n)

into the list `recording()` yields: ``parent`` is the index in that list of
the span open around it (-1: none), ``call`` the index of the outermost open
span, which identifies the request the span belongs to (the ``scp.call`` of
the solver), and ``n`` the work units the span covers (IPM or SCP
iterations), so a reader divides by the sum of ``n``, never by the number of
spans. Stamps are ``time.time_ns()``, the clock of ``torch.profiler``'s
event stamps, so a span and the device events of the same window compare
directly. Spans are recorded from one thread: the solver's.

`COUNTS` are integers counted whether or not a recording is open:
``host_read`` is the number of loop tests that read the device's answer on
the host (`particles.pany`); ``ipm_graph_capture`` and ``ipm_graph_replay``
the captures (`graphs.Cache`) and replays of the box IPM's chunks of
iterations as CUDA graphs (`solvers.ipm._ChunkGraph`); ``lin_graph_capture``
and ``lin_graph_replay`` those of a fresh SCP sub-iteration's linearization
and condensed assembly (`torch_scp._LinGraphs`), so replays over fresh SCP
rounds is the share of rounds that took the graph.

Where the box IPM runs as a CUDA graph, a replay is one ``ipm.iter`` span
with ``n`` the chunk's iterations; ``ipm.factor``, ``ipm.residual`` and
``ipm.solve`` then appear only at the capture, inside the span
``ipm.capture``, since a replay runs no Python. Where the linearization and
assembly run as a graph, ``scp.linearize`` covers the copy of the graph's
inputs and ``scp.assemble`` the replay, which runs both; at the capture the
eager ``scp.linearize`` and ``scp.assemble`` appear inside ``scp.capture``.
"""

from __future__ import annotations

import contextlib
import time

COUNTS = {"host_read": 0, "ipm_graph_capture": 0, "ipm_graph_replay": 0,
          "lin_graph_capture": 0, "lin_graph_replay": 0}

_clock = time.time_ns
_rec = None  # the list being recorded; None: off
_open = []  # (index, call) of the recorded spans still open, innermost last


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return None


OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "rec", "stack", "i", "parent", "call", "t0")

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __enter__(self):
        self.t0 = _clock()
        self.rec, self.stack = _rec, _open
        self.i = i = len(_rec)
        self.parent, self.call = _open[-1] if _open else (-1, i)
        _rec.append(self)  # the slot, filled when the span ends
        _open.append((i, self.call))
        return self

    def __exit__(self, typ, val, tb):
        t1 = _clock()
        self.stack.pop()
        self.rec[self.i] = (self.name, self.t0, t1, self.parent, self.call, self.n)


def span(name: str, n: int = 1):
    """A context manager that records ``name`` over its block while a
    `recording()` is open; ``n``: the work units the block covers."""
    if _rec is None:
        return OFF
    return _Span(name, n)


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block, which closes them all
    before it ends; yields the list of span tuples."""
    global _rec, _open
    prev = _rec, _open
    rec = _rec = []
    _open = []
    try:
        yield rec
    finally:
        _rec, _open = prev
