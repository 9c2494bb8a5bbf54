"""What the CUDA-graph tests share: stand-ins for ``graphs.CudaGraph`` on
the CPU, the programs they run, a bitwise comparison, and the card's
fixture and probes."""

import re

import pytest
import torch

import pmpc_tpu_torch.torch_scp as torch_scp
from pmpc_tpu_torch import tracing
from pmpc_tpu_torch.flagship import HEADLINE_KW, flagship, podscale, stack_varied
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.solvers.ipm import _Opts

CAP = 6  # the subproblem's IPM iteration cap
BOX = _Opts(has_u=True, has_x=False, has_soc=False, has_ex=False, tol_exp=-8, kappa=0.0,
            mu_target=0.0, tau=0.99, gondzio=0, predictor=True)  # the box-only path


class StandIn:
    """A CUDA graph's stand-in on the CPU. The capture runs the captured
    Python once (under `chol_inv.tally`, as the real capture does); a
    replay runs it again, its launches and spans not recorded, as a replay
    runs no Python."""

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


def same(a, b, names=None):
    """``a`` and ``b`` tensor for tensor, dtype and bits; a failure names
    the tensor (``names``, by default its place)."""
    assert len(a) == len(b)
    for name, x, y in zip(names or range(len(a)), a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def small_flagship(B=3, **kw):
    """The headline program (box controls, AA, 8 IPM iterations a
    subproblem) cut to M = 4, N = 8, f64, over B lanes."""
    solver, data = flagship(M=4, N=8, Nc=2, dtype=torch.float64, device="cpu",
                            **dict(HEADLINE_KW, **kw))
    return solver, stack_varied(data, B, scale=0.3)


@pytest.fixture(scope="module")
def subproblem():
    """The small flagship's second (warm-started) subproblem over 5 lanes
    with the cap at `CAP` and per-lane tolerances that end lanes 0-2 at
    iterations 1, 3 and 5, keep lane 3 to the cap, and a NaN cost that
    freezes lane 4 at its first step: (cqp, bounds, ipm_core keywords)."""
    solver, data = small_flagship(B=5)
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


# -- on the card ------------------------------------------------------------------

def headline(dev):
    """The headline batch: B = 64, M = 32, N = 30, f32 (K1 at nf = 50)."""
    solver, data = flagship(dtype=torch.float32, device=dev, **HEADLINE_KW)
    return solver, stack_varied(data, 64)


def pod(dev):
    """BASELINE config 5 as the benchmark's ``dubins_m64_n50_f64`` runs it
    (f64, res_tol 1e-3, 12 IPM iterations a subproblem), over 4 lanes: K3
    at (256, 90, 90), IPM chunks of 6."""
    solver, data = podscale(dtype=torch.float64, device=dev, res_tol=1e-3)
    return solver, stack_varied(data, 4, scale=0.02)


PROGRAMS = {"headline": headline, "pod": pod}
# the benchmark's own patterns (``k1_roofline_pct.batch``, ``k3_roofline_pct.pod``)
K1 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,")
K3 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,\s*64\s*,")


def solve_recording_ipm(solver, data, monkeypatch):
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


def traced_call(solver, data, kernel):
    """A call traced by the profiler after an untraced one (the captures, as
    the benchmark's warm-up): the device events that ``kernel`` matches, and
    `chol_inv.LAUNCHES` and `tracing.COUNTS` as they were before it."""
    solver(data)
    torch.cuda.synchronize()
    before = dict(chol_inv.LAUNCHES), dict(tracing.COUNTS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solver(data)
        torch.cuda.synchronize()
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and kernel.search(e.name())], before
