"""Cold batches, closed loop: every call solves a fresh batch of B scenarios,
and the next call starts when the last one has returned.

Scenario b of call k: its M particles start at ones + ``particle_sigma``
N(0, I) each, shifted together by ``spread`` N(0, I) (the flagship's draw),
tracking the origin. Call k's draw comes from (seed, k) alone, so any call
is made again for the check; call 0 is the warm-up's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import program


def x0_batch(cfg, mix, seed, k):
    """Call k's start states, numpy (B, M, xdim) float64."""
    rng = np.random.default_rng([seed, k])
    B, M, xd = mix["B"], cfg["M"], cfg["xdim"]
    return (np.ones((B, M, xd)) + mix["particle_sigma"] * rng.normal(size=(B, M, xd))
            + mix["spread"] * rng.normal(size=(B, 1, xd)))


def setup(run):
    """Build the solver and the batch's constant inputs, and warm up every
    shape the window uses with one call."""
    cfg, mix = run.cfg, run.mix
    solver = run.build(cfg)
    run.mark("program")
    program.load_kernels(run.device)
    run.mark("kernel_load")
    st = dict(solver=solver, data=program.inputs(cfg, mix["B"], run.device))
    run.mark("inputs")
    call(run, st, 0)
    run.mark("warm_call")
    return st


def call(run, st, k):
    """One timed call: call k's inputs built and sent, the batch solved, the
    device synchronised."""
    x0 = torch.from_numpy(x0_batch(run.cfg, run.mix, run.seed, k)).to(
        run.device, st["data"].Q.dtype)
    X, U, info = st["solver"](st["data"]._replace(x0=x0))
    run.sync()
    return dict(k=k, X=X, U=U, converged=info["converged"], iters=info["iters"])


def window(run, st, seconds):
    """Calls back to back until ``seconds`` have passed; each record holds
    the call's host times and outputs."""
    out, k = [], 1
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            rec = call(run, st, k)
        except Exception as exc:  # a call that raised counts as B failed solves
            rec = dict(k=k, error=repr(exc))
        rec.update(t0=t0, t1=time.perf_counter(), n=run.mix["B"])
        out.append(rec)
        k += 1
        if rec["t1"] - t_start >= seconds:
            return out


def answers(run, records):
    """The window's solves for the check: their inputs made again from the
    seed, and what the solver returned."""
    ok = [r for r in records if "error" not in r]
    if not ok:
        return None
    dt = torch.float64
    x0 = torch.cat([torch.from_numpy(x0_batch(run.cfg, run.mix, run.seed, r["k"]))
                    for r in ok]).to(run.device, dt)
    L, M, N = x0.shape[0], run.cfg["M"], run.cfg["N"]
    return dict(x0=x0,
                X_ref=torch.zeros(L, M, N, run.cfg["xdim"], dtype=dt, device=run.device),
                U_ref=torch.zeros(L, M, N, run.cfg["udim"], dtype=dt, device=run.device),
                U=torch.cat([r["U"] for r in ok]), X=torch.cat([r["X"] for r in ok]),
                converged=torch.cat([r["converged"] for r in ok]),
                iters=torch.cat([r["iters"] for r in ok]))
