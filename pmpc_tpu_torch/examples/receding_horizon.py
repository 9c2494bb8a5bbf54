"""Closed-loop receding-horizon MPC with warm starts, the twin of
``examples/receding_horizon.py`` (the reference's warm-start workflow:
shift ``X_prev/U_prev`` each step and anchor the first action with the
slew term).

A unicycle car tracks a moving waypoint for T steps. Each control step:
 1. solve the horizon problem warm-started from the SHIFTED previous plan
    and the IPM point the previous call returned,
 2. apply the first control to the plant,
 3. anchor the next solve's first action to it.

The loop runs the fused solver (`build_scp_solver`): one solver call and one
device-to-host read per control step. ``PMPC_RH_HOST=1`` adds the same loop
through the host-loop API ``pmpc_tpu_torch.solve`` for comparison.

    python3 -m pmpc_tpu_torch.examples.receding_horizon [--device cpu]

``PMPC_EXAMPLES_FAST=1`` runs the smoke sizes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import pmpc_tpu_torch
from pmpc_tpu_torch.torch_scp import SCPData, build_scp_solver, make_scp_data
from pmpc_tpu_torch.utils import default_device, numpy_dtype, to_host

from ._common import DT, fast, run, settings, unicycle


def plant_step(x, u):
    px, py, v, th = x
    return np.array([
        px + DT * v * np.cos(th),
        py + DT * v * np.sin(th),
        v + DT * u[0],
        th + DT * u[1],
    ])


def closed_loop_fused(N, T, xdim, udim, shift_warm=True, carry_duals=True, quiet=False,
                      device=None, dtype=torch.float32, **build_kw):
    """One fused solver call per control step: (ms a step, tracking errors,
    SCP iterations a step).

    ``shift_warm`` / ``carry_duals`` switch the two warm starts: the shifted
    plan (X_prev/U_prev) and the IPM primal/dual/slack point carried across
    control steps (``info["solver_state"]``, which stays on the device in
    its dtype). ``build_kw`` extends the solver build."""
    dev = default_device() if device is None else torch.device(device)
    nd = numpy_dtype(dtype)
    # max_it well above the warm-started need: the loop exits early on
    # convergence, so the cap costs nothing and the counts show the warm start
    bk = dict(max_it=3 if fast() else 15, res_tol=1e-4)
    bk.update(build_kw)
    solver = build_scp_solver(unicycle, N=N, xdim=xdim, udim=udim, M=1, Nc=0,
                              has_u_bounds=True, return_state=True, **bk)
    Q = np.tile(np.eye(xdim, dtype=nd), (1, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(nd), (1, N, 1, 1))
    u_l = -np.ones((1, N, udim), nd)
    u_u = np.ones((1, N, udim), nd)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    x = np.zeros(xdim, nd)
    X_prev = U_prev = None
    u_last = np.zeros(udim, nd)
    state = None  # the IPM point carried across control steps
    errs, times, iters_log = [], [], []
    for t in range(T):
        target = np.array([0.1 * t + 1.0, 1.0, 0.0, 0.0], nd)
        sync()
        t0 = time.perf_counter()
        one = make_scp_data(
            x[None], Q, R, X_ref=np.tile(target, (1, N, 1)), X_prev=X_prev, U_prev=U_prev,
            reg_x=1.0, reg_u=0.1, slew_reg=0.5, slew_reg0=0.5 if t else 0.0,
            slew_um1=u_last[None], u_l=u_l, u_u=u_u, device=dev)
        X, U, info = solver(SCPData(*(None if a is None else a[None] for a in one)), state)
        if carry_duals:
            state = info["solver_state"]
        # the step's one host read: the plan and the iteration count
        Xh, Uh, it = to_host([X[0, 0], U[0, 0], info["iters"]])
        u = Uh[0].astype(nd)
        times.append(time.perf_counter() - t0)
        iters_log.append(int(it[0]))
        x = plant_step(x, u).astype(nd)
        errs.append(float(np.linalg.norm(x[:2] - target[:2])))
        if shift_warm:
            # shift the plan one step (repeat the tail)
            Xs = Xh[2:]  # drop the x0 row and the consumed step
            X_prev = np.concatenate([Xs, Xs[-1:]], axis=0)[None]
            Us = Uh[1:]
            U_prev = np.concatenate([Us, Us[-1:]], axis=0)[None]
        u_last = u
    if not quiet:
        print(f"  SCP iterations: cold {iters_log[0]}, warm median "
              f"{int(np.median(iters_log[1:]))} (max_it cap {bk['max_it']})")
    return np.array(times) * 1e3, errs, iters_log


def closed_loop_host(N, T, xdim, udim, device=None, dtype=None):
    """The same loop through the host-loop API."""
    dev = default_device() if device is None else torch.device(device)
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(unicycle, device=dev)
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    x = np.zeros(xdim)
    X_prev = U_prev = None
    u_last = None
    errs, times = [], []
    for t in range(T):
        target = np.array([0.1 * t + 1.0, 1.0, 0.0, 0.0])
        t0 = time.perf_counter()
        X, U, data = pmpc_tpu_torch.solve(
            f_fn, Q, R, x, X_ref=np.tile(target, (N, 1)),
            X_prev=X_prev, U_prev=U_prev,
            u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
            slew_rate=0.5, u0_slew=u_last, reg_x=1.0, reg_u=1e-1,
            max_it=3 if fast() else (20 if t == 0 else 6), res_tol=1e-5, verbose=False,
            solver_settings=settings(dtype), device=dev)
        times.append(time.perf_counter() - t0)
        u = np.asarray(U[0], float)
        x = plant_step(x, u)
        errs.append(float(np.linalg.norm(x[:2] - target[:2])))
        X_prev = np.concatenate([X[2:], X[-1:]], axis=0)
        U_prev = np.concatenate([U[1:], U[-1:]], axis=0)
        u_last = u
    return np.array(times) * 1e3, errs


def report(tag, times_ms, errs, T, N):
    print(f"{tag}: {T} steps, horizon N={N}")
    print(f"  cold first solve: {times_ms[0]:8.1f} ms")
    print(f"  warm steps p50:   {np.median(times_ms[1:]):8.1f} ms "
          f"(min {times_ms[1:].min():.1f})")
    print(f"  tracking error: start {errs[0]:.2f} -> final {errs[-1]:.2f}")
    assert np.isfinite(times_ms).all()
    return dict(cold_ms=float(times_ms[0]), warm_p50_ms=float(np.median(times_ms[1:])),
                warm_min_ms=float(times_ms[1:].min()), err_start=errs[0], err_final=errs[-1])


def main(device=None, dtype=torch.float32, out=None, run_host=None):
    """The fused loop (and the host loop with ``PMPC_RH_HOST=1`` or
    ``run_host``); returns {"fused": numbers, "iters": per step, and
    "host": numbers where it ran}."""
    N = 8 if fast() else 20
    T = 4 if fast() else 30
    xdim, udim = 4, 2
    times_ms, errs, iters = closed_loop_fused(N, T, xdim, udim, device=device, dtype=dtype)
    res = dict(fused=report("closed loop (fused)", times_ms, errs, T, N), iters=iters)
    if not fast():
        assert errs[-1] < errs[0], "closed loop should reduce tracking error"
    if run_host if run_host is not None else os.environ.get("PMPC_RH_HOST") == "1":
        times_ms, errs = closed_loop_host(N, T, xdim, udim, device=device)
        res["host"] = report("closed loop (host API)", times_ms, errs, T, N)
    return res


if __name__ == "__main__":
    run(main, __doc__)
