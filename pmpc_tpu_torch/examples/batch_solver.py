"""A batch of 1000 MPC problems in one fused solver call, the twin of
``examples/batch_solver.py``.

Two paths:
 1. the list-of-problems API ``pmpc_tpu_torch.solve_problems`` (compatible
    problems stacked into one host-loop solve, and ``fused=True``: the whole
    SCP loop as one solver call),
 2. the fused solver itself (`build_scp_solver` over a (B, M, ...) batch),
    the deployment API with full control over batching;
then path 2's first problem against the host-loop ``pmpc_tpu_torch.solve``.

    python3 -m pmpc_tpu_torch.examples.batch_solver [--device cpu]

``PMPC_EXAMPLES_FAST=1`` runs the smoke sizes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import pmpc_tpu_torch
from pmpc_tpu_torch.torch_scp import SCPData, build_scp_solver, make_scp_data
from pmpc_tpu_torch.utils import default_device, numpy_dtype

from ._common import fast, run, settings, unicycle


def sizes() -> dict:
    """B, N, max_it and the list length of path 1."""
    return dict(B=16 if fast() else 1000, N=8 if fast() else 20, max_it=3 if fast() else 32,
                n_list=4 if fast() else 32)


def list_problems(f_fn, dtype=None):
    """Path 1's problems (seed 0) with the dynamics callback ``f_fn``, and the
    generator they leave behind for path 2's x0."""
    s, xdim, udim = sizes(), 4, 2
    N = s["N"]
    rng = np.random.default_rng(0)
    problems = [dict(
        f_fx_fu_fn=f_fn,
        Q=np.tile(np.eye(xdim), (N, 1, 1)),
        R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
        x0=np.ones(xdim) + 0.1 * rng.normal(size=xdim),
        reg_x=1.0, reg_u=1e-1, max_it=s["max_it"], res_tol=1e-5,
        solver_settings=settings(dtype),
    ) for _ in range(s["n_list"])]
    return problems, rng


def host_problem(x0, dtype=None) -> dict:
    """The host-loop check of problem 0: path 2's settings through `solve`."""
    s, xdim, udim = sizes(), 4, 2
    N = s["N"]
    return dict(Q=np.tile(np.eye(xdim), (N, 1, 1)), R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
                x0=x0, u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
                reg_x=1.0, reg_u=1e-1, max_it=s["max_it"], res_tol=1e-5, verbose=False,
                solver_settings=settings(dtype))


def main(device=None, dtype=None, out=None):
    """Returns the printed numbers: seconds and |dU| of path 1, ms, solves/s,
    converged fraction and median residual of path 2, |dU| of the check,
    and the controls of path 1 (``U_list``), path 2 (``U_fused``, with its
    SCP iterations ``iters_fused``) and the
    check (``host``: its U and SCP iterations)."""
    s, xdim, udim = sizes(), 4, 2
    B, N, max_it, n_list = s["B"], s["N"], s["max_it"], s["n_list"]
    dev = default_device() if device is None else torch.device(device)
    nd = numpy_dtype(dtype or torch.get_default_dtype())
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res = {}

    # -- path 1: list-of-problems API -----------------------------------------
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(unicycle, device=dev)
    problems, rng = list_problems(f_fn, dtype)
    t0 = time.perf_counter()
    rets = pmpc_tpu_torch.solve_problems(problems, verbose=False, device=dev)
    res["list_s"] = time.perf_counter() - t0
    print(f"solve_problems: {n_list} problems in {res['list_s']:.2f}s "
          f"(stacked into one host-loop solve)")
    rets_fused = pmpc_tpu_torch.solve_problems(problems, fused=True, device=dev)  # warm-up
    t0 = time.perf_counter()
    rets_fused = pmpc_tpu_torch.solve_problems(problems, fused=True, device=dev)
    res["fused_list_ms"] = (time.perf_counter() - t0) * 1e3
    res["list_dU"] = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(rets, rets_fused))
    res["U_list"] = np.stack([r[1] for r in rets])
    print(f"  fused=True:   {n_list} problems in {res['fused_list_ms']:.0f} ms warm "
          f"(whole SCP loop as ONE solver call; |dU|_inf vs host {res['list_dU']:.1e})")

    # -- path 2: the fused solver over a batch ---------------------------------
    solver = build_scp_solver(unicycle, N=N, xdim=xdim, udim=udim, M=1, Nc=0,
                              max_it=max_it, res_tol=1e-5, has_u_bounds=True)
    one = make_scp_data(
        np.ones((1, xdim), nd), np.tile(np.eye(xdim, dtype=nd), (1, N, 1, 1)),
        np.tile((1e-2 * np.eye(udim)).astype(nd), (1, N, 1, 1)),
        reg_x=1.0, reg_u=0.1, u_l=-np.ones((1, N, udim), nd), u_u=np.ones((1, N, udim), nd),
        device=dev)
    x0 = (np.ones((B, 1, xdim)) + 0.1 * rng.normal(size=(B, 1, xdim))).astype(nd)
    data = SCPData(*(None if a is None else a.expand((B,) + a.shape).clone() for a in one))
    data = data._replace(x0=torch.as_tensor(x0, device=dev))
    X, U, info = solver(data)  # warm-up: the timing stays comparable
    sync()
    t0 = time.perf_counter()
    X, U, info = solver(data)
    sync()
    dt = time.perf_counter() - t0
    res.update(fused_ms=dt * 1e3, solves_per_s=B / dt,
               converged=float(info["converged"].double().mean()),
               resid_median=float(info["resid"].double().median()),
               U_fused=U[:, 0].cpu().numpy(), iters_fused=info["iters"].cpu().numpy())
    print(f"fused batch:    {B} problems in {res['fused_ms']:.1f} ms warm "
          f"({res['solves_per_s']:.0f} solves/s, {100 * res['converged']:.0f}% converged, "
          f"median resid {res['resid_median']:.1e})")

    # -- problem 0 against the host path ----------------------------------------
    _, Uh, dh = pmpc_tpu_torch.solve(f_fn, **host_problem(x0[0, 0].astype(np.float64), dtype),
                                     device=dev)
    res["host_dU"] = float(np.max(np.abs(res["U_fused"][0] - Uh)))
    res["host"] = dict(U=Uh, iters=len(dh["hist"]))
    print(f"fused vs host-loop on problem 0: |dU|_inf = {res['host_dU']:.2e}")
    return res


if __name__ == "__main__":
    run(main, __doc__)
