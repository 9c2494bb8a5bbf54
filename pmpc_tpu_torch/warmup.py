"""Warm-up CLI: build the kernel and run the caller's shape once.

Twin of ``pmpc_tpu/warmup.py`` (AOT-workload parity with the reference's
PackageCompiler precompile sweep, ``PMPC.jl/src/c_precompile.jl:53-144``).
The port has no compile cache to prime: its first-use costs are the nvcc
build of ``csrc/chol_inv.cu`` (once per source, into the ignored
``pmpc_tpu_torch/_build/``) and the process's first CUDA calls. This tool
pays them up front for the caller's production shapes, so the first REAL
solve is warm:

    python -m pmpc_tpu_torch.warmup --N 30 --M 32 --Nc 5 --max-it 8 --bounded \\
        [--soc] [--batch 64]          # fused path (default)
    python -m pmpc_tpu_torch.warmup --N 30 --bounded --host   # host loop

Without ``--N`` it runs a small option sweep over {eq, box, SOC} x
{host, fused} on toy shapes. ``--device`` names the device (the card when
not given; ``cpu`` runs the plain kernels, nothing is built).
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

import numpy as np
import torch

from .utils import default_device


def _dubins(x, u):
    dt = 0.25
    px, py, v, th = x[0], x[1], x[2], x[3]
    return torch.stack([
        px + dt * v * torch.cos(th),
        py + dt * v * torch.sin(th),
        v + dt * u[0],
        th + dt * u[1],
    ])


def _device(device) -> torch.device:
    """The device, with the kernel built and loaded when it is the card."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        from .ops import chol_inv

        chol_inv._lib()  # nvcc at first use; a failed build raises here
    return dev


def warm_fused(N, M, Nc, max_it, bounded, soc, batch, xdim=4, udim=2, device=None,
               dtype=torch.float32):
    """Run the fused solver once at one shape: ``batch`` scenarios (1 when
    0) of M particles, on ``device`` (the card when None)."""
    from .torch_scp import build_scp_solver, make_scp_data

    dev = _device(device)
    B = max(int(batch), 1)
    kw = {}
    if bounded:
        kw.update(u_l=-np.ones((B, M, N, udim)), u_u=np.ones((B, M, N, udim)))
    if soc:
        kw["u_soc_r"] = np.full((B, M, N), 0.9)
    data = make_scp_data(
        np.ones((B, M, xdim)),
        np.tile(np.eye(xdim), (B, M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (B, M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1, dtype=dtype, device=dev, **kw)
    solver = build_scp_solver(
        _dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=max_it,
        res_tol=1e-5, has_u_bounds=bounded, has_u_soc=soc)
    X, U, info = solver(data)
    _ = float(U.sum())  # wait for the device


def warm_host(N, M, Nc, max_it, bounded, soc, xdim=4, udim=2, device=None):
    """Run the host SCP loop once at one shape on ``device``."""
    from .dynamics import make_f_fx_fu_fn
    from .scp import scp_solve

    dev = _device(device)
    f_fn = make_f_fx_fu_fn(_dubins, device=dev)
    kw = {}
    if bounded:
        kw.update(u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)))
    ss = dict(Nc=Nc)
    if soc:
        ss["u_soc_r"] = np.full((M, N), 0.9)
    scp_solve(f_fn,
              np.tile(np.eye(xdim), (M, N, 1, 1)),
              np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
              np.ones((M, xdim)), max_it=max_it, res_tol=1e-5,
              verbose=False, solver_settings=ss, device=dev, **kw)


def main():
    ap = ArgumentParser("pmpc_tpu_torch.warmup",
                        description="build the kernel and run a shape once")
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--M", type=int, default=1)
    ap.add_argument("--Nc", type=int, default=0)
    ap.add_argument("--max-it", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--bounded", action="store_true")
    ap.add_argument("--soc", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="warm the host path instead of the fused one")
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' runs the plain kernels)")
    args = ap.parse_args()

    t0 = time.time()
    if args.N is not None:
        if args.host and args.batch:
            ap.error("--batch applies to the fused path only (drop --host)")
        if args.host:
            warm_host(args.N, args.M, args.Nc, args.max_it, args.bounded, args.soc,
                      device=args.device)
        else:
            warm_fused(args.N, args.M, args.Nc, args.max_it, args.bounded, args.soc,
                       args.batch, device=args.device)
        print(f"warm ({time.time() - t0:.1f}s)")
        return
    # default: the precompile-workload-style sweep on toy shapes
    for bounded, soc in ((False, False), (True, False), (True, True)):
        warm_fused(6, 2, 1, 2, bounded, soc, 0, device=args.device)
        warm_host(6, 2, 1, 2, bounded, soc, device=args.device)
        print(f"  sweep bounded={bounded} soc={soc} ok "
              f"({time.time() - t0:.1f}s)")
    print("done")


if __name__ == "__main__":
    main()
