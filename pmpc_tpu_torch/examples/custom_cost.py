"""Custom-cost MPC, the twin of ``examples/custom_cost.py``:

 1. ``lin_cost_fn``: an extra cost given by its gradient, linearized again
    every SCP iteration (a pull toward a second target), on the IPM path;
 2. ``diff_cost_fn``: a differentiable extra cost written in torch
    (autograd on the device), which sends the subproblems to the smooth
    solvers (L-BFGS over the condensed variable with log-barrier bounds);
 3. the same with a named solver, ``solver="SQP"``.

    python3 -m pmpc_tpu_torch.examples.custom_cost [--device cpu]

``PMPC_EXAMPLES_FAST=1`` runs the smoke sizes.
"""

from __future__ import annotations

import numpy as np
import torch

import pmpc_tpu_torch

from ._common import fast, run, settings, unicycle


def base_problem(dtype=None) -> dict:
    """The arguments of `solve` the three parts share (all but the dynamics
    and the cost): N=20 (8 FAST), bounds +-1, x0 = ones."""
    N, xdim, udim = 8 if fast() else 20, 4, 2
    return dict(Q=np.tile(np.eye(xdim), (N, 1, 1)), R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
                x0=np.ones(xdim), u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
                reg_x=3.0, reg_u=1.0, max_it=4 if fast() else 30, res_tol=1e-5,
                verbose=False, solver_settings=settings(dtype))


def lin_cost_fn(X, U, problems=None):
    cx = -5.0 * np.ones(X.shape)  # a constant pull toward +x
    return cx, None


def diff_cost_fn(X, U, *args, **kw):
    X_ref = -5.0 * torch.ones_like(X)
    U_ref = torch.ones_like(U)
    return torch.mean((X - X_ref) ** 2) + torch.mean((U - U_ref) ** 2)


def main(device=None, dtype=None, out=None):
    """Returns the printed numbers of the three parts and their U."""
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(unicycle, device=device)
    base = base_problem(dtype)
    res = {}

    # -- 1. linearized custom cost (gradient callback) -------------------------
    X, U, data = pmpc_tpu_torch.solve(f_fn, lin_cost_fn=lin_cost_fn, device=device, **base)
    res["lin"] = dict(resid=data["hist"][-1]["resid"], final_pos=(float(X[-1, 0]),
                                                                  float(X[-1, 1])),
                      u_min=float(U.min()), u_max=float(U.max()), U=U,
                      iters=len(data["hist"]))
    print(f"lin_cost_fn:  residual {res['lin']['resid']:.2e}, "
          f"final pos ({X[-1, 0]:.2f}, {X[-1, 1]:.2f}), "
          f"u range [{U.min():.2f}, {U.max():.2f}]")

    # -- 2. differentiable custom cost (smooth path, autograd on the device) ---
    X2, U2, data2 = pmpc_tpu_torch.solve(f_fn, diff_cost_fn=diff_cost_fn, device=device,
                                         **base)
    res["diff"] = dict(resid=data2["hist"][-1]["resid"],
                       final_pos=(float(X2[-1, 0]), float(X2[-1, 1])), U=U2,
                       iters=len(data2["hist"]))
    print(f"diff_cost_fn: residual {res['diff']['resid']:.2e}, "
          f"final pos ({X2[-1, 0]:.2f}, {X2[-1, 1]:.2f})  (pulled toward -5)")

    # -- 3. same, with an explicit named smooth solver --------------------------
    ss = dict(base["solver_settings"], solver="SQP")
    X3, U3, data3 = pmpc_tpu_torch.solve(f_fn, diff_cost_fn=diff_cost_fn, device=device,
                                         **dict(base, solver_settings=ss))
    res["sqp"] = dict(resid=data3["hist"][-1]["resid"], dU=float(np.max(np.abs(U3 - U2))),
                      U=U3, iters=len(data3["hist"]))
    print(f"solver='SQP': residual {res['sqp']['resid']:.2e}, "
          f"|dU vs LBFGS|_inf = {res['sqp']['dU']:.2e}")
    return res


if __name__ == "__main__":
    run(main, __doc__)
