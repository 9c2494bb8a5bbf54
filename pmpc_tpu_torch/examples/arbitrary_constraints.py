"""Convex-cone constraints beyond boxes, the twin of
``examples/arbitrary_constraints.py`` (the reference README's "Arbitrary
Constraints": linear rows, second-order cones, and the per-stage thrust
cone's own fast path):

 1. per-stage control-norm cones ``||u_j|| <= r`` through ``u_soc_r``: exact
    cones inside the condensed arrow IPM;
 2. the general ``extra_cstrs_fns`` route (the reference's 8-tuple format
    over the canonical layout ``z = [u_cons; u_free; x]``): a linear row on
    the first control plus per-stage SOC cones, solved by the NT-scaled cone
    IPM over the composed program (f64 on the card).

    python3 -m pmpc_tpu_torch.examples.arbitrary_constraints [--device cpu]

``PMPC_EXAMPLES_FAST=1`` runs the smoke sizes.
"""

from __future__ import annotations

import numpy as np

import pmpc_tpu_torch

from ._common import fast, run, settings, unicycle

UMAX, BUDGET = 0.8, 0.5  # part 2: the cone radius and the linear row's bound


def thrust_cone_problem(dtype=None) -> dict:
    """Part 1's arguments of `solve` (all but the dynamics): N=20 (8 FAST),
    ||u_j|| <= 0.7 on every stage."""
    N, xdim, udim = 8 if fast() else 20, 4, 2
    return dict(Q=np.tile(np.eye(xdim), (N, 1, 1)), R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
                x0=np.ones(xdim), reg_x=1.0, reg_u=0.1, max_it=4 if fast() else 30,
                res_tol=1e-5, verbose=False,
                solver_settings=settings(dtype, u_soc_r=np.full((1, N), 0.7)))


def demo_thrust_cone_fast_path(device=None, dtype=None):
    print("== 1. per-stage thrust cones ||u_j|| <= 0.7 (structured IPM) ==")
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(unicycle, device=device)
    X, U, data = pmpc_tpu_torch.solve(f_fn, **thrust_cone_problem(dtype), device=device)
    res = dict(norm_max=float(np.linalg.norm(U, axis=-1).max()),
               resid=data["hist"][-1]["resid"], U=U, iters=len(data["hist"]))
    print(f"  max ||u_j|| = {res['norm_max']:.6f} (radius 0.7), "
          f"residual {res['resid']:.1e}")
    return res


def extra_cstrs_problem(dtype=None) -> dict:
    """Part 2's arguments of `solve` (all but the dynamics): N=12 (8 FAST),
    the linear row u_0[0] + u_0[1] <= BUDGET and ||u_j|| <= UMAX on every
    stage as ``extra_cstrs_fns``."""
    N, xdim, udim = 8 if fast() else 12, 4, 2
    # the canonical layout for M=1, full consensus: z = [u (N udim); x (N xdim)]
    n_full = N * udim + N * xdim

    def extra_cstrs_fns(X_prev, U_prev, problems):
        # (a) one linear row: u_0[0] + u_0[1] <= BUDGET  (s = h - Gz >= 0)
        G_lin = np.zeros((1, n_full))
        G_lin[0, 0] = G_lin[0, 1] = 1.0
        lin = (1, [], 0, G_lin, np.zeros((1, 0)), np.array([BUDGET]),
               np.zeros(n_full), np.zeros(0))
        # (b) one SOC per stage: ||u_j|| <= UMAX, rows [UMAX; u_j]
        rows, hs, qs = [], [], []
        for j in range(N):
            G = np.zeros((1 + udim, n_full))
            for r in range(udim):
                G[1 + r, j * udim + r] = -1.0
            rows.append(G)
            h = np.zeros(1 + udim)
            h[0] = UMAX
            hs.append(h)
            qs.append(1 + udim)
        soc = (0, qs, 0, np.concatenate(rows), np.zeros((len(qs) * (1 + udim), 0)),
               np.concatenate(hs), np.zeros(n_full), np.zeros(0))
        return [lin, soc]

    return dict(Q=np.tile(np.eye(xdim), (N, 1, 1)), R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
                x0=np.ones(xdim), extra_cstrs_fns=extra_cstrs_fns, reg_x=1.0, reg_u=0.1,
                max_it=4 if fast() else 30, res_tol=1e-5, verbose=False,
                solver_settings=settings(dtype))


def demo_extra_cstrs(device=None, dtype=None):
    print("== 2. general extra_cstrs: linear + SOC via the 8-tuple format ==")
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(unicycle, device=device)
    X, U, data = pmpc_tpu_torch.solve(f_fn, **extra_cstrs_problem(dtype), device=device)
    res = dict(u0_sum=float(U[0, 0] + U[0, 1]), norm_max=float(np.linalg.norm(U, axis=-1).max()),
               resid=data["hist"][-1]["resid"], U=U, iters=len(data["hist"]))
    print(f"  u_0 sum = {res['u0_sum']:.4f} (budget {BUDGET}), "
          f"max ||u_j|| = {res['norm_max']:.4f} (radius {UMAX}), "
          f"residual {res['resid']:.1e}")
    assert res["u0_sum"] <= BUDGET + 1e-4
    assert res["norm_max"] <= UMAX + 1e-4
    return res


def main(device=None, dtype=None, out=None):
    """Both parts; returns {"thrust_cone", "extra_cstrs"}: the printed
    numbers and U of each."""
    res = dict(thrust_cone=demo_thrust_cone_fast_path(device, dtype),
               extra_cstrs=demo_extra_cstrs(device, dtype))
    print("done")
    return res


if __name__ == "__main__":
    run(main, __doc__)
