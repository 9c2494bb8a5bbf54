"""Three introductory solves, the twin of ``examples/simple_demo.py``:

 1. a random linear system through the ``Problem`` struct,
 2. a nonlinear unicycle car tracking a moved target via ``lin_cost_fn``
    with control bounds and a slew penalty,
 3. the contingency / consensus demo: M=2 dynamics particles, one of which
    loses all actuation after step 10, that must share their first Nc=3
    controls. The shared prefix hedges against the failure; the suffix
    splits per scenario.

    python3 -m pmpc_tpu_torch.examples.simple_demo [--device cpu] [--out DIR]

``PMPC_EXAMPLES_FAST=1`` runs the smoke sizes. The plots go to ``--out``.
"""

from __future__ import annotations

import numpy as np

import pmpc_tpu_torch
from pmpc_tpu_torch import Problem

from ._common import fast, run, save_plot, settings, unicycle


def linear_system_problem(dtype=None) -> Problem:
    """Part 1's problem: a seeded stable linear system, N=20 (10 FAST)."""
    rng = np.random.default_rng(0)
    p = Problem(N=10 if fast() else 20, xdim=4, udim=2)
    A = rng.normal(size=(p.xdim, p.xdim)) * 0.3 + 0.5 * np.eye(p.xdim)
    B = np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.3], [0.3, 0.0]])
    A_t = np.tile(A, (p.N, 1, 1))
    B_t = np.tile(B, (p.N, 1, 1))

    def f_fx_fu_fn(x, u):
        xp = np.einsum("...ij,...j->...i", A_t, x) + np.einsum("...ij,...j->...i", B_t, u)
        sh = x.shape[:-1]
        return xp, np.broadcast_to(A_t, sh + A.shape).copy(), \
            np.broadcast_to(B_t, sh + B.shape).copy()

    p.f_fx_fu_fn = f_fx_fu_fn
    p.x0 = rng.normal(size=p.xdim)
    p.reg_x, p.reg_u = 1e-3, 1e-3
    p.max_it = 3 if fast() else 10
    p.solver_settings = settings(dtype)
    return p


def demo_linear_system(device=None, dtype=None, out=None):
    print("== 1. random linear system (Problem struct) ==")
    p = linear_system_problem(dtype)
    X, U, data = pmpc_tpu_torch.solve(**p, device=device)
    res = dict(resid=data["hist"][-1]["resid"], xN=float(np.linalg.norm(X[-1])),
               x0=float(np.linalg.norm(p.x0)), X=X, U=U, iters=len(data["hist"]))
    print(f"  residual {res['resid']:.2e}, |x_N| = {res['xN']:.3f} "
          f"(from |x_0| = {res['x0']:.3f})")
    save_plot(out, "linear_system", X, U)
    return res


def car_tracking_problem(dtype=None) -> dict:
    """Part 2's arguments of `solve` (all but the dynamics): N=50 (12 FAST),
    a strong terminal weight, a second target through ``lin_cost_fn``,
    bounds +-1 and slew."""
    N = 12 if fast() else 50
    xdim, udim = 4, 2
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    Q[-1] *= 1e2  # strong terminal weight
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    target2 = 3.0 * np.ones(xdim)

    def lin_cost_fn(X, U, problems=None):
        # an extra linear cost pulling toward a SECOND target: the gradient of
        # 0.5 ||x - target2||^2 at the linearization point
        return (X - target2), None

    return dict(Q=Q, R=R, x0=np.zeros(xdim), X_ref=np.ones((N, xdim)), lin_cost_fn=lin_cost_fn,
                u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
                slew_rate=1.0, reg_x=1.0, reg_u=1e-1,
                max_it=4 if fast() else 40, res_tol=1e-5, verbose=False,
                solver_settings=settings(dtype))


def demo_car_tracking(device=None, dtype=None, out=None):
    print("== 2. unicycle car, moved target via lin_cost_fn + bounds + slew ==")
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(unicycle, device=device)
    X, U, data = pmpc_tpu_torch.solve(f_fn, **car_tracking_problem(dtype), device=device)
    res = dict(resid=data["hist"][-1]["resid"], u_min=float(U.min()), u_max=float(U.max()),
               final_pos=(float(X[-1, 0]), float(X[-1, 1])), X=X, U=U,
               iters=len(data["hist"]))
    print(f"  residual {res['resid']:.2e}, "
          f"u range [{res['u_min']:.3f}, {res['u_max']:.3f}] (bounds +-1), "
          f"final pos ({X[-1, 0]:.2f}, {X[-1, 1]:.2f})")
    save_plot(out, "car_tracking", X, U)
    return res


def consensus_problem(dtype=None) -> dict:
    """Part 3's arguments of `solve`: M=2 seeded linear particles, particle 1
    without actuation from step 10, Nc=3."""
    M, N, xdim, udim = 2, 10 if fast() else 20, 4, 2
    rng = np.random.default_rng(1)
    A = rng.normal(size=(xdim, xdim)) * 0.3 + 0.4 * np.eye(xdim)
    B = np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.3], [0.3, 0.0]])
    A_t = np.tile(A, (M, N, 1, 1))
    B_t = np.tile(B, (M, N, 1, 1))
    B_t[1, min(10, N - 1):] = 0.0  # particle 1: actuation lost after step 10

    def f_fx_fu_fn(x, u):
        xp = np.einsum("mnij,mnj->mni", A_t, x) + np.einsum("mnij,mnj->mni", B_t, u)
        return xp, A_t.copy(), B_t.copy()

    return dict(f_fx_fu_fn=f_fx_fu_fn, Q=np.tile(np.eye(xdim), (M, N, 1, 1)),
                R=np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)), x0=np.ones((M, xdim)),
                X_ref=np.stack([np.ones((N, xdim)), -np.ones((N, xdim))]),
                reg_x=1.0, reg_u=1e-1, max_it=5 if fast() else 50, res_tol=1e-6,
                verbose=False, solver_settings=settings(dtype, Nc=3))


def demo_contingency_consensus(device=None, dtype=None, out=None):
    print("== 3. contingency MPC: M=2 particles, one loses actuation at t=10 ==")
    kw = consensus_problem(dtype)
    Nc = kw["solver_settings"]["Nc"]
    X, U, data = pmpc_tpu_torch.solve(**kw, device=device)
    res = dict(spread_cons=float(np.ptp(U[:, :Nc, :], axis=0).max()),
               spread_free=float(np.ptp(U[:, Nc:, :], axis=0).max()), X=X, U=U,
               iters=len(data["hist"]))
    print(f"  consensus spread over first {Nc} controls: {res['spread_cons']:.2e} "
          f"(shared), over the rest: {res['spread_free']:.3f} (split per scenario)")
    save_plot(out, "contingency_consensus", X, U)
    assert res["spread_cons"] < 1e-5, "consensus controls must agree across particles"
    return res


def main(device=None, dtype=None, out=None):
    """The three demos; returns {"linear_system", "car_tracking",
    "consensus"}: each the numbers it printed and its X, U."""
    res = dict(linear_system=demo_linear_system(device, dtype, out),
               car_tracking=demo_car_tracking(device, dtype, out),
               consensus=demo_contingency_consensus(device, dtype, out))
    print("done")
    return res


if __name__ == "__main__":
    run(main, __doc__)
