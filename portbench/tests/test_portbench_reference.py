"""The plain reference: its box QP, its exact Hessian, and its answer
against the program's at a tiny size on the CPU."""

import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, find, program
from portbench.dynamics import dubins
from portbench.reference import scp as reference
from portbench.tests._tiny import tiny_cell


def dense(A):
    """The arrow's full matrix, for the brute-force checks."""
    L, M, nc, nf = A.cf.shape
    H = torch.zeros(L, nc + M * nf, nc + M * nf, dtype=A.cc.dtype)
    H[:, :nc, :nc] = A.cc
    for m in range(M):
        f = slice(nc + m * nf, nc + (m + 1) * nf)
        H[:, :nc, f], H[:, f, :nc], H[:, f, f] = A.cf[:, m], A.cf[:, m].mT, A.ff[:, m]
    return H


def random_arrow(L, M, nc, nf, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(L, M, nc + nf, nc + nf, generator=g, dtype=torch.float64)
    return reference.Arrow.of_particles(A @ A.mT + 0.1 * torch.eye(nc + nf, dtype=torch.float64),
                                        nc), g


def test_arrow_solve_matches_dense():
    A, g = random_arrow(3, 4, 2, 3, 0)
    rhs = torch.randn(3, 2 + 4 * 3, generator=g, dtype=torch.float64)
    solve, ok = A.factor()
    assert ok.all()
    assert torch.allclose(solve(rhs), torch.linalg.solve(dense(A), rhs), atol=1e-10)
    assert torch.allclose(A.mv(rhs), (dense(A) @ rhs[..., None])[..., 0], atol=1e-12)


@pytest.mark.parametrize("ipm_iters", [100, 2], ids=["converged", "crude_interior_point"])
def test_box_qp_finds_the_enumerated_optimum(ipm_iters):
    """From a crude interior point the active-set rounds still reach the
    optimum."""
    L, M, nc, nf = 6, 2, 1, 2
    A, g = random_arrow(L, M, nc, nf, 1)
    H, n = dense(A), nc + M * nf
    q = 3.0 * torch.randn(L, n, generator=g, dtype=torch.float64)
    lo, hi = -torch.ones(L, n, dtype=torch.float64), torch.ones(L, n, dtype=torch.float64)
    w, ok = reference.box_qp(A, q, lo, hi, 1e-12, max_iter=ipm_iters)
    assert ok.all() == (ipm_iters == 100)
    for i in range(L):  # every assignment of each variable to lo, hi or free
        best = np.inf
        for act in itertools.product((-1, 0, 1), repeat=n):
            act = torch.tensor(act)
            free = act == 0
            z = act.to(torch.float64).clone()
            if free.any():
                rhs = -q[i, free] - H[i][free][:, ~free] @ z[~free]
                z[free] = torch.linalg.solve(H[i][free][:, free], rhs)
            if (z.abs() <= 1 + 1e-12).all():
                best = min(best, float(0.5 * z @ H[i] @ z + q[i] @ z))
        assert float(0.5 * w[i] @ H[i] @ w[i] + q[i] @ w[i]) == pytest.approx(best, abs=1e-10)


def test_exact_hessian_matches_autodiff():
    L, M, N, Nc, udim = 1, 2, 4, 1, 2
    nc, NU = Nc * udim, N * udim
    g = torch.Generator().manual_seed(1)
    x0 = 1 + 0.05 * torch.randn(L, M, 4, generator=g, dtype=torch.float64)
    z = 0.3 * torch.randn(L, nc + M * (NU - nc), generator=g, dtype=torch.float64)
    step = dubins.step

    def to_U(zz):
        zf = zz[:, nc:].reshape(L, M, NU - nc)
        return torch.cat([zz[:, None, :nc].expand(L, M, nc), zf], -1).reshape(L, M, N, udim)

    def cost(zz):
        U = to_U(zz)
        return 0.5 * ((reference.rollout(step, x0, U) ** 2).sum() + 1e-2 * (U ** 2).sum())

    H_auto = torch.func.hessian(cost)(z)[0, :, 0, :]
    U = to_U(z)
    X = reference.rollout(step, x0, U)
    X_in = torch.cat([x0[..., None, :], X[..., :-1, :]], -2)
    fx, fu = reference.jacobians(step, X_in, U)
    F = reference.condense(fx, fu)
    p, P = X[..., -1, :], [X[..., -1, :]]
    for j in range(N - 2, -1, -1):
        p = X[..., j, :] + (fx[..., j + 1, :, :].mT @ p[..., None])[..., 0]
        P.append(p)
    W = reference.second_order(step, X_in, U, torch.stack(P[::-1], -2))
    Fr = F.reshape(L, M, N, 4, NU)
    G = torch.cat([torch.cat([torch.zeros_like(Fr[..., :1, :, :]), Fr[..., :-1, :, :]], -3),
                   torch.eye(NU, dtype=torch.float64).reshape(N, udim, -1)
                   .expand(L, M, N, udim, NU)], -2)
    Hm = F.mT @ F + 1e-2 * torch.eye(NU, dtype=torch.float64) \
        + torch.einsum("lmjan,lmjab,lmjbk->lmnk", G, W, G)
    assert torch.allclose(dense(reference.Arrow.of_particles(Hm, nc))[0], H_auto, atol=1e-12)


@pytest.mark.parametrize("M,Nc", [(4, 2), (1, 0)], ids=["consensus", "one_car"])
def test_reference_meets_the_program_at_a_tiny_size(M, Nc):
    cell = tiny_cell("m32n30.b64", M=M, N=10, Nc=Nc, B=3)
    cfg = dict(cell["config"], dtype="float64",
               solver=dict(cell["config"]["solver"], res_tol=1e-8, max_it=200, ipm_iters=40,
                           ipm_tol_exp=-12))
    rng = np.random.default_rng(0)
    B, M = 3, cfg["M"]
    x0 = torch.from_numpy(np.ones((B, M, 4)) + 0.05 * rng.normal(size=(B, M, 4))
                          + 0.05 * rng.normal(size=(B, 1, 4)))
    data = program.inputs(cfg, B, torch.device("cpu"))._replace(x0=x0)
    X, U, info = program.build(cfg)(data)
    assert info["converged"].all()
    U_star, X_star, conv, _ = reference.solve(
        program.dynamics(cfg), x0, data.X_ref, data.U_ref, cfg["q"], cfg["r"], cfg["u_lo"],
        cfg["u_hi"], cfg["Nc"], 1e-10, 40, 1e-12)
    assert conv.all()
    # both stop on a step under 1e-8: the same KKT point to far below the
    # float32 answers' ~1e-3
    assert (U - U_star).abs().max() < 1e-6
    assert (X - X_star).abs().max() < 1e-6


def test_reference_converges_where_it_once_stalled():
    """Three drawn lanes of `m32n30.b64` and `m32n30.b1024` (the second the
    card's answer) at which the reference once stalled or cycled: controls a
    hair off a bound they belong on, or pinned where the gradient moves them
    inward. From the program's answer each now reaches its KKT point in a
    few exact Newton steps."""
    lanes = torch.load(Path(__file__).parent / "data" / "stalled_lanes.pt")
    x0, U = lanes["x0"], lanes["U"]
    cfg = find.cell("m32n30.b64")["config"]
    L, M, N = U.shape[:3]
    zero = lambda d: torch.zeros(L, M, N, d, dtype=torch.float64)
    U_star, _, conv, its = reference.solve(
        program.dynamics(cfg), x0, zero(4), zero(2), cfg["q"], cfg["r"], cfg["u_lo"],
        cfg["u_hi"], cfg["Nc"], check.REF_TOL, check.REF_MAX_IT, check.REF_QP_TOL, U0=U)
    assert conv.all() and (its <= 5).all(), its
    assert (U - U_star).abs().max() < 0.01
