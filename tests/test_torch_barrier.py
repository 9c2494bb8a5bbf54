"""The smooth-constraint solvers of the port (`solvers.barrier`,
`solvers.second_order`, `ipm._layout_bounds`) against the JAX package's,
f64, on the CPU, on `oracle.random_problem` subproblems.

(a) `barrier_solve_np` (the structured Newton warm-started by ``ipm_core``)
under logbarrier and squareplus smoothing, control boxes with and without
state boxes, Nc = 2: U and X to 1e-9; `barrier_core` from the previous
controls (its default start) in both smoothings to 1e-9 after five steps
and 1e-7 converged;
(b) `riccati_barrier_solve_np` with and without state boxes and slew to
1e-9 after three Newton steps and 1e-7 converged (a last-bit line-search
choice; the test says why), and against the port's condensed `barrier_solve_np` to 1e-5 (the
bound of tests/test_barrier.py::test_riccati_squareplus_matches_condensed);
(c) L-BFGS (``solver="LBFGS"``, ``max_it=400``) against the JAX package's
logbarrier answer to 5e-3 (tests/test_barrier.py::
test_lbfgs_smooth_solver_option's bound and instance), and a quadratic
``diff_cost_fn`` against the exact solve of the equivalently modified QP to
2e-3 (test_diff_cost_fn_quadratic_extra_matches_exact's), also on two
lanes of one `lbfgs_core` call; the autograd
gradient and the ``torch.func`` Hessian of an f32 objective stay f32
(ROADMAP §3 F2);
(d) the dense CVX and SQP solvers and ``positive_cholesky_factorization``'s
``lam`` to 1e-8;
(e) ROADMAP §3 F9: on the headline instance's first subproblem (M = 32)
the squareplus Newton in f32 stops where f32 cannot see a decrease of an
objective near -3.8e4; in both packages its objective is within 1e-5 of the
f64 one and U is more than 1e-3 from the f64 U, along the flat optimum: the
f64 objective at the f32 U is within 1e-6 relative of the f64 optimum."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle
from pmpc_tpu.solvers import barrier as jb
from pmpc_tpu.solvers import ipm as jipm
from pmpc_tpu.solvers import second_order as jso
from pmpc_tpu.solvers.dispatch import affine_solve_np
from pmpc_tpu.solvers.reduced import assemble_condensed as j_assemble
from pmpc_tpu_torch.flagship import flagship_subproblem
from pmpc_tpu_torch.solvers import barrier as tb
from pmpc_tpu_torch.solvers import ipm as tipm
from pmpc_tpu_torch.solvers import second_order as tso
from pmpc_tpu_torch.solvers.reduced import assemble_condensed

torch.set_num_threads(1)

KEYS = ["x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref"]


def _instance(seed, M=2, N=8, xdim=3, udim=2, clip=0.4, slew=0.0):
    p = oracle.random_problem(np.random.default_rng(seed), M=M, N=N, xdim=xdim, udim=udim)
    p = dict(p, U_prev=np.clip(p["U_prev"], -clip, clip))
    base = tuple(p[k] for k in KEYS)
    reg = (np.full(M, 1.0), np.full(M, 0.1), np.full(M, slew), np.zeros(M),
           np.zeros((M, udim)))
    return p, base, reg


def _boxes(M, N, xdim, udim, u=0.5, x=None):
    ub = (np.full((M, N, udim), -u), np.full((M, N, udim), u))
    xb = (None, None) if x is None else (np.full((M, N, xdim), -x), np.full((M, N, xdim), x))
    return ub, xb


def test_layout_bounds_matches_jax():
    M, N, xdim, udim, Nc = 3, 5, 4, 2, 2
    rng = np.random.default_rng(0)
    ul = rng.normal(size=(M, N, udim)) - 2
    xu = rng.normal(size=(M, N, xdim)) + 2
    nc, nf = Nc * udim, (N - Nc) * udim
    for args in ((ul, -ul, None, xu), (None, None, -xu, None)):
        t = tipm._layout_bounds(*args, M, N, N * xdim, nc, nf, udim, np.float64)
        j = jipm._layout_bounds(*args, M, N, N * xdim, nc, nf, udim, np.float64)
        for a, b in zip(t, j):
            assert a.shape == (1,) + b.shape and a.dtype == torch.float64
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


@pytest.mark.parametrize("method,alpha,beta", [("logbarrier", 50.0, 1.0),
                                               ("squareplus", 8.0, 2.0)])
@pytest.mark.parametrize("state_box", [False, True])
def test_barrier_solve_np_matches_jax(method, alpha, beta, state_box):
    M, N, xdim, udim, Nc = 2, 8, 3, 2, 2
    p, base, reg = _instance(11, M, N, xdim, udim)
    (ul, uu), (xl, xu) = _boxes(M, N, xdim, udim, x=2.5 if state_box else None)
    kw = dict(Nc=Nc, method=method, alpha=alpha, beta=beta, settings=dict(newton_iters=30))
    X, U, d = tb.barrier_solve_np(base, reg, ul, uu, xl, xu, device="cpu", **kw)
    Xj, Uj, dj = jb.barrier_solve_np(base, reg, ul, uu, xl, xu, **kw)
    np.testing.assert_allclose(U, Uj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(X, Xj, atol=1e-9, rtol=0)
    assert set(d) == set(dj)
    # logbarrier: ipm_core's point sits on the box to ~1e-10 here, where the
    # objective is +inf, and neither package's Newton leaves it (ROADMAP §3 R3)
    assert d["obj"] == dj["obj"] or abs(d["obj"] - dj["obj"]) < 1e-9 * abs(dj["obj"])


@pytest.mark.parametrize("method,alpha,beta", [("logbarrier", 50.0, 1.0),
                                               ("squareplus", 8.0, 2.0)])
def test_barrier_core_from_the_previous_controls(method, alpha, beta):
    """`barrier_core`'s own start (the mean of the previous controls, inside
    the boxes): the logbarrier Newton moves and ends strictly inside. Five
    steps hold to 1e-9; converged (30 steps), to 1e-7 with the objective to
    1e-12 relative, for the reason `test_riccati_barrier_matches_jax_and_
    condensed` gives (2e-9 here)."""
    M, N, xdim, udim, Nc = 2, 8, 3, 2, 2
    p, base, reg = _instance(14, M, N, xdim, udim)
    (ul, uu), (xl, xu) = _boxes(M, N, xdim, udim, x=10.0)
    nc, nf = Nc * udim, (N - Nc) * udim
    cqp = assemble_condensed(*(torch.from_numpy(np.asarray(a))[None] for a in base + reg),
                             Nc=Nc)
    bt = tipm._layout_bounds(ul, uu, xl, xu, M, N, N * xdim, nc, nf, udim, np.float64)
    cj = j_assemble(*(jnp.asarray(a) for a in base + reg), Nc=Nc)
    bj = jipm._layout_bounds(ul, uu, xl, xu, M, N, N * xdim, nc, nf, udim, np.float64)
    for iters, tol in ((5, 1e-9), (30, 1e-7)):
        uc, uf, st = tb.barrier_core(cqp, bt, method, alpha, beta, True, True, iters=iters)
        ucj, ufj, sj = jb.barrier_core(cj, bj, method, alpha, beta, True, True, iters=iters)
        np.testing.assert_allclose(uc[0].numpy(), np.asarray(ucj), atol=tol, rtol=0)
        np.testing.assert_allclose(uf[0].numpy(), np.asarray(ufj), atol=tol, rtol=0)
        assert abs(float(st["obj"][0]) - float(sj["obj"])) < 1e-12 * abs(float(sj["obj"]))
    if method == "logbarrier":
        assert np.isfinite(float(st["obj"][0]))
        assert max(np.abs(uc.numpy()).max(), np.abs(uf.numpy()).max()) < 0.5


@pytest.mark.parametrize("state_box_slew", [False, True])
def test_riccati_barrier_matches_jax_and_condensed(state_box_slew):
    """tests/test_barrier.py::test_riccati_squareplus_matches_condensed's
    settings (u-box 0.4, x-box 2.5 with slew 0.3, Nc = 2). Three Newton
    steps hold to 1e-9. At the converged point (40 steps) the candidates of
    the best-of-halvings line search differ in the objective's last bits, so
    the two packages may take different halvings there: the objective holds
    to 1e-12 relative and U and X to 1e-7 (1.2e-8 on the first case, from
    step 4 on)."""
    M, N, xdim, udim, Nc = 2, 8 if not state_box_slew else 10, 3, 2, 2
    p, base, reg = _instance(91, M, N, xdim, udim, clip=10.0,
                             slew=0.3 if state_box_slew else 0.0)
    (ul, uu), (xl, xu) = _boxes(M, N, xdim, udim, u=0.4,
                                x=2.5 if state_box_slew else None)
    for iters, tol in ((3, 1e-9), (40, 1e-7)):
        kw = dict(Nc=Nc, method="squareplus", alpha=8.0, beta=1.0,
                  settings=dict(newton_iters=iters))
        X, U, d = tb.riccati_barrier_solve_np(base, reg, ul, uu, xl, xu, device="cpu", **kw)
        Xj, Uj, dj = jb.riccati_barrier_solve_np(base, reg, ul, uu, xl, xu, **kw)
        np.testing.assert_allclose(U, Uj, atol=tol, rtol=0)
        np.testing.assert_allclose(X, Xj, atol=tol, rtol=0)
        assert abs(d["obj"] - dj["obj"]) < 1e-12 * abs(dj["obj"])
    Xc, Uc, _ = tb.barrier_solve_np(base, reg, ul, uu, xl, xu, device="cpu", **kw)
    np.testing.assert_allclose(U, Uc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(X, Xc, atol=1e-5, rtol=0)


def test_lbfgs_reaches_the_smoothed_optimum():
    M, N, xdim, udim = 2, 8, 3, 2
    p, base, reg = _instance(15, M, N, xdim, udim)
    (ul, uu), _ = _boxes(M, N, xdim, udim)
    # the JAX package's logbarrier answer (the mu-target IPM of its dispatcher)
    _, Uj, _ = affine_solve_np(*base, reg_x=reg[0], reg_u=reg[1], slew_reg=reg[2],
                               slew_reg0=reg[3], slew_um1=reg[4], u_l=ul, u_u=uu, x_l=None,
                               x_u=None, Nc=0,
                               settings=dict(smooth_cstr="logbarrier", smooth_alpha=50.0))
    X, U, d = tb.barrier_solve_np(base, reg, ul, uu, None, None, Nc=0, method="logbarrier",
                                  alpha=50.0, settings=dict(solver="LBFGS", max_it=400),
                                  device="cpu")
    assert np.isfinite(U).all() and np.isfinite(d["obj"])
    assert np.abs(U - Uj).max() < 5e-3, np.abs(U - Uj).max()
    assert np.abs(U).max() < 0.5


def test_diff_cost_fn_matches_the_exact_solve():
    M, N, xdim, udim = 1, 6, 3, 2
    p = oracle.random_problem(np.random.default_rng(16), M=M, N=N, xdim=xdim, udim=udim)
    base = tuple(p[k] for k in KEYS)
    reg = (np.full(M, 1.0), np.full(M, 0.1), np.zeros(M), np.zeros(M), np.zeros((M, udim)))
    c, a = 2.0, 0.3
    X, U, d = tb.barrier_solve_np(base, reg, None, None, None, None, Nc=0,
                                  settings=dict(max_it=600), device="cpu",
                                  extra_obj=lambda X, U: 0.5 * c * ((X - a) ** 2).sum())
    Qp = p["Q"] + c * np.eye(xdim)
    Xrefp = np.linalg.solve(Qp, (np.einsum("mnij,mnj->mni", p["Q"], p["X_ref"])
                                 + c * a)[..., None])[..., 0]
    _, U_e, _ = affine_solve_np(*base[:6], Qp, p["R"], Xrefp, p["U_ref"], reg_x=reg[0],
                                reg_u=reg[1], slew_reg=reg[2], slew_reg0=reg[3],
                                slew_um1=reg[4], u_l=None, u_u=None, x_l=None, x_u=None,
                                Nc=0, settings={})
    np.testing.assert_allclose(U, U_e, atol=2e-3)
    # f32 (100 iterations: the f32 run has stopped moving by then): the
    # autograd gradient through the user's cost stays f32
    base32 = tuple(np.asarray(b, np.float32) for b in base)
    X32, U32, _ = tb.barrier_solve_np(base32, reg, None, None, None, None, Nc=0,
                                      settings=dict(max_it=100), device="cpu",
                                      extra_obj=lambda X, U: 0.5 * c * ((X - a) ** 2).sum())
    assert U32.dtype == np.float32 and np.abs(U32 - U).max() < 1e-3


def test_lbfgs_core_user_cost_on_every_lane():
    """`lbfgs_core` with a user cost at B = 2: two problems stacked on the
    lane axis, each lane against its own exact solve (2e-3, as above) and
    against the same problem solved alone (1e-8: the lanes do not mix)."""
    M, N, xdim, udim = 1, 6, 3, 2
    c, a = 2.0, 0.3
    cost = lambda X, U: 0.5 * c * ((X - a) ** 2).sum()
    reg = (np.full(M, 1.0), np.full(M, 0.1), np.zeros(M), np.zeros(M), np.zeros((M, udim)))
    ps = [oracle.random_problem(np.random.default_rng(seed), M=M, N=N, xdim=xdim, udim=udim)
          for seed in (16, 17)]
    T = lambda k: torch.stack([torch.as_tensor(np.asarray(p[k], np.float64)) for p in ps])
    R = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None].expand(2, *np.shape(a))
    cqp = assemble_condensed(*(T(k) for k in KEYS), *(R(v) for v in reg), Nc=0)
    bt = tipm._layout_bounds(None, None, None, None, M, N, N * xdim, 0, N * udim, udim,
                             np.float64)
    bt = type(bt)(*(v.expand(2, *v.shape[1:]) for v in bt))
    uc, uf, st = tb.lbfgs_core(cqp, bt, "logbarrier", 1.0, 1.0, False, False, iters=600,
                               extra_obj=cost, N=N, xdim=xdim, udim=udim)
    assert uf.shape == (2, M, N * udim) and torch.isfinite(st["obj"]).all()
    for b, p in enumerate(ps):
        base = tuple(p[k] for k in KEYS)
        _, U1, _ = tb.barrier_solve_np(base, reg, None, None, None, None, Nc=0,
                                       settings=dict(max_it=600), device="cpu", extra_obj=cost)
        Ub = uf[b].reshape(M, N, udim).numpy()
        np.testing.assert_allclose(Ub, U1, atol=1e-8, rtol=0)
        Qp = p["Q"] + c * np.eye(xdim)
        Xrefp = np.linalg.solve(Qp, (np.einsum("mnij,mnj->mni", p["Q"], p["X_ref"])
                                     + c * a)[..., None])[..., 0]
        _, U_e, _ = affine_solve_np(*base[:6], Qp, p["R"], Xrefp, p["U_ref"], reg_x=reg[0],
                                    reg_u=reg[1], slew_reg=reg[2], slew_reg0=reg[3],
                                    slew_um1=reg[4], u_l=None, u_u=None, x_l=None, x_u=None,
                                    Nc=0, settings={})
        np.testing.assert_allclose(Ub, U_e, atol=2e-3)


def test_f32_transforms_stay_f32():
    """ROADMAP §3 F2: ``torch.func`` forward mode over per-sample 0-dim
    tensors promoted f32 tangents to f64 in `dynamics.linearize`; the dense
    objective's gradient and Hessian (python-float constants, a user cost)
    stay f32 under ``vmap``."""
    M, N, xdim, udim, nc = 2, 4, 3, 2, 2
    nf = N * udim - nc
    f = tb._dense_objective_fn("logbarrier", lambda X, U: 0.5 * 2.0 * ((X - 0.3) ** 2).sum(),
                               M, N, xdim, udim, nc)
    g32 = torch.Generator().manual_seed(0)
    t = lambda *s: torch.randn(*s, generator=g32)
    args = (torch.eye(nc)[None], torch.zeros(1, M, nc, nf), torch.eye(nf).expand(1, M, nf, nf),
            t(1, nc), t(1, M, nf), t(1, M, N * xdim, N * udim), t(1, M, N * xdim),
            -torch.ones(1, nc), torch.ones(1, nc), -torch.ones(1, M, nf), torch.ones(1, M, nf),
            torch.full((1, M, N * xdim), -torch.inf), torch.full((1, M, N * xdim), torch.inf),
            torch.full((1,), 50.0), torch.ones(1))
    z = torch.zeros(1, nc + M * nf)
    assert torch.func.vmap(torch.func.grad(f))(z, *args).dtype == torch.float32
    assert torch.func.vmap(torch.func.hessian(f))(z, *args).dtype == torch.float32


@pytest.mark.parametrize("solver", ["CVX", "SQP"])
def test_dense_newton_matches_jax(solver):
    M, N, xdim, udim = 2, 8, 3, 2
    p, base, reg = _instance(11, M, N, xdim, udim)
    (ul, uu), _ = _boxes(M, N, xdim, udim)
    kw = dict(Nc=0, method="logbarrier", alpha=50.0, settings=dict(solver=solver))
    X, U, d = tb.barrier_solve_np(base, reg, ul, uu, None, None, device="cpu", **kw)
    Xj, Uj, dj = jb.barrier_solve_np(base, reg, ul, uu, None, None, **kw)
    np.testing.assert_allclose(U, Uj, atol=1e-8, rtol=0)
    assert abs(d["obj"] - dj["obj"]) < 1e-9 * abs(dj["obj"])


def test_positive_cholesky_factorization_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(3, 6, 6))
    H = A @ np.swapaxes(A, -1, -2) - np.array([0.0, 0.5, 4.0])[:, None, None] * np.eye(6)
    L, lam = tso.positive_cholesky_factorization(torch.from_numpy(H))
    for b in range(3):
        Lj, lamj = jso.positive_cholesky_factorization(jnp.asarray(H[b]))
        assert abs(float(lam[b]) - float(lamj)) <= 1e-8 * max(1.0, float(lamj))
        np.testing.assert_allclose(L[b].numpy(), np.asarray(Lj), atol=1e-8, rtol=0)
    assert float(lam[0]) == 0.0 and float(lam[2]) > 0


def _f64_objective(base, reg, ul, uu, Nc, U, method, alpha):
    """The port's smoothed objective of the f64 subproblem at controls U."""
    M, N, udim = U.shape
    nc, nf = Nc * udim, (N - Nc) * udim
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None]
    cqp = assemble_condensed(*(T(a) for a in base + reg), Nc=Nc)
    bt = tipm._layout_bounds(ul, uu, None, None, M, N, N * base[1].shape[-1], nc, nf, udim,
                             np.float64)
    w = torch.as_tensor(np.asarray(U, np.float64)).reshape(M, N * udim)
    F = tb._Smoothed(cqp, bt, method, alpha, 1.0)
    return float(F(w[0, :nc][None, None], w[:, nc:][None, None])[0, 0])


def test_f32_squareplus_optimum_is_flat_in_both_packages():
    """ROADMAP §3 F9 on the headline instance's first subproblem at its full
    M = 32 (`chip_smoke.py` phase 21's instance): in f32 both packages' U
    stop more than 1e-3 from the f64 U (so neither meets a 1e-3 bound on
    U), while the f64 objective at either f32 U is within 1e-6 relative of
    the f64 optimum (~17 f32 roundings of an objective near -3.8e4): the
    gap lies along the flat optimum, not away from it (the f64 runs of the
    two packages agree in `test_barrier_solve_np_matches_jax`)."""
    base64, reg64, ul, uu, Nc = flagship_subproblem(M=32)
    kw = dict(Nc=Nc, method="squareplus", alpha=8.0, settings={})
    _, U64, d64 = tb.barrier_solve_np(base64, reg64, ul, uu, None, None, device="cpu", **kw)
    o64 = d64["obj"]
    base32, reg32 = (tuple(np.asarray(a, np.float32) for a in t) for t in (base64, reg64))
    _, U32, d32 = tb.barrier_solve_np(base32, reg32, ul, uu, None, None, device="cpu", **kw)
    _, Uj32, dj32 = jb.barrier_solve_np(base32, reg32, ul, uu, None, None, **kw)
    o32, oj32 = d32["obj"], dj32["obj"]
    assert U32.dtype == np.float32
    excess = lambda U: (_f64_objective(base64, reg64, ul, uu, Nc, U, "squareplus", 8.0)
                        - o64) / abs(o64)
    print(f"f32 squareplus on the flagship subproblem (M=32): |U32 - U64|_inf port "
          f"{np.abs(U32 - U64).max():.3e}, JAX {np.abs(Uj32 - U64).max():.3e}; objectives "
          f"port {o32:.9g} JAX {oj32:.9g} f64 {o64:.9g}; f64 objective at the f32 U "
          f"(relative excess) port {excess(U32):.3e} JAX {excess(Uj32):.3e}")
    for U, o in ((U32, o32), (Uj32, oj32)):
        assert abs(o - o64) <= 1e-5 * abs(o64), (o, o64)
        assert np.abs(U - U64).max() > 1e-3
        assert 0 <= excess(U) <= 1e-6, excess(U)
