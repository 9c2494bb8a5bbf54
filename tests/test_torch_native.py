"""`pmpc_tpu_torch.native`, the port's ctypes binding of ``native/``'s host
library, against the JAX package's binding and the port's numpy
`canonical`: `build_canonical` to 1e-12 (and exactly equal to the JAX
binding's output, the same library), `admm_box_qp` and `AdmmSolver` on
tests/test_native.py's cases, equal to the JAX binding's results. Skips
when the library cannot be built (no make or no C++ compiler)."""

import time

import numpy as np
import pytest

import oracle
from pmpc_tpu import native as jnat
from pmpc_tpu_torch import canonical as tcan
from pmpc_tpu_torch import native as tnat

KW = dict(max_iter=20000, eps=1e-11)


@pytest.fixture(scope="module")
def lib():
    """The port's library (its own locked build), and the JAX binding's
    loaded for the comparisons. Every xdist worker imports
    tests/test_native.py, whose collection runs ``make -C native`` at once in
    each: a worker that opened the library while another worker's compiler
    wrote it caches a failed load. Clear that cache and load again while
    the other worker's build finishes."""
    if not tnat.available():
        pytest.skip("the native library cannot be built here (a C++ compiler)")
    for _ in range(60):
        if jnat._LIB is not None:
            break
        jnat._TRIED = False
        if jnat.load() is None:
            time.sleep(0.5)
    assert jnat._LIB is not None, "the JAX binding's library did not load"
    return tnat.load()


def _canonical(binding, p, M, udim, Nc, slew=(0.3, 0.2)):
    return binding.build_canonical(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], p["Q"], p["R"],
        p["X_ref"], p["U_ref"], reg_x=1.0, reg_u=0.1, slew_reg=slew[0], slew_reg0=slew[1],
        slew_um1=np.ones((M, udim)), Nc=Nc)


@pytest.mark.parametrize("Nc", [2, 0, -1])
def test_build_canonical_matches_numpy_and_jax_binding(lib, Nc):
    """tests/test_native.py::test_native_canonical_matches_python's problem."""
    rng = np.random.default_rng(60)
    M, N, xdim, udim = 2, 5, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    P, q, A, b = _canonical(tnat, p, M, udim, Nc)
    P_n, q_n = tcan.build_Pq(**p, reg_x=1.0, reg_u=0.1, slew_reg=0.3, slew_reg0=0.2,
                             slew_um1=np.ones((M, udim)), Nc=Nc)
    A_n, b_n = tcan.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], Nc)
    for got, want in ((P, P_n), (q, q_n), (A, A_n), (b, b_n)):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    for got, want in zip((P, q, A, b), _canonical(jnat, p, M, udim, Nc)):
        np.testing.assert_array_equal(got, want)


def _box_problem(seed, N, xdim, udim, half=0.5):
    rng = np.random.default_rng(seed)
    p = oracle.random_problem(rng, M=1, N=N, xdim=xdim, udim=udim)
    P, q, A, b = _canonical(tnat, p, 1, udim, 0, slew=(0.0, 0.0))
    lo, hi = oracle.bounds_vectors(None, None, np.full((1, N, udim), -half),
                                   np.full((1, N, udim), half), N, xdim, udim, 1, 0)
    return rng, P, q, A, b, np.clip(lo, -1e20, 1e20), np.clip(hi, -1e20, 1e20)


def test_admm_box_qp_matches_oracle_and_jax_binding(lib):
    """tests/test_native.py::test_native_admm_solves_box_qp."""
    N, xdim, udim = 6, 3, 2
    _, P, q, A, b, lo, hi = _box_problem(61, N, xdim, udim)
    z, status, iters = tnat.admm_box_qp(P, q, A, b, lo, hi, **KW)
    assert status == 0, (status, iters)
    z_j, status_j, iters_j = jnat.admm_box_qp(P, q, A, b, lo, hi, **KW)
    np.testing.assert_array_equal(z, z_j)
    assert (status, iters) == (status_j, iters_j)
    z_o = oracle.solve_box_qp(P, q, A, b, lo, hi)
    X, U = oracle.split_z(z, N, xdim, udim, 1, 0)
    X_o, U_o = oracle.split_z(z_o, N, xdim, udim, 1, 0)
    np.testing.assert_allclose(U, U_o, atol=5e-4)  # first-order ADMM accuracy
    np.testing.assert_allclose(X, X_o, atol=5e-4)


def test_admm_solver_incremental_prox_and_reset(lib):
    """tests/test_native.py::test_admm_persistent_incremental_and_prox and
    test_admm_prox_setup_twice_replaces_mask, each step equal to the JAX
    binding's persistent solver."""
    rng, P, q, A, b, lo, hi = _box_problem(61, 6, 3, 2)
    n = P.shape[0]
    s, s_j = tnat.AdmmSolver(P, q, A, b, lo, hi), jnat.AdmmSolver(P, q, A, b, lo, hi)

    def both(name, *args, **kw):
        out, out_j = getattr(s, name)(*args, **kw), getattr(s_j, name)(*args, **kw)
        if out is not None:
            np.testing.assert_array_equal(out[0], out_j[0])
            assert out[1:] == out_j[1:]
        return out

    z1, st1, _ = both("solve", **KW)
    z_ref, _, _ = tnat.admm_box_qp(P, q, A, b, lo, hi, **KW)
    assert st1 == 0
    np.testing.assert_allclose(z1, z_ref, atol=1e-7)
    q2 = q + 0.01 * rng.normal(size=n)
    both("set_q", q2)
    z2, st2, it2 = both("solve", **KW)
    _, _, it2_cold = tnat.admm_box_qp(P, q2, A, b, lo, hi, **KW)
    assert st2 == 0 and it2 < it2_cold  # the warm start pays
    v = rng.normal(size=n)
    for mask in (np.full(n, 5.0), np.full(n, 2.5)):  # a second setup replaces the mask
        both("prox_setup", mask)
        zp, stp, _ = both("prox_point", v, mask, **KW)
    z_aug, _, _ = tnat.admm_box_qp(P + np.diag(mask), q2 - mask * v, A, b, lo, hi, **KW)
    assert stp == 0
    np.testing.assert_allclose(zp, z_aug, atol=1e-6)
    both("prox_reset")
    both("set_q", q)
    both("cold_start")
    z3, st3, _ = both("solve", **KW)
    assert st3 == 0
    np.testing.assert_allclose(z3, z_ref, atol=1e-7)
    with pytest.raises(ValueError, match="expected shape"):
        s.set_q(np.zeros(n + 1))
    s.close()
    s_j.close()
