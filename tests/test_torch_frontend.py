"""The port's numpy frontend modules and its host-loop wrappers against the
JAX package, f64, on the CPU.

(a) `Problem` (dimension inference, defaults, tiling over M, the Mapping
protocol, the refresh of X_prev when x0 is set), `canonical` (the
exported P, q, A, b, G, l, u) and the `filters` weights equal to the JAX
package's, exactly or to 1e-12; `TablePrinter` prints identical strings;
(b) `make_f_fx_fu_fn` over the torch unicycle (`flagship.dubins`) against
the JAX one over the fixtures' unicycle to 1e-12, in one transfer, f32
stays f32;
(c) `accelerated_scp_solve` and `tune_scp` against the JAX package's, both
loops on the port's subproblem solver (tests/test_torch_dispatch.py holds
it against the JAX one): U to 1e-10 with equal SCP and IPM iteration
counts; the `experimental` shim; the package exports (``solve_problems``
and ``remote`` loaded on first use), SOLVE_KWS with ``device``, and
``device=None`` without a card."""

import numpy as np
import pytest
import torch

import pmpc_tpu
from fixtures import dubins_f_fx_fu_fn
from pmpc_tpu import canonical as jcan
from pmpc_tpu import filters as jfil
from pmpc_tpu import utils as jutils
from pmpc_tpu.problem import Problem as JProblem

import pmpc_tpu_torch
from pmpc_tpu_torch import canonical as tcan
from pmpc_tpu_torch import experimental as texp
from pmpc_tpu_torch import filters as tfil
from pmpc_tpu_torch import utils as tutils
from pmpc_tpu_torch.flagship import dubins
from pmpc_tpu_torch.problem import Problem as TProblem

import oracle

torch.set_num_threads(1)

F64 = dict(dtype=np.float64)


def _same(a, b, tol=0.0):
    """Equal dicts / arrays / scalars, arrays to ``tol``."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k], tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    else:
        assert a == b


def test_problem_matches_jax():
    kws = [dict(N=20, xdim=4, udim=2),
           dict(Q=np.tile(np.eye(3), (7, 1, 1)), R=np.tile(np.eye(1), (7, 1, 1))),
           dict(N=10, xdim=4, udim=2, M=3, reg_x=2.0, max_it=5,
                solver_settings=dict(Nc=2), u_u=np.ones((10, 2)))]
    for kw in kws:
        pj, pt = JProblem(**kw), TProblem(**kw)
        assert pt.dims == pj.dims and pt.M == pj.M and repr(pt) == repr(pj)
        for obj in (pj, pt):
            obj.x0 = np.arange(obj.xdim, dtype=float)  # refreshes X_prev
            obj.f_fx_fu_fn = len
        dj, dt = dict(pj), dict(pt)
        assert list(dj) == list(dt)
        dj.pop("f_fx_fu_fn"), dt.pop("f_fx_fu_fn")
        for k in dj:
            if isinstance(dj[k], dict):
                assert dj[k] == dt[k]
            elif dj[k] is None or np.isscalar(dj[k]):
                assert dj[k] == dt[k]
            else:
                _same(dj[k], dt[k])
    with pytest.raises(ValueError, match="Missing dimension udim"):
        TProblem(N=5, xdim=2)
    p = TProblem(N=10, xdim=4, udim=2, M=3)
    with pytest.raises(AssertionError, match="wrong shape"):
        p.x0 = np.ones(5)


def test_canonical_matches_jax():
    rng = np.random.default_rng(5)
    M, N, xdim, udim, Nc = 2, 4, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    args = [p[k] for k in ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref",
                           "U_ref")]
    lu = rng.normal(size=(M, N, udim)) - 1.0
    settings = dict(Nc=Nc, weights=np.array([1.0, 3.0]), reg_x=0.5, reg_u=0.2, slew_reg=0.3,
                    slew_reg0=0.4, slew_um1=rng.normal(size=(M, udim)), lu=lu, uu=-lu,
                    lx=-np.ones((M, N, xdim)), ux=np.ones((M, N, xdim)))
    for st in (settings, dict(Nc=-1)):
        out_j = jcan.lqp_generate_problem_matrices(*args, **st)
        out_t = pmpc_tpu_torch.lqp_generate_problem_matrices(*args, **st)
        for a, b in zip(out_t, out_j):
            _same(np.asarray(a), np.asarray(b), 1e-12)
    n, u_idx, x_idx = tcan.layout(N, xdim, udim, M, Nc)
    nj, uj, xj = jcan.layout(N, xdim, udim, M, Nc)
    assert n == nj and all(u_idx(i, j) == uj(i, j) and x_idx(i, j) == xj(i, j)
                           for i in range(M) for j in range(N))


def test_filters_and_table_printer_match_jax():
    rng = np.random.default_rng(2)
    Fs = [rng.normal(size=(3, 4)) for _ in range(5)]
    for name in ("AA", "smooth", "select"):
        _same(tfil.FILTER_MAP[name](Fs), jfil.FILTER_MAP[name](Fs), 1e-12)
    Fs[2] = np.zeros((3, 4))
    _same(tfil.select_method(Fs), jfil.select_method(Fs))
    cols = (["it", "elaps", "obj", "name"], ["%04d", "%8.3e", "%9.4e", "%s"])
    for prefix in ("", "  "):
        tj = jutils.TablePrinter(*cols, prefix=prefix)
        tt = tutils.TablePrinter(*cols, prefix=prefix)
        row = (3, 0.125, -12.5, "ab")
        assert tt.make_header() == tj.make_header()
        assert tt.make_values(row) == tj.make_values(row)
        assert tt.make_footer() == tj.make_footer()
        assert tt.widths == tj.widths
    with pytest.raises(ValueError, match="Unrecognized print format"):
        tutils.TablePrinter(["a"], ["%d%d"])
    for x, n in ((np.ones(3), 3), (None, 2), (np.ones((2, 3)), 1)):
        a, b = tutils.atleast_nd(x, n), jutils.atleast_nd(x, n)
        assert (a is None and b is None) or a.shape == b.shape
    assert tutils.numpy_dtype(torch.float32) == np.float32
    assert tutils.numpy_dtype("float64") == np.float64


def test_make_f_fx_fu_fn_matches_jax_in_one_transfer(monkeypatch):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2, 5, 4))
    U = rng.normal(size=(2, 5, 2))
    fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")
    assert fn.__wrapped_dynamics__ is dubins
    reads = []
    real = tutils.to_host
    monkeypatch.setattr("pmpc_tpu_torch.dynamics.to_host",
                        lambda ts: reads.append(len(ts)) or real(ts))
    out_t = fn(X, U)
    assert reads == [3]  # f, fx, fu in one transfer
    out_j = dubins_f_fx_fu_fn()(X, U)
    for a, b in zip(out_t, out_j):
        _same(a, np.asarray(b), 1e-12)
    f32 = fn(X.astype(np.float32), U.astype(np.float32))
    assert all(a.dtype == np.float32 for a in f32)


def _dubins_case(M=1, N=8):
    xdim, udim = 4, 2
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim))
    return Q, R, x0


@pytest.fixture
def port_solver_under_jax(monkeypatch):
    """The JAX loops on the port's subproblem solver (which
    tests/test_torch_dispatch.py holds against the JAX one): the loops
    alone are compared."""
    from pmpc_tpu.solvers import dispatch as jdisp
    from pmpc_tpu_torch.solvers import dispatch as tdisp

    monkeypatch.setattr(jdisp, "affine_solve_np",
                        lambda *a, **k: tdisp.affine_solve_np(*a, **k, device="cpu"))


def test_accelerated_scp_solve_matches_jax(port_solver_under_jax):
    Q, R, x0 = _dubins_case()
    fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")
    kw = dict(verbose=False, max_it=8, res_tol=1e-5, reg_x=1.0, reg_u=0.1,
              u_l=-np.ones((1, 8, 2)), u_u=np.ones((1, 8, 2)), solver_settings=F64)
    Xj, Uj, dj = pmpc_tpu.accelerated_scp_solve(fn, Q, R, x0, **kw)
    Xt, Ut, dt = pmpc_tpu_torch.accelerated_scp_solve(fn, Q, R, x0, device="cpu", **kw)
    assert len(dt["hist"]) == len(dj["hist"]) and set(dt) == set(dj)
    np.testing.assert_allclose(Ut, Uj, atol=1e-10)
    np.testing.assert_allclose(Xt, Xj, atol=1e-10)
    assert [d["ipm_iters"] for d in dt["solver_data"]] == \
        [d["ipm_iters"] for d in dj["solver_data"]]


def test_tune_scp_matches_jax(port_solver_under_jax):
    Q, R, x0 = _dubins_case()
    fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")
    kw = dict(sample_nb=3, reg_rng=(-1, 1), max_it=4, solver_settings=F64)
    best_j = pmpc_tpu.tune_scp(fn, Q, R, x0, **kw)
    best_t = pmpc_tpu_torch.tune_scp(fn, Q, R, x0, device="cpu", **kw)
    np.testing.assert_allclose(best_t, best_j, rtol=1e-12)
    # a solve that fails scores +inf: it never wins the sweep
    from pmpc_tpu_torch import tune

    assert tune._final_residual(lambda *a, **k: (None, None, None), (), {}) == np.inf


def test_experimental_shim_and_package_exports(monkeypatch):
    Q, R, x0 = _dubins_case()
    fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")
    with pytest.raises(ValueError, match="experimental API does not support"):
        texp.scp_solve(fn, Q, R, x0, extra_cstrs_fns=lambda *a: [], device="cpu")
    X, U, data = texp.solve(fn, Q, R, x0, u_l=-np.ones((1, 8, 2)), u_u=np.ones((1, 8, 2)),
                            max_it=2, dtype=torch.float64, device="cpu")
    assert U.dtype == np.float64 and np.isfinite(U).all() and np.abs(U).max() < 1.0
    assert pmpc_tpu_torch.SOLVE_KWS == pmpc_tpu.SOLVE_KWS | {"device"}
    assert "device" in texp.SOLVE_KWS
    for name in ("solve", "scp_solve", "aff_solve", "solve_with_a_dict", "Problem",
                 "make_f_fx_fu_fn", "linearize", "rollout", "lqp_generate_problem_matrices",
                 "build_scp_solver", "accelerated_scp_solve", "tune_scp"):
        assert callable(getattr(pmpc_tpu_torch, name))
    # batching and serving resolve on first use, as in the JAX package
    from pmpc_tpu_torch.batch import solve_problems

    assert pmpc_tpu_torch.solve_problems is solve_problems
    assert pmpc_tpu_torch.remote.SUPPORTED_METHODS["solve_batch"] is solve_problems
    with pytest.raises(AttributeError, match="no attribute 'no_such_entry_point'"):
        pmpc_tpu_torch.no_such_entry_point
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmpc_tpu_torch.solve(fn, Q, R, x0, max_it=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmpc_tpu_torch.make_f_fx_fu_fn(dubins)
