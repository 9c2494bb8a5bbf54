"""Stale-Jacobian sub-iterations in the port (`relin_stale`,
`reduced.update_condensed_linear`), f64 on the CPU, against the JAX package
on the same seeded inputs:

- `update_condensed_linear` against the JAX function, to 1e-12, over slew
  terms and Nc in {0, 2, 6};
- the twin of tests/test_jax_scp.py::test_relin_stale_same_fixed_point: the
  port with ``relin_stale=1`` against the JAX solver with it (U to 1e-8,
  equal SCP iteration counts), and against the port with ``relin_stale=0``
  at the JAX test's 2e-5 (the same fixed point);
- ``relin_stale=2`` with the bounded IPM against `jax.vmap` of the JAX
  solver on a batch of 3 (U to 1e-8, equal counts);
- ``relin_stale=1`` on the headline program (M=32, N=30, Nc=5, AA) at the
  budget of benchmarks/ab_stale.py (27 sub-steps), where most lanes do not
  converge: the port against the JAX solver at B=4 (equal converged lanes
  and counts, U to 1e-7).

``PYTHONPATH=. python tests/test_torch_relin_stale.py [B]`` (from the repo
root) runs the last comparison at B scenarios (default 64, ab_stale's) in
f64 and f32 and prints each package's converged fraction.
"""

import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.jax_scp import build_scp_solver as j_build, make_scp_data as j_make
from pmpc_tpu.solvers import reduced as jred
from pmpc_tpu_torch.convert import scp_data_from_numpy
from pmpc_tpu_torch.solvers import reduced as tred
from pmpc_tpu_torch.torch_scp import build_scp_solver
from test_torch_reduced import ARGS, jax_cqp, problem, to_torch

torch.set_num_threads(2)
f64 = torch.float64


@pytest.mark.parametrize("Nc", [0, 2, 6])
def test_update_condensed_linear_matches_jax(Nc):
    p = problem(31 + Nc)
    rng = np.random.default_rng(7)
    # a new prox centre and new references (lin_cost_fn shifts them)
    new = dict(X_prev=rng.normal(size=p["X_prev"].shape),
               U_prev=0.3 * rng.normal(size=p["U_prev"].shape),
               X_ref=rng.normal(size=p["X_ref"].shape),
               U_ref=rng.normal(size=p["U_ref"].shape))
    keys = ("X_prev", "U_prev", "Q", "R", "X_ref", "U_ref", "reg_x", "reg_u",
            "slew_reg0", "slew_um1")
    q_all = {**p, **new}
    jc = jax_cqp(p, Nc)
    jc2 = jax.vmap(jred.update_condensed_linear)(jc, *[jnp.asarray(q_all[k]) for k in keys])
    t = to_torch(p)
    tc = tred.assemble_condensed(*[t[k] for k in ARGS], Nc=Nc)
    tq = to_torch(q_all)
    tc2 = tred.update_condensed_linear(tc, *[tq[k] for k in keys])
    for name in ("qc", "qf"):
        np.testing.assert_allclose(getattr(tc2, name).numpy(), np.asarray(getattr(jc2, name)),
                                   rtol=0, atol=1e-12)
    # the map and every Hessian block are kept
    for name in ("Hcc", "Hcf", "Hff", "Ft", "g", "Qt", "Rt"):
        assert getattr(tc2, name) is getattr(tc, name)
    # at the assembly's own centre the update gives the assembly's q
    tc3 = tred.update_condensed_linear(tc, *[t[k] for k in keys])
    torch.testing.assert_close(tc3.qf, tc.qf, rtol=0, atol=1e-12)
    torch.testing.assert_close(tc3.qc, tc.qc, rtol=0, atol=1e-12)


def _dyn_j(x, u):
    return x + 0.1 * jnp.concatenate([jnp.sin(x[2:4]), u])


def _dyn_t(x, u):
    return x + 0.1 * torch.cat([torch.sin(x[2:4]), u])


def _data(M, N, x0):
    xdim, udim = 4, 2
    return j_make(x0, np.tile(np.eye(xdim), (M, N, 1, 1)),
                  np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
                  u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)))


def _port_batch(j_batch):
    return scp_data_from_numpy(jax.tree.map(np.asarray, j_batch), "cpu", f64)


def test_relin_stale_same_fixed_point():
    """tests/test_jax_scp.py's instance (f64): M = 3, N = 12, Nc = 3, AA."""
    N, M = 12, 3
    j_data = _data(M, N, np.ones((M, 4)))
    kw = dict(N=N, xdim=4, udim=2, M=M, Nc=3, max_it=40, res_tol=1e-6,
              has_u_bounds=True, accel="AA")
    j1 = j_build(_dyn_j, relin_stale=1, jit=False, **kw)
    t0 = build_scp_solver(_dyn_t, **kw)
    t1 = build_scp_solver(_dyn_t, relin_stale=1, **kw)
    j_batch = jax.tree.map(lambda a: a[None], j_data)
    Xj, Uj, ij = jax.jit(jax.vmap(j1))(j_batch)
    data = _port_batch(j_batch)
    X0, U0, i0 = t0(data)
    X1, U1, i1 = t1(data)
    assert bool(i0["converged"].all()) and bool(i1["converged"].all())
    np.testing.assert_allclose(U1.numpy(), np.asarray(Uj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(X1.numpy(), np.asarray(Xj), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(i1["iters"].numpy(), np.asarray(ij["iters"]))
    np.testing.assert_allclose(U0.numpy(), U1.numpy(), rtol=0, atol=2e-5)


def test_relin_stale_two_matches_vmapped_jax():
    """relin_stale=2 over a batch of 3 with different starts: the stale
    sub-steps, the IPM warm start across them and the per-lane counts."""
    N, M = 10, 2
    rng = np.random.default_rng(12)
    j_datas = [_data(M, N, np.ones((M, 4)) + 0.5 * rng.normal(size=(M, 4))) for _ in range(3)]
    j_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *j_datas)
    kw = dict(N=N, xdim=4, udim=2, M=M, Nc=2, max_it=12, res_tol=1e-6,
              has_u_bounds=True, relin_stale=2)
    Xj, Uj, ij = jax.jit(jax.vmap(j_build(_dyn_j, jit=False, **kw)))(j_batch)
    X, U, info = build_scp_solver(_dyn_t, **kw)(_port_batch(j_batch))
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(ij["iters"]))
    np.testing.assert_array_equal(info["converged"].numpy(), np.asarray(ij["converged"]))


STALE_KW = dict(relin_stale=1, max_it=27)  # benchmarks/ab_stale.py's budget at relin_stale=1


def flagship_pair(B, dtype):
    """The headline program with STALE_KW in both packages on the same
    stacked scenarios: (JAX result, port result)."""
    from __graft_entry__ import _flagship
    from bench import _stack_varied
    from pmpc_tpu_torch.flagship import HEADLINE_KW, flagship

    kw = dict(HEADLINE_KW, **STALE_KW)
    j_solver, j_one = _flagship(dtype=np.dtype(str(dtype)[6:]).type, **kw)
    stack = _stack_varied(j_one, B)
    Xj, Uj, ij = jax.jit(jax.vmap(j_solver))(stack)
    solver, _ = flagship(dtype=dtype, device="cpu", **kw)
    X, U, info = solver(scp_data_from_numpy(jax.tree.map(np.asarray, stack), "cpu", dtype))
    return (np.asarray(Uj), jax.tree.map(np.asarray, ij)), \
        (U.numpy(), {k: v.numpy() for k, v in info.items() if torch.is_tensor(v)})


def test_relin_stale_flagship_matches_jax():
    """Where the stale steps stall (most lanes hit the cap), the port still
    takes JAX's path: the same lanes converge, at the same counts."""
    (Uj, ij), (U, info) = flagship_pair(4, f64)
    assert 0 < int(ij["converged"].sum()) < 4
    np.testing.assert_array_equal(info["converged"], ij["converged"])
    np.testing.assert_array_equal(info["iters"], ij["iters"])
    np.testing.assert_allclose(U, Uj, rtol=0, atol=1e-7)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    for dtype in (f64, torch.float32):
        t0 = time.perf_counter()
        (Uj, ij), (U, info) = flagship_pair(B, dtype)
        print(f"headline program, relin_stale=1, max_it=27, B={B}, {str(dtype)[6:]}, CPU: "
              f"converged JAX {ij['converged'].mean():.4f}, port {info['converged'].mean():.4f}; "
              f"lanes alike {(ij['converged'] == info['converged']).mean():.4f}, counts equal "
              f"{(ij['iters'] == info['iters']).mean():.4f}, |U - U_jax|_inf "
              f"{np.abs(U - Uj).max():.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)
