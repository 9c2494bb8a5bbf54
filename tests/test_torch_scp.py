"""The ported SCP main path as a whole (`pmpc_tpu_torch.torch_scp`).

(a)/(b) the accuracy-probe config (benchmarks/accuracy_probe.py) against the
JAX package's f64 answer, benchmarks/accuracy_ref_u64.npy: measured on the
CPU at 1.4e-12 in f64 and 5.6e-4 in f32;
(c) a batched Anderson-accelerated run against `jax.vmap` of the JAX solver;
(d) the port imports no JAX;
(e) the remaining condensed-solver options against `jax.vmap` of the JAX
solver, f64, U and X to 1e-9 with equal iteration counts: the unbounded
solve (BASELINE configs 1 and 2), `lin_cost_fn` (config 4), state boxes,
per-particle `params`, `collect_stats`, and the pod-scale shape of config 5
cut in depth only (M=4, so nf = 90 stays);
(f) the default device is the card: an entry point that is not told
`device="cpu"` raises where there is none;
(g) f32 at the pod-scale horizon: the port's residual trajectory against the
JAX solver's in f32 (same start, same stall above 1e-3, a floor no higher);
(h) `method="riccati"` against `jax.vmap` of the JAX solver built with the
same method, f64, U and X to 1e-9 with equal SCP and IPM iteration counts:
unbounded, control boxes, state boxes, slew (and the NaN poison without
`has_slew`), Anderson acceleration, `return_state` round trip,
`collect_stats`, the long-horizon configuration cut in depth (M = 1,
Nc = 0); and inside the port the Riccati route against the condensed one to
1e-8 with equal IPM iteration counts.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from __graft_entry__ import _dubins, _flagship
from fixtures import unicycle_step
from pmpc_tpu import jax_scp
from pmpc_tpu_torch import torch_scp, utils
from pmpc_tpu_torch.convert import scp_data_from_numpy, warm_from_numpy
from pmpc_tpu_torch.flagship import (CONFIG_KW, PODSCALE_KW, baseline_config,
                                     dubins, flagship, long_horizon,
                                     obstacle_lin_cost, podscale, probe,
                                     stack_varied)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF_U64 = np.load(ROOT / "benchmarks" / "accuracy_ref_u64.npy")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-7), (torch.float32, 1e-3)])
def test_accuracy_probe_matches_jax_f64_reference(dtype, tol):
    solver, data = probe(dtype, device="cpu")
    X, U, info = solver(data)
    assert U.shape == (1,) + REF_U64.shape and U.dtype == dtype
    assert torch.isfinite(X).all()
    assert np.max(np.abs(U[0].double().numpy() - REF_U64)) <= tol


@pytest.mark.parametrize("M", [4, 1])  # M=1: no consensus block (nc=0)
def test_batched_aa_matches_vmapped_jax(M):
    kw = dict(M=M, N=8, Nc=2, ipm_iters=8, max_it=25, res_tol=1e-3, accel="AA")
    j_solver, j_data = _flagship(dtype=np.float64, **kw)
    j_stack = bench._stack_varied(j_data, 2)
    Xr, Ur, info_r = jax.vmap(j_solver)(j_stack)

    t_data = scp_data_from_numpy(j_stack, "cpu", torch.float64)
    t_solver, t_one = flagship(dtype=torch.float64, device="cpu", **kw)
    # the port builds the same instance as the JAX package
    for a, b in zip(stack_varied(t_one, 2), t_data):
        if a is not None:
            assert torch.equal(a, b)
    X, U, info = t_solver(t_data)
    assert np.max(np.abs(U.numpy() - np.asarray(Ur))) < 1e-9
    assert np.max(np.abs(X.numpy() - np.asarray(Xr))) < 1e-9
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(info_r["iters"]))
    np.testing.assert_array_equal(info["converged"].numpy(),
                                  np.asarray(info_r["converged"]))
    assert info["converged"].all()
    np.testing.assert_allclose(info["resid"].numpy(), np.asarray(info_r["resid"]),
                               rtol=1e-6, atol=1e-12)
    assert set(info) == set(info_r)


def test_state_round_trip_and_unported_options():
    solver = torch_scp.build_scp_solver(
        dubins, N=6, xdim=4, udim=2, M=2, Nc=1, max_it=5, has_u_bounds=True,
        ipm_iters=10, return_state=True)
    _, data = flagship(M=2, N=6, Nc=1, dtype=torch.float64, device="cpu")
    data = stack_varied(data, 2)
    _, U1, info1 = solver(data)
    uc, uf, s, lam = info1["solver_state"]
    assert uc.shape == (2, 2) and uf.shape == (2, 2, 10) and s.shape == lam.shape
    _, U2, info2 = solver(data, info1["solver_state"])
    assert torch.isfinite(U2).all()
    # lane refill (ported since): the solver is init_carry, run_chunk to the
    # cap and extract, and a chunked run of those gives its answer exactly
    carry = solver.init_carry(data, info1["solver_state"])
    carry = solver.run_chunk(data, carry, n_it=solver.max_it + 2, max_it=solver.max_it)
    _, U3, info3 = solver.extract(data, carry)
    torch.testing.assert_close(U3, U2, rtol=0, atol=0)
    torch.testing.assert_close(info3["iters"], info2["iters"], rtol=0, atol=0)
    assert set(info3) == set(info2)
    # priccati and relin_stale (ported since: tests/test_torch_priccati.py,
    # tests/test_torch_relin_stale.py) build and run
    for kw in (dict(method="priccati"), dict(relin_stale=1)):
        args = dict(N=6, xdim=4, udim=2, M=2, Nc=1, max_it=5, has_u_bounds=True, ipm_iters=10)
        args.update(kw)
        _, U4, _ = torch_scp.build_scp_solver(dubins, **args)(data)
        assert torch.isfinite(U4).all() and U4.abs().max() <= 1.0 + 1e-6
    # ported since (tests/test_torch_soc.py, tests/test_torch_ipm_options.py);
    # cones need their radii in the data
    for kw in (dict(has_u_soc=True), dict(ipm_gondzio=1), dict(ipm_predictor=False),
               dict(mu_target=0.1)):
        torch_scp.build_scp_solver(dubins, N=6, xdim=4, udim=2, M=2, has_u_bounds=True, **kw)
    with pytest.raises(ValueError, match="u_soc_r"):
        torch_scp.build_scp_solver(dubins, N=6, xdim=4, udim=2, M=2, Nc=1,
                                   has_u_soc=True)(data)


def _jax_stack(data, B, scale=0.02):
    """`benchmarks/configs.bench_solver`'s batch: x0 varied from seed 1."""
    stack = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), data)
    rng = np.random.default_rng(1)
    x0 = np.asarray(stack.x0)
    x0 = x0 + scale * rng.normal(size=x0.shape).astype(x0.dtype)
    return stack._replace(x0=jnp.asarray(x0))


def _hold_against_jax(j_solver, j_stack, t_solver, t_stack=None, tol=1e-9):
    """Run both on the same numbers; returns (torch info, jax info)."""
    Xr, Ur, info_r = jax.vmap(j_solver)(j_stack)
    t_data = scp_data_from_numpy(j_stack, "cpu", torch.float64)
    if t_stack is not None:  # the port's constructor gives the same instance
        for a, b in zip(t_stack, t_data):
            if a is not None:
                assert torch.equal(a, b)
    X, U, info = t_solver(t_data)
    assert np.max(np.abs(U.numpy() - np.asarray(Ur))) < tol
    assert np.max(np.abs(X.numpy() - np.asarray(Xr))) < tol
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(info_r["iters"]))
    np.testing.assert_array_equal(info["converged"].numpy(),
                                  np.asarray(info_r["converged"]))
    assert set(info) == set(info_r)
    return info, info_r


def _jax_config_data(M, N, noise, **kw):
    """The instances of `benchmarks/configs.py` (x0 = ones, plus seed-0 noise
    for config 2), in f64."""
    f64, xdim, udim = np.float64, 4, 2
    x0 = np.ones((M, xdim), f64)
    if noise:
        x0 = x0 + noise * np.random.default_rng(0).normal(size=(M, xdim)).astype(f64)
    return jax_scp.make_scp_data(
        x0, np.tile(np.eye(xdim, dtype=f64), (M, N, 1, 1)),
        np.tile((1e-2 * np.eye(udim)).astype(f64), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1, **kw)


def _obstacle_cost_jax(X_prev, U_prev, data):
    """`benchmarks/configs.py`'s config-4 cost."""
    diff = X_prev[..., :2] - jnp.asarray(np.array([0.5, 0.5]))
    d2 = jnp.sum(diff * diff, axis=-1, keepdims=True) + 0.1
    cx_pos = -0.5 * 2.0 * diff / d2
    return jnp.concatenate([cx_pos, jnp.zeros_like(X_prev[..., 2:])], axis=-1), None


@pytest.mark.parametrize("k", [1, 2, 4])
def test_unbounded_baseline_configs_match_vmapped_jax(k):
    """Configs 1, 2 (solve_eq) and 4 (solve_eq + lin_cost_fn) at their own
    sizes, B=2."""
    M, Nc, noise = (10, 1, 0.05) if k == 2 else (1, 0, 0.0)
    kw = dict(CONFIG_KW, lin_cost_fn=_obstacle_cost_jax) if k == 4 else CONFIG_KW
    j_solver = jax_scp.build_scp_solver(_dubins, N=20, xdim=4, udim=2, M=M, Nc=Nc,
                                        jit=False, **kw)
    j_stack = _jax_stack(_jax_config_data(M, 20, noise), 2)
    t_solver, t_one, B = baseline_config(k, torch.float64, "cpu")
    assert B == (128 if k == 2 else 512)
    info, _ = _hold_against_jax(j_solver, j_stack, t_solver,
                                stack_varied(t_one, 2, scale=0.02))
    assert info["converged"].all()


def _xbox_instance():
    """tests/test_jax_scp.py's state-box instance: control bounds that would
    bind hard if enforced (has_u_bounds=False ignores them), |x| <= 1."""
    N, xdim, udim, M = 8, 4, 2, 2
    d = jax_scp.make_scp_data(
        np.ones((M, xdim)), np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)), reg_x=1.0, reg_u=0.1,
        u_l=-1e-3 * np.ones((M, N, udim)), u_u=1e-3 * np.ones((M, N, udim)),
        x_l=-np.ones((M, N, xdim)), x_u=np.ones((M, N, xdim)))
    return d, dict(N=N, xdim=xdim, udim=udim, M=M, Nc=2, max_it=8, res_tol=1e-6)


@pytest.mark.parametrize("has_u", [False, True])
def test_state_boxes_match_vmapped_jax(has_u):
    d, kw = _xbox_instance()
    if has_u:
        # controls within +-1 beside a box that stays feasible under them:
        # positions within +-2, speed in [-0.2, 1] (its lower end binds)
        x_u = jnp.broadcast_to(jnp.asarray([2.0, 2.0, 1.0, np.inf]), d.x_u.shape)
        x_l = jnp.broadcast_to(jnp.asarray([-2.0, -2.0, -0.2, -np.inf]), d.x_l.shape)
        d = d._replace(u_l=-jnp.ones_like(d.u_l), u_u=jnp.ones_like(d.u_u),
                       x_l=x_l, x_u=x_u)
    kw.update(has_u_bounds=has_u, has_x_bounds=True, return_state=True)
    j_solver = jax_scp.build_scp_solver(unicycle_step, jit=False, **kw)
    t_solver = torch_scp.build_scp_solver(dubins, **kw)
    # x0 moved inwards (-0.02 +- noise) so that the boxes stay feasible
    j_stack = _jax_stack(d._replace(x0=d.x0 - 0.05), 2, scale=0.01)
    Xr, Ur, info_r = jax.vmap(j_solver)(j_stack)
    t_data = scp_data_from_numpy(j_stack, "cpu", torch.float64)
    X, U, info = t_solver(t_data)
    assert np.max(np.abs(U.numpy() - np.asarray(Ur))) < 1e-9
    assert np.max(np.abs(X.numpy() - np.asarray(Xr))) < 1e-9
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(info_r["iters"]))
    if has_u:  # the speed's lower bound and the control bounds bind
        assert abs(X[:, :, 1:, 2].min().item() + 0.2) < 1e-4
        assert abs(U.abs().max().item() - 1.0) < 1e-4
    else:
        assert X[:, :, 1:].max() <= 1.0 + 1e-4  # the state boxes are active
        assert U.abs().max() > 1e-2  # and the control bounds ignored
    # the warm tuple carries the state rows: 2 nc + 2 M nf + 2 M N xdim
    for a, b in zip(info["solver_state"], info_r["solver_state"]):
        assert a.shape == np.asarray(b).shape
    assert info["solver_state"][2].shape == (2, 2 * 4 + 2 * 2 * 12 + 2 * 2 * 8 * 4)
    # ... and crosses from the JAX solver into the port's as a warm start
    _, Ur2, info_r2 = jax.vmap(j_solver)(j_stack, info_r["solver_state"])
    _, U2, info2 = t_solver(t_data, warm_from_numpy(
        info_r["solver_state"], "cpu", torch.float64))
    assert np.max(np.abs(U2.numpy() - np.asarray(Ur2))) < 1e-9
    np.testing.assert_array_equal(info2["iters"].numpy(), np.asarray(info_r2["iters"]))


def test_per_particle_params_match_vmapped_jax():
    """tests/test_jax_scp.py's sampled-dynamics instance: each particle has
    its own (v_scale, w_scale, T)."""
    M, N, xdim, udim = 3, 10, 4, 2
    params = np.stack([[1.0 + 0.2 * i, 1.0, 0.3] for i in range(M)])
    d = jax_scp.make_scp_data(
        np.tile(np.ones(xdim), (M, 1)), np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)), reg_x=1.0, reg_u=0.1,
        params=jnp.asarray(params))
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=4, max_it=20, res_tol=1e-6)
    j_solver = jax_scp.build_scp_solver(
        lambda x, u, p: unicycle_step(x, u, (p[0], p[1], p[2])), jit=False, **kw)
    t_solver = torch_scp.build_scp_solver(
        lambda x, u, p: dubins(x, u, (p[0], p[1], p[2])), **kw)
    info, _ = _hold_against_jax(j_solver, _jax_stack(d, 2), t_solver)
    # `make_scp_data` carries params across too
    t = torch_scp.make_scp_data(np.ones((M, xdim)), np.asarray(d.Q), np.asarray(d.R),
                                params=params, device="cpu")
    assert t.params.shape == (M, 3) and t.params.dtype == t.Q.dtype


@pytest.mark.parametrize("bounded", [True, False])
def test_collect_stats_matches_vmapped_jax(bounded):
    kw = dict(M=3, N=8, Nc=2, ipm_iters=8, max_it=15, res_tol=1e-2, accel="AA",
              collect_stats=True)
    if bounded:
        j_solver, j_data = _flagship(dtype=np.float64, **kw)
        t_solver, _ = flagship(dtype=torch.float64, device="cpu", **kw)
    else:
        kw.pop("ipm_iters")
        j_solver = jax_scp.build_scp_solver(_dubins, xdim=4, udim=2, jit=False, **kw)
        j_data = _jax_config_data(3, 8, 0.05)
        t_solver = torch_scp.build_scp_solver(dubins, xdim=4, udim=2, **kw)
    info, info_r = _hold_against_jax(j_solver, bench._stack_varied(j_data, 2), t_solver)
    ys, ys_r = info["scan_stats"], info_r["scan_stats"]
    assert set(ys) == set(ys_r)
    assert (info["iters"] < 15).all()  # lanes froze before the scan's end
    for key in ys:
        assert ys[key].shape == (2, 15)
        if key == "resid":
            np.testing.assert_allclose(ys[key].numpy(), np.asarray(ys_r[key]),
                                       rtol=1e-6, atol=1e-12)
        else:
            np.testing.assert_array_equal(ys[key].numpy(), np.asarray(ys_r[key]))


@pytest.mark.parametrize("bounded", [True, False])
def test_podscale_shape_matches_vmapped_jax(bounded):
    """Config 5 cut in depth only: M=4 of 64 particles and 5 of 40 SCP
    iterations; N=50, Nc=5, so the Newton blocks stay 90 x 90."""
    kw = dict(PODSCALE_KW, max_it=5)
    if not bounded:
        kw.pop("ipm_iters")
    box = dict(u_l=-np.ones((4, 50, 2)), u_u=np.ones((4, 50, 2))) if bounded else {}
    j_solver = jax_scp.build_scp_solver(_dubins, N=50, xdim=4, udim=2, M=4, Nc=5,
                                        has_u_bounds=bounded, jit=False, **kw)
    j_stack = _jax_stack(_jax_config_data(4, 50, 0.0, **box), 2)
    t_solver, t_one = podscale(torch.float64, "cpu", bounded=bounded, M=4, max_it=5)
    info, _ = _hold_against_jax(j_solver, j_stack, t_solver,
                                stack_varied(t_one, 2, scale=0.02))
    assert (info["iters"] == 5).all()


@pytest.mark.parametrize("bounded", [True, False])
def test_podscale_shape_f32_floor_is_the_reference_s(bounded):
    """f32 at N=50 (nf = 90, M=4, B=2, all 40 iterations, `collect_stats`):
    the port in f32 against the JAX solver in f32 on the same numbers, with
    the port's f64 run (equal to JAX's f64, the test above) as the common
    trajectory. Rounding differences are amplified from one SCP iteration to
    the next, so the two f32 runs agree closely only at first (measured:
    within 1.1e-3 relative over iterations 0-2 and 7.8e-3 at the fourth; each
    within 5.5e-3 of the f64 trajectory over iterations 0-4; held here to
    3e-3 and 2e-2) and then both leave the f64 trajectory at the same rate and stall above 1e-3. Measured floors (min
    resid over the scan, two lanes): bounded JAX 2.8e-3 / 3.3e-3, port
    2.4e-3 / 2.4e-3; unbounded JAX 4.1e-3 / 5.1e-3, port 2.9e-3 / 3.5e-3
    (config 5's bar is 2.5e-3). The port's f32 floor is held to 1.25x the
    reference's: a fault of the port's own f32 path would show above it."""
    kw = dict(PODSCALE_KW, collect_stats=True)
    if not bounded:
        kw.pop("ipm_iters")
    f32 = np.float32
    box = dict(u_l=-np.ones((4, 50, 2), f32), u_u=np.ones((4, 50, 2), f32)) if bounded else {}
    d = jax_scp.make_scp_data(
        np.ones((4, 4), f32), np.tile(np.eye(4, dtype=f32), (4, 50, 1, 1)),
        np.tile((1e-2 * np.eye(2)).astype(f32), (4, 50, 1, 1)),
        reg_x=1.0, reg_u=0.1, **box)
    j_solver = jax_scp.build_scp_solver(_dubins, N=50, xdim=4, udim=2, M=4, Nc=5,
                                        has_u_bounds=bounded, **kw)
    j_stack = _jax_stack(d, 2)
    _, Ur, info_r = jax.vmap(j_solver)(j_stack)
    assert Ur.dtype == jnp.float32
    r_jax = np.asarray(info_r["scan_stats"]["resid"], np.float64)
    r = {}
    for dtype in (torch.float32, torch.float64):
        t_solver, _ = podscale(dtype, "cpu", bounded=bounded, M=4, collect_stats=True)
        _, U, info = t_solver(scp_data_from_numpy(j_stack, "cpu", dtype))
        assert U.dtype == dtype and torch.isfinite(U).all()
        r[dtype] = info["scan_stats"]["resid"].double().numpy()
    r32, r64 = r[torch.float32], r[torch.float64]
    assert r_jax.shape == r32.shape == r64.shape == (2, 40)
    np.testing.assert_allclose(r32[:, :3], r_jax[:, :3], rtol=3e-3)
    np.testing.assert_allclose(r32[:, :5], r64[:, :5], rtol=2e-2)
    np.testing.assert_allclose(r_jax[:, :5], r64[:, :5], rtol=2e-2)
    # f64 reaches config 5's bar; f32 stalls above 1e-3 in both packages ...
    assert (r64.min(axis=1) < 2.5e-3).all()
    assert (r32.min(axis=1) > 1e-3).all() and (r_jax.min(axis=1) > 1e-3).all()
    # ... and the port's floor is no higher than the reference's
    assert (r32.min(axis=1) <= 1.25 * r_jax.min(axis=1)).all()
    assert (np.median(r32[:, -15:], axis=1)
            <= 1.25 * np.median(r_jax[:, -15:], axis=1)).all()


RIC_DIMS = dict(N=10, xdim=4, udim=2, M=3, Nc=2)
RIC_BOX = dict(u_l=-0.6 * np.ones((3, 10, 2)), u_u=0.6 * np.ones((3, 10, 2)))
RIC_SLEW = dict(slew_reg=0.3, slew_reg0=0.5, slew_um1=0.1 * np.ones((3, 2)))
# case -> (build_scp_solver options, data options)
RIC_CASES = {
    "unbounded": (dict(max_it=40, res_tol=1e-4), {}),
    "bounded": (dict(max_it=6, res_tol=1e-7, has_u_bounds=True, ipm_iters=30,
                     collect_stats=True), RIC_BOX),
    "bounded_early_exit": (dict(max_it=40, res_tol=1e-3, has_u_bounds=True,
                                ipm_iters=12), RIC_BOX),
    "aa": (dict(max_it=25, res_tol=1e-3, has_u_bounds=True, ipm_iters=8, accel="AA"),
           RIC_BOX),
    "slew": (dict(max_it=6, res_tol=1e-7, has_u_bounds=True, ipm_iters=30,
                  has_slew=True, collect_stats=True), dict(RIC_BOX, **RIC_SLEW)),
    "slew_unbounded": (dict(max_it=40, res_tol=1e-4, has_slew=True), RIC_SLEW),
}


@pytest.mark.parametrize("case", list(RIC_CASES))
def test_riccati_method_matches_vmapped_jax(case):
    build_kw, data_kw = RIC_CASES[case]
    kw = dict(RIC_DIMS, method="riccati", **build_kw)
    j_solver = jax_scp.build_scp_solver(unicycle_step, **kw)
    t_solver = torch_scp.build_scp_solver(dubins, **kw)
    j_stack = _jax_stack(_jax_config_data(3, 10, 0.05, **data_kw), 2, scale=0.05)
    info, info_r = _hold_against_jax(j_solver, j_stack, t_solver)
    if "collect_stats" in build_kw:  # equal IPM iteration counts, step by step
        ys, ys_r = info["scan_stats"], info_r["scan_stats"]
        assert set(ys) == set(ys_r)
        for key in ("ipm_iters", "ipm_failed", "ipm_converged", "accepted"):
            np.testing.assert_array_equal(ys[key].numpy(), np.asarray(ys_r[key]))
        assert ys["ipm_converged"].all() and (ys["ipm_iters"] > 0).all()
    else:
        assert info["converged"].all()
        assert (info["iters"] < build_kw["max_it"]).all()  # the early exit


def test_riccati_state_boxes_and_state_round_trip_match_vmapped_jax():
    """State boxes beside control boxes through the Riccati route; the warm
    tuple (padded theta, state rows) comes back with `return_state`, has the
    JAX solver's layout and crosses from the JAX solver into the port's."""
    d, kw = _xbox_instance()
    x_u = jnp.broadcast_to(jnp.asarray([2.0, 2.0, 1.0, np.inf]), d.x_u.shape)
    x_l = jnp.broadcast_to(jnp.asarray([-2.0, -2.0, -0.2, -np.inf]), d.x_l.shape)
    d = d._replace(u_l=-jnp.ones_like(d.u_l), u_u=jnp.ones_like(d.u_u), x_l=x_l, x_u=x_u)
    kw.update(has_u_bounds=True, has_x_bounds=True, return_state=True, method="riccati")
    j_solver = jax_scp.build_scp_solver(unicycle_step, **kw)
    t_solver = torch_scp.build_scp_solver(dubins, **kw)
    j_stack = _jax_stack(d._replace(x0=d.x0 - 0.05), 2, scale=0.01)
    info, info_r = _hold_against_jax(j_solver, j_stack, t_solver)
    for a, b in zip(info["solver_state"], info_r["solver_state"]):
        assert a.shape == np.asarray(b).shape
    assert info["solver_state"][2].shape == (2, 2 * 4 + 2 * 2 * 12 + 2 * 2 * 8 * 4)
    t_data = scp_data_from_numpy(j_stack, "cpu", torch.float64)
    X, U, _ = t_solver(t_data)
    assert abs(X[:, :, 1:, 2].min().item() + 0.2) < 1e-4  # the speed's floor binds
    _, Ur2, info_r2 = jax.vmap(j_solver)(j_stack, info_r["solver_state"])
    _, U2, info2 = t_solver(t_data, warm_from_numpy(
        info_r["solver_state"], "cpu", torch.float64))
    assert np.max(np.abs(U2.numpy() - np.asarray(Ur2))) < 1e-9
    np.testing.assert_array_equal(info2["iters"].numpy(), np.asarray(info_r2["iters"]))
    # without consensus the padded theta has one dead entry
    solver1 = torch_scp.build_scp_solver(dubins, N=6, xdim=4, udim=2, M=1, max_it=2,
                                         has_u_bounds=True, method="riccati",
                                         return_state=True)
    _, one = flagship(M=1, N=6, dtype=torch.float64, device="cpu")
    th, uf, s_w, _ = solver1(stack_varied(one, 2))[2]["solver_state"]
    assert th.shape == (2, 1) and uf.shape == (2, 1, 12) and s_w.shape == (2, 2 + 24)


@pytest.mark.parametrize("option", ["params", "lin_cost_fn", "no_u_bounds"])
def test_riccati_method_takes_the_solver_options_unchanged(option):
    """Per-particle dynamics `params`, `lin_cost_fn` (config 4's obstacle
    cost) and state boxes with the control bounds ignored (+-inf inside the
    IPM) through `method="riccati"`, against `jax.vmap` of the JAX solver."""
    M, N = 3, 10
    kw = dict(RIC_DIMS, method="riccati", max_it=6, res_tol=1e-7)
    j_dyn, t_dyn, data_kw = unicycle_step, dubins, dict(RIC_BOX)
    if option == "params":
        kw.update(has_u_bounds=True, ipm_iters=30)
        data_kw["params"] = jnp.asarray(np.stack([[1.0 + 0.2 * i, 1.0, 0.3] for i in range(M)]))
        j_dyn = lambda x, u, p: unicycle_step(x, u, (p[0], p[1], p[2]))
        t_dyn = lambda x, u, p: dubins(x, u, (p[0], p[1], p[2]))
    elif option == "lin_cost_fn":
        kw.update(has_u_bounds=True, ipm_iters=30)
    else:  # the finite control bounds in the data must be ignored
        kw.update(has_x_bounds=True, ipm_iters=30)
        data_kw.update(u_l=-1e-3 * np.ones((M, N, 2)), u_u=1e-3 * np.ones((M, N, 2)),
                       x_l=-1.3 * np.ones((M, N, 4)), x_u=1.3 * np.ones((M, N, 4)))
    j_kw = dict(kw, lin_cost_fn=_obstacle_cost_jax) if option == "lin_cost_fn" else kw
    t_kw = dict(kw, lin_cost_fn=obstacle_lin_cost) if option == "lin_cost_fn" else kw
    j_stack = _jax_stack(_jax_config_data(M, N, 0.05, **data_kw), 2, scale=0.05)
    info, _ = _hold_against_jax(jax_scp.build_scp_solver(j_dyn, **j_kw), j_stack,
                                torch_scp.build_scp_solver(t_dyn, **t_kw))
    assert (info["iters"] == 6).all() and torch.isfinite(info["resid"]).all()


def test_riccati_without_has_slew_poisons_lanes_that_carry_slew_terms():
    """Lane 1 carries slew terms and the solver was built without
    `has_slew`: its result is NaN-poisoned, so the lane freezes on its start
    and reports not converged; lane 0 is solved. The JAX solver does the
    same."""
    kw = dict(RIC_DIMS, method="riccati", max_it=40, res_tol=1e-4)
    j_stack = _jax_stack(_jax_config_data(3, 10, 0.05), 2, scale=0.05)
    j_stack = j_stack._replace(slew_reg=j_stack.slew_reg.at[1].set(0.3))
    info, info_r = _hold_against_jax(jax_scp.build_scp_solver(unicycle_step, **kw),
                                     j_stack, torch_scp.build_scp_solver(dubins, **kw))
    assert info["converged"].tolist() == [True, False]
    assert torch.isinf(info["resid"][1])


def test_riccati_route_matches_condensed_route_in_the_port():
    """Both routes run identical Mehrotra steps, only the Newton solver
    differs: same solution to 1e-8, same warm-started IPM iteration counts
    (twin of tests/test_riccati_ipm.py::test_fused_riccati_scp_matches_condensed)."""
    kw = dict(N=14, Nc=3, M=3, max_it=8, res_tol=1e-7, ipm_iters=40, ipm_tol_exp=-10,
              collect_stats=True, adaptive_tol=False, dtype=torch.float64, device="cpu")
    out = {}
    for method in ("condensed", "riccati"):
        solver, data = flagship(method=method, **kw)
        data = data._replace(u_l=0.6 * data.u_l, u_u=0.6 * data.u_u)
        out[method] = solver(stack_varied(data, 2))
    (Xc, Uc, ic), (Xr, Ur, ir) = out["condensed"], out["riccati"]
    assert (Ur - Uc).abs().max() < 1e-8 and (Xr - Xc).abs().max() < 1e-8
    its = ir["scan_stats"]["ipm_iters"]
    assert torch.equal(its, ic["scan_stats"]["ipm_iters"])
    assert (its[:, -1] < its[:, 0]).all()  # the warm start cuts the count
    assert Ur.abs().max() <= 0.6 + 1e-8
    assert (Ur[:, :, :3] - Ur[:, :1, :3]).abs().max() < 1e-10  # exact consensus


def test_long_horizon_config_matches_vmapped_jax():
    """`benchmarks/long_horizon_bench.py`'s configuration cut in depth only
    (N = 40 of 140 / 280): M = 1, Nc = 0, control boxes, state boxes, slew."""
    N, f64 = 40, np.float64
    j_solver = jax_scp.build_scp_solver(
        _dubins, N=N, xdim=4, udim=2, M=1, Nc=0, max_it=4, res_tol=1e-9,
        has_u_bounds=True, has_x_bounds=True, has_slew=True, method="riccati",
        ipm_iters=8)
    j_data = jax_scp.make_scp_data(
        np.ones((1, 4), f64), np.tile(np.eye(4, dtype=f64), (1, N, 1, 1)),
        np.tile((1e-2 * np.eye(2)).astype(f64), (1, N, 1, 1)),
        reg_x=1.0, reg_u=0.1, slew_reg=0.1,
        u_l=-np.ones((1, N, 2), f64), u_u=np.ones((1, N, 2), f64),
        x_l=-np.full((1, N, 4), 6.0, f64), x_u=np.full((1, N, 4), 6.0, f64))
    t_solver, t_one = long_horizon(N, torch.float64, "cpu")
    info, _ = _hold_against_jax(j_solver, bench._stack_varied(j_data, 2), t_solver,
                                stack_varied(t_one, 2))
    assert (info["iters"] == 4).all()


def test_riccati_gates():
    args = dict(N=6, xdim=4, udim=2, M=2, has_u_bounds=True)
    # priccati is ported (tests/test_torch_priccati.py); what the JAX
    # build_scp_solver refuses on that route, the port refuses with its messages
    torch_scp.build_scp_solver(dubins, method="priccati", **args)
    for kw in (dict(has_u_soc=True), dict(has_x_bounds=True)):
        with pytest.raises(NotImplementedError, match="state boxes or SOC cones"):
            torch_scp.build_scp_solver(dubins, method="priccati", **args, **kw)
    with pytest.raises(NotImplementedError, match="slew coupling"):
        torch_scp.build_scp_solver(dubins, N=6, xdim=4, udim=2, M=2, method="priccati",
                                   has_slew=True)
    for kw in (dict(has_u_soc=True), dict(mu_target=0.1)):  # ported since
        torch_scp.build_scp_solver(dubins, method="riccati", **args, **kw)
    for kw in (dict(relin_stale=1), dict(ipm_predictor=False), dict(ipm_gondzio=1)):
        with pytest.raises(ValueError, match="only supported with method='condensed'"):
            torch_scp.build_scp_solver(dubins, method="riccati", **args, **kw)
    with pytest.raises(ValueError, match="unknown method"):
        torch_scp.build_scp_solver(dubins, method="sparse", **args)
    # `riccati_unroll` is taken and has no effect
    torch_scp.build_scp_solver(dubins, method="riccati", riccati_unroll=8, **args)


def test_default_device_is_the_card(monkeypatch):
    """An explicit device="cpu" works; without it the entry points go to the
    card and raise where there is none (no quiet CPU run)."""
    solver, data = flagship(M=2, N=4, Nc=1, device="cpu")
    assert data.Q.device.type == "cpu"
    # a tensor input fixes the device too
    again = torch_scp.make_scp_data(data.x0, data.Q, data.R)
    assert again.u_l.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        utils.default_device()
    for build in (flagship, probe, podscale, lambda: baseline_config(1),
                  lambda: long_horizon(8), lambda: flagship(method="riccati")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    Q = np.tile(np.eye(4), (2, 4, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_scp.make_scp_data(np.ones((2, 4)), Q, Q[..., :2, :2])


def test_port_imports_no_jax():
    mods = sorted(
        "pmpc_tpu_torch." + ".".join(p.relative_to(ROOT / "pmpc_tpu_torch")
                                     .with_suffix("").parts)
        for p in (ROOT / "pmpc_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'pmpc_tpu' or m.startswith('pmpc_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "pmpc_tpu_torch.torch_scp" in mods and "pmpc_tpu_torch.ops.chol_inv" in mods
    assert {"pmpc_tpu_torch.solvers.riccati", "pmpc_tpu_torch.solvers.riccati_ipm",
            "pmpc_tpu_torch.flagship", "pmpc_tpu_torch.profile_call",
            "pmpc_tpu_torch.solvers.coneipm", "pmpc_tpu_torch.solvers.compose",
            "pmpc_tpu_torch.solvers.extras", "pmpc_tpu_torch.solvers.cvar",
            "pmpc_tpu_torch.conebatch", "pmpc_tpu_torch.convert",
            "pmpc_tpu_torch.solvers.expbarrier", "pmpc_tpu_torch.solvers.barrier",
            "pmpc_tpu_torch.solvers.second_order", "pmpc_tpu_torch.solvers.dispatch",
            "pmpc_tpu_torch.scp", "pmpc_tpu_torch.problem", "pmpc_tpu_torch.canonical",
            "pmpc_tpu_torch.filters", "pmpc_tpu_torch.accelerated", "pmpc_tpu_torch.tune",
            "pmpc_tpu_torch.experimental", "pmpc_tpu_torch.batch", "pmpc_tpu_torch.remote",
            "pmpc_tpu_torch.warmup", "pmpc_tpu_torch.sensitivity",
            "pmpc_tpu_torch.native", "pmpc_tpu_torch.ipm_crawl", "pmpc_tpu_torch.stream",
            "pmpc_tpu_torch.particles", "pmpc_tpu_torch.solvers.priccati",
            "pmpc_tpu_torch.parallel.mesh", "pmpc_tpu_torch.parallel.sharded",
            "pmpc_tpu_torch.parallel.distributed", "pmpc_tpu_torch.parallel.check"} <= set(mods)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert {"pmpc_tpu_torch.flagship", "pmpc_tpu_torch.conebatch",
            "pmpc_tpu_torch.solvers.compose"} <= set(names)
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "pmpc_tpu", "bench", "__graft_entry__"}
