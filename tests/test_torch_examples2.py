"""The example scripts of the port against the JAX package's, second half
(see tests/test_torch_examples.py): `custom_cost`, `receding_horizon` and
`arbitrary_constraints`, on the CPU at the smoke sizes.

- `custom_cost`: the ``lin_cost_fn`` part and the SQP part (a Newton method:
  iterate for iterate) in f64 to 1e-6 with equal SCP iteration counts; the
  L-BFGS part at the smoothed optimum, not iterate for iterate, to 5e-3
  (tests/test_torch_barrier.py's bound for the port's own L-BFGS against
  the JAX package's).
- `receding_horizon`: the JAX script's importable ``closed_loop_fused(8, 4,
  4, 2)`` against the twin's (f32, as the script pins it): equal SCP
  iterations at every control step, tracking errors within 1e-4; the host
  loop in f64 (errors within 1e-6); the IPM state the fused solver carries
  across steps keeps its device and dtype.
- `arbitrary_constraints`: the thrust cones and the 8-tuple extra
  constraints (both on the condensed cone route) against the JAX Riccati
  core, and the 8-tuple on the composed cone program in both packages, f64,
  1e-6, their constraints held."""

import numpy as np
import pytest
import torch

import pmpc_tpu
from test_torch_examples import F64, TOL, fast, held, jax_script  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def custom_cost():
    from pmpc_tpu_torch.examples import custom_cost as tw

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMPC_EXAMPLES_FAST", "1")
        res = tw.main(device="cpu", dtype=F64)
        base = tw.base_problem(F64)
    return tw, res, base


def test_custom_cost_lin_cost_fn(custom_cost):
    tw, res, base = custom_cost
    f_j = pmpc_tpu.make_f_fx_fu_fn(jax_script("custom_cost").unicycle)
    held(res["lin"], pmpc_tpu.solve(f_j, lin_cost_fn=tw.lin_cost_fn, **base))


@pytest.mark.parametrize("part", ["diff", "sqp"])
def test_custom_cost_diff_cost_fn(custom_cost, part):
    import jax.numpy as jnp

    tw, res, base = custom_cost

    def diff_cost_fn(X, U, *args, **kw):  # the JAX script's cost
        return jnp.mean((X + 5.0) ** 2) + jnp.mean((U - 1.0) ** 2)

    f_j = pmpc_tpu.make_f_fx_fu_fn(jax_script("custom_cost").unicycle)
    ss = dict(base["solver_settings"], **({"solver": "SQP"} if part == "sqp" else {}))
    out_j = pmpc_tpu.solve(f_j, diff_cost_fn=diff_cost_fn, **dict(base, solver_settings=ss))
    held(res[part], out_j, tol=5e-3 if part == "diff" else TOL)
    assert np.abs(res[part]["U"]).max() <= 1.0


def test_receding_horizon_fused_matches_jax():
    from pmpc_tpu_torch.examples import receding_horizon as tw

    _, errs_j, iters_j = jax_script("receding_horizon").closed_loop_fused(8, 4, 4, 2,
                                                                          quiet=True)
    ms, errs, iters = tw.closed_loop_fused(8, 4, 4, 2, quiet=True, device="cpu")
    assert iters == iters_j
    np.testing.assert_allclose(errs, errs_j, rtol=0, atol=1e-4)
    assert np.isfinite(ms).all() and len(ms) == 4


def test_receding_horizon_host_matches_jax():
    from pmpc_tpu_torch.examples import receding_horizon as tw

    _, errs_j = jax_script("receding_horizon").closed_loop_host(8, 4, 4, 2)
    _, errs = tw.closed_loop_host(8, 4, 4, 2, device="cpu", dtype=F64)
    np.testing.assert_allclose(errs, errs_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_receding_horizon_state_keeps_device_and_dtype(monkeypatch, dtype):
    """The warm IPM state of one control step, handed to the next call, is
    on the solver's device in the loop's dtype; the loop's main() returns
    what it printed."""
    from pmpc_tpu_torch.examples import receding_horizon as tw
    from pmpc_tpu_torch import torch_scp

    seen = []
    build = torch_scp.build_scp_solver

    def spy(*a, **k):
        solver = build(*a, **k)

        def call(data, state=None):
            if state is not None:
                seen.extend((t.device.type, t.dtype) for t in state if t is not None)
            return solver(data, state)

        return call

    monkeypatch.setattr(tw, "build_scp_solver", spy)
    res = tw.main(device="cpu", dtype=dtype, run_host=False)
    assert seen and set(seen) == {("cpu", dtype)}
    assert len(res["iters"]) == 4 and set(res["fused"]) >= {"cold_ms", "err_final"}


@pytest.mark.parametrize("part", ["thrust_cone", "extra_cstrs", "extra_cstrs_composed"])
def test_arbitrary_constraints_matches_jax(part):
    """Both parts reach the port's condensed cone route (the 8-tuple's
    stage cones are detected), which follows the JAX package's `69d522d`, not
    its red HEAD (ROADMAP §3 F5, R1): the twin's solves are held against the
    JAX package's Riccati core (``method="riccati"``), the policy for every
    condensed-cone comparison. The composed program (``extras_structured=
    False``) is held in both packages."""
    from pmpc_tpu_torch.examples import arbitrary_constraints as tw

    f_j = pmpc_tpu.make_f_fx_fu_fn(jax_script("arbitrary_constraints").unicycle)
    riccati = lambda kw: dict(kw, solver_settings=dict(kw["solver_settings"], method="riccati"))
    if part == "thrust_cone":
        res = tw.demo_thrust_cone_fast_path(device="cpu", dtype=F64)
        held(res, pmpc_tpu.solve(f_j, **riccati(tw.thrust_cone_problem(F64))))
        assert res["norm_max"] <= 0.7 + 1e-6
    elif part == "extra_cstrs":
        res = tw.demo_extra_cstrs(device="cpu", dtype=F64)
        held(res, pmpc_tpu.solve(f_j, **riccati(tw.extra_cstrs_problem(F64))))
        assert res["u0_sum"] <= tw.BUDGET + 1e-4 and res["norm_max"] <= tw.UMAX + 1e-4
    else:
        from pmpc_tpu_torch import make_f_fx_fu_fn, solve
        from pmpc_tpu_torch.examples._common import unicycle

        kw = tw.extra_cstrs_problem(F64)
        kw["solver_settings"] = dict(kw["solver_settings"], extras_structured=False)
        _, U, d = solve(make_f_fx_fu_fn(unicycle, device="cpu"), device="cpu", **kw)
        held(dict(U=U, iters=len(d["hist"])), pmpc_tpu.solve(f_j, **kw))
        assert U[0, 0] + U[0, 1] <= tw.BUDGET + 1e-4
        assert np.linalg.norm(U, axis=-1).max() <= tw.UMAX + 1e-4
