"""The example scripts of the port (`pmpc_tpu_torch.examples`) against the
JAX package's ``examples/*.py``, on the CPU at the smoke sizes
(``PMPC_EXAMPLES_FAST=1``).

Each twin's solves are held against the same calls made through
`pmpc_tpu` with the JAX script's own dynamics (its ``unicycle``): the twin
builds the arguments in numpy, the test hands them to both packages. The
host `solve` calls in f64: U to 1e-6 with equal SCP iteration counts. This
file: `simple_demo` (its three parts, and one subprocess that runs the
module and asserts that jax was never imported) and `batch_solver` (the
stacked list, the fused batch against ``jax.vmap`` of the JAX fused solver,
and the host check of problem 0). tests/test_torch_examples2.py has the
other three."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pmpc_tpu

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F64 = np.float64
TOL = 1e-6


@pytest.fixture(autouse=True)
def fast(monkeypatch):
    monkeypatch.setenv("PMPC_EXAMPLES_FAST", "1")


def jax_script(name):
    """The JAX package's example script ``examples/<name>.py`` as a module
    (its FAST switch set: the env is read at import)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.FAST = True
    return mod


def held(res, out_j, tol=TOL):
    """A twin's host solve (its returned U and SCP iterations) against the
    JAX solve's (X, U, data): U to ``tol``, equal iteration counts."""
    _, Uj, dj = out_j
    np.testing.assert_allclose(res["U"], Uj, rtol=0, atol=tol)
    assert res["iters"] == len(dj["hist"])


def test_simple_demo_linear_system():
    from pmpc_tpu_torch.examples import simple_demo as tw

    res = tw.demo_linear_system(device="cpu", dtype=F64)
    p = dict(tw.linear_system_problem(F64), verbose=False)
    X, U, d = pmpc_tpu.solve(**p)
    held(res, (X, U, d))
    assert res["resid"] == pytest.approx(d["hist"][-1]["resid"], rel=1e-6, abs=1e-12)
    assert res["xN"] < res["x0"]


def test_simple_demo_car_tracking():
    from pmpc_tpu_torch.examples import simple_demo as tw

    res = tw.demo_car_tracking(device="cpu", dtype=F64)
    kw = tw.car_tracking_problem(F64)
    out_j = pmpc_tpu.solve(pmpc_tpu.make_f_fx_fu_fn(jax_script("simple_demo").unicycle),
                           **kw)
    held(res, out_j)
    assert -1 - 1e-6 <= res["u_min"] and res["u_max"] <= 1 + 1e-6


def test_simple_demo_consensus():
    from pmpc_tpu_torch.examples import simple_demo as tw

    res = tw.demo_contingency_consensus(device="cpu", dtype=F64)
    held(res, pmpc_tpu.solve(**tw.consensus_problem(F64)))
    assert res["spread_cons"] < 1e-5 < res["spread_free"]


def test_simple_demo_module_runs_without_jax(tmp_path):
    """``python3 -m pmpc_tpu_torch.examples.simple_demo --device cpu --out
    DIR``, as ``-m`` runs it (runpy, run_name "__main__"): it prints what the
    JAX script prints, never imports jax, and its plots land in DIR alone."""
    code = ("import runpy, sys\n"
            "sys.argv = ['simple_demo', '--device', 'cpu', '--out', sys.argv[1]]\n"
            "runpy.run_module('pmpc_tpu_torch.examples.simple_demo', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'pmpc_tpu' or m.startswith('pmpc_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PMPC_EXAMPLES_FAST="1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "plots")], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for line in ("== 1. random linear system (Problem struct) ==",
                 "== 3. contingency MPC: M=2 particles, one loses actuation at t=10 ==", "done"):
        assert line in r.stdout
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert sorted(p.name for p in (tmp_path / "plots").iterdir()) == [
        "car_tracking.png", "contingency_consensus.png", "linear_system.png"]


def test_batch_solver_matches_jax():
    """The twin's main in f64: the stacked list of problems against the JAX
    `solve_problems`, the fused batch against ``jax.vmap`` of the JAX fused
    solver (1e-6, equal SCP iteration counts), and the host check of problem
    0 against the JAX `solve`."""
    import jax
    import jax.numpy as jnp

    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
    from pmpc_tpu_torch.examples import batch_solver as tw

    res = tw.main(device="cpu", dtype=F64)
    s = tw.sizes()
    B, N, xdim, udim = s["B"], s["N"], 4, 2
    f_j = pmpc_tpu.make_f_fx_fu_fn(jax_script("batch_solver").unicycle)
    problems, rng = tw.list_problems(f_j, F64)
    rets = pmpc_tpu.solve_problems(problems, verbose=False)
    np.testing.assert_allclose(res["U_list"], np.stack([r[1] for r in rets]), rtol=0,
                               atol=TOL)
    x0 = np.ones((B, 1, xdim)) + 0.1 * rng.normal(size=(B, 1, xdim))
    solver = build_scp_solver(jax_script("batch_solver").unicycle, N=N, xdim=xdim, udim=udim,
                              M=1, Nc=0, max_it=s["max_it"], res_tol=1e-5, has_u_bounds=True,
                              jit=False)
    one = make_scp_data(np.ones((1, xdim)), np.tile(np.eye(xdim), (1, N, 1, 1)),
                        np.tile(1e-2 * np.eye(udim), (1, N, 1, 1)), reg_x=1.0, reg_u=0.1,
                        u_l=-np.ones((1, N, udim)), u_u=np.ones((1, N, udim)))
    data = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), one)
    _, Uj, info = jax.jit(jax.vmap(solver))(data._replace(x0=jnp.asarray(x0)))
    np.testing.assert_allclose(res["U_fused"], np.asarray(Uj)[:, 0], rtol=0, atol=TOL)
    np.testing.assert_array_equal(res["iters_fused"], np.asarray(info["iters"]))
    assert res["converged"] == float(np.mean(np.asarray(info["converged"])))
    held(res["host"], pmpc_tpu.solve(f_j, **tw.host_problem(x0[0, 0], F64)))
    assert res["list_dU"] < 1e-6 and np.isfinite(res["fused_ms"])
