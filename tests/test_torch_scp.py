"""The ported SCP main path as a whole (`pmpc_tpu_torch.torch_scp`).

(a)/(b) the accuracy-probe config (benchmarks/accuracy_probe.py) against the
JAX package's f64 answer, benchmarks/accuracy_ref_u64.npy: measured on the
CPU at 1.4e-12 in f64 and 5.6e-4 in f32;
(c) a batched Anderson-accelerated run against `jax.vmap` of the JAX solver;
(d) the port imports no JAX.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import bench
from __graft_entry__ import _flagship
from pmpc_tpu_torch import torch_scp
from pmpc_tpu_torch.convert import scp_data_from_numpy
from pmpc_tpu_torch.flagship import dubins, flagship, probe, stack_varied

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF_U64 = np.load(ROOT / "benchmarks" / "accuracy_ref_u64.npy")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-7), (torch.float32, 1e-3)])
def test_accuracy_probe_matches_jax_f64_reference(dtype, tol):
    solver, data = probe(dtype)
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
    t_solver, t_one = flagship(dtype=torch.float64, **kw)
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
    _, data = flagship(M=2, N=6, Nc=1, dtype=torch.float64)
    data = stack_varied(data, 2)
    _, U1, info1 = solver(data)
    uc, uf, s, lam = info1["solver_state"]
    assert uc.shape == (2, 2) and uf.shape == (2, 2, 10) and s.shape == lam.shape
    _, U2, info2 = solver(data, info1["solver_state"])
    assert torch.isfinite(U2).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver.init_carry(data)
    for kw in (dict(method="riccati"), dict(has_x_bounds=True),
               dict(has_u_soc=True), dict(relin_stale=1),
               dict(lin_cost_fn=lambda *a: (None, None)), dict(has_u_bounds=False),
               dict(ipm_gondzio=1), dict(ipm_predictor=False), dict(mu_target=0.1)):
        args = dict(N=6, xdim=4, udim=2, M=2, has_u_bounds=True)
        args.update(kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_scp.build_scp_solver(dubins, **args)


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


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "pmpc_tpu_torch.flagship" in names
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "pmpc_tpu", "bench", "__graft_entry__"}
