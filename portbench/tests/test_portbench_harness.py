"""The harness finds what BENCHMARK.json names, its generators repeat with
the seed, its import guard compares whole top-level names and holds back a
result where the process loaded JAX, its result line has the contract's
keys, its K1 reader reads only K1's launches, and it refuses to run without
a card."""

import argparse
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import find, harness, kernels, program
from portbench.tests._tiny import run_tiny, tiny_cell

SPEC = find.bench()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = find.cell(name, SPEC)
    gen = find.module("generators", cell["traffic"]["generator"])
    assert all(hasattr(gen, f) for f in ("setup", "window", "answers"))
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(find.module("metrics", m["name"]).read)
    assert set(cell["check"]["limits"]) == {"failed", "u_err"}
    assert cell["check"]["sample"] >= 1
    cfg = cell["config"]
    find.module("dynamics", cfg["dynamics"])
    for key in ("M", "N", "Nc", "xdim", "udim", "q", "r", "u_lo", "u_hi", "box_tol", "dtype"):
        assert key in cfg


def test_every_file_is_named_by_the_spec():
    named = {c["file"] for c in SPEC["configs"]}
    assert named == {f"portbench/configs/{p.name}" for p in (find.ROOT / "configs").glob("*.json")}
    assert {w["traffic"] for w in SPEC["workloads"]} == \
        {p.stem for p in (find.ROOT / "traffic").glob("*.json")}
    assert set(CELLS) == {p.stem for p in (find.ROOT / "checks").glob("*.json")}
    metrics = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert metrics == {p.stem for p in (find.ROOT / "metrics").glob("*.py")}


def test_cold_batch_repeats_with_the_seed():
    cell = find.cell("m32n30.b64", SPEC)
    gen = find.module("generators", "cold_batch").x0_batch
    cfg, mix = cell["config"], cell["traffic"]
    seed = 2**31 + 123  # seeds may pass 32 signed bits
    a, b = gen(cfg, mix, seed, 3), gen(cfg, mix, seed, 3)
    assert a.shape == (mix["B"], cfg["M"], cfg["xdim"]) and np.array_equal(a, b)
    assert not np.array_equal(a, gen(cfg, mix, seed + 1, 3))
    assert not np.array_equal(a, gen(cfg, mix, seed, 4))


def test_forbidden_modules_compare_whole_names():
    names = ["pmpc_tpu_torch", "pmpc_tpu_torch.ops.chol_inv", "jaxtyping", "jax.numpy", "jax",
             "pmpc_tpu", "pmpc_tpu.solvers", "flax.linen", "jaxlib", "numpy", "portbench"]
    assert harness.forbidden_modules(names) == \
        ["flax.linen", "jax", "jax.numpy", "jaxlib", "pmpc_tpu", "pmpc_tpu.solvers"]


JAX_READER = """import jax  # a reader that loads JAX, after the window has closed


def read(rec):
    return 1.0
"""


@pytest.mark.parametrize("loads_jax", [False, True], ids=["clean", "reader_loads_jax"])
def test_a_run_that_loaded_jax_prints_no_result(loads_jax, tmp_path, monkeypatch, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")  # a stub named jax
    (tmp_path / "solves_per_s.py").write_text(JAX_READER)
    monkeypatch.syspath_prepend(str(tmp_path))
    module, small = find.module, tiny_cell("m32n30.b64")

    def reader(kind, name):
        if loads_jax and (kind, name) == ("metrics", "solves_per_s"):
            return find.load(tmp_path / f"{name}.py", "stub_reader")
        return module(kind, name)

    monkeypatch.setattr(find, "module", reader)
    monkeypatch.setattr(find, "cell", lambda name: small)
    args = argparse.Namespace(workload="m32n30.b64", seed=2**31 + 5, seconds=0.3, trace=0)
    try:
        code = harness.main(args, 0.0, device=torch.device("cpu"))
    finally:
        held = sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    if loads_jax:
        assert held is not None and code == 3 and out == ""
        assert "['jax']" in err.splitlines()[-1]
    else:
        assert held is None and code == 0
        assert json.loads(out.splitlines()[-1])["correct"] is True


K1_NAME = "void (anonymous namespace)::chol_inv_kernel<float, true, {}, 8>(float const*, int)"


@pytest.mark.parametrize("threads", [32, 128])
def test_k1_roofline_reads_k1_by_its_identity(threads):
    read = find.module("metrics", "k1_roofline_pct.batch").read
    peak = kernels.peaks("NVIDIA H100 80GB HBM3")
    bound_ns = kernels.chol_inv_bound_s(2048, 50, torch.float32, peak) * 1e9
    k1 = (K1_NAME.format(threads), 0, 4 * bound_ns)  # a quarter of its roofline
    other = (K1_NAME.format(threads).replace("true", "false"), 0, 1e6)
    rec = dict(launches={"inv_cholesky_diag": 3},
               shapes={("inv_cholesky_diag", 2048, 50, torch.float32): 3}, peaks=peak,
               trace=dict(events=[k1, other, k1, k1, ("elementwise_kernel<128, 4>", 0, 5e5)]))
    assert read(rec) == pytest.approx(25.0)
    rec["launches"]["inv_cholesky_diag"] = 4  # the trace and the counter disagree
    assert read(rec) is None


def test_chol_inv_bytes_and_bound():
    assert kernels.chol_inv_bytes(2048, 50, 4) == 2048 * (1275 + 50 + 2500) * 4
    assert kernels.chol_inv_bytes(1000, 40, 8) == 1000 * (820 + 40 + 1600) * 8
    peak = kernels.peaks("NVIDIA H100 80GB HBM3")
    t = kernels.chol_inv_bound_s(2048, 50, torch.float32, peak)
    assert t == pytest.approx(31334400 / 3.35e12)  # bytes bound it
    assert kernels.peaks("cpu") is None


def test_result_line_has_the_contract_keys():
    res, numbers, _ = run_tiny("m32n30.b64")
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared" and set(line["compared"]) == set(numbers)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    units = {m["name"]: m["unit"] for m in find.bench()["end_to_end"]}
    assert set(line["metrics"]) == {"solves_per_s", "setup_s"}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(find.ROOT / "run.py"), "--workload", "m32n30.b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    for path in (find.ROOT / "reference").glob("*.py"):
        assert {n.split(".")[0] for n in _imports(path)} <= {"__future__", "typing", "torch"}, path
    for path in find.ROOT.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "pmpc_tpu"}, path


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_benchmark_json_keeps_the_contract():
    b = find.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    cells = {w["name"]: w for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.fullmatch(c["name"])
        assert c["file"].startswith("portbench/") and any(w["config"] == c["name"]
                                                          for w in cells.values())
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in b["end_to_end"]}["setup_s"] == 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for name in cells:
        cell = find.cell(name)
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    # a full check of 24 cells fits in its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
