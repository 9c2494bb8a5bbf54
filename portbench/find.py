"""Everything the harness runs is found by name: a cell's configuration,
traffic mix, check and metrics in ``BENCHMARK.json``, their files and
readers under this folder. A new cell, mix or metric is a new file here and
a new entry there, and no edit of the harness."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def data(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under this folder."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under this folder, loaded as a module (a metric's
    name may hold dots, so it is loaded from its path)."""
    return load(ROOT / kind / f"{name}.py", f"portbench_{kind}.{name}")


def load(path: Path, name: str):
    """The Python file ``path`` loaded as the module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, spec: dict = None) -> dict:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` when None) with what
    it names resolved: its configuration, traffic mix, check, and the
    end-to-end and per-layer metrics it reports."""
    spec = bench() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((REPO / cfg_entry["file"]).read_text())
    applies = lambda m: name in m.get("workloads", cells)
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m) and m["moves"] in moved]
    return dict(workload=w, config=cfg, traffic=data("traffic", w["traffic"]),
                check=data("checks", name), end_to_end=e2e, per_layer=layer)
