"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds."""

import time

import torch

from portbench import find, harness


def tiny_cell(name, M=4, N=10, Nc=2, B=4, sample=3, spec=None):
    """The cell of ``spec`` (BENCHMARK.json when None) with at most M
    particles, N stages, Nc shared controls, B scenarios a call and
    ``sample`` solves checked by the reference."""
    cell = find.cell(name, spec)
    cfg = cell["config"]
    cfg.update(M=min(cfg["M"], M), N=min(cfg["N"], N), Nc=min(cfg["Nc"], Nc))
    if "B" in cell["traffic"]:
        cell["traffic"]["B"] = min(cell["traffic"]["B"], B)
    cell["check"]["sample"] = sample
    return cell


def run_tiny(name, build=None, seconds=0.5, seed=2**31 + 7, sample=1000, spec=None, **size):
    """Run the cut cell once on the CPU; the check draws up to ``sample``
    solves (all of them at the default)."""
    torch.set_num_threads(2)
    kw = {} if build is None else dict(build=build)
    return harness.execute(tiny_cell(name, sample=sample, spec=spec, **size), seed, seconds, 0,
                           time.perf_counter(), torch.device("cpu"), **kw)
