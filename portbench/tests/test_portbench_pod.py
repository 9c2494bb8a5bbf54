"""The pod-scale cell ``m64n50.b256`` (config 5: M = 64, N = 50, f64, K3):
its three readers on synthetic records, K3's bytes and bound at the cell's
shape, its tiny run on the CPU, and, on the card, its control."""

import time

import pytest
import torch

from portbench import control, find, harness, kernels
from portbench.tests._tiny import run_tiny, tiny_cell

CELL = "m64n50.b256"
PEAK = kernels.peaks("NVIDIA H100 80GB HBM3")
KERNEL = "void (anonymous namespace)::chol_inv_kernel<{}, {}, {}, 8>({} const*, int)"
K3 = KERNEL.format("double", "true", 64, "double")
K1 = KERNEL.format("float", "true", 32, "float")
K4 = KERNEL.format("double", "false", 64, "double")
K3_SHAPE = ("inv_cholesky_diag_big", 16384, 90, torch.float64)


def read(name, rec):
    return find.module("metrics", name).read(rec)


def test_k3_bytes_and_bound_at_the_cells_shape():
    assert kernels.chol_inv_bytes(16384, 90, 8) == 16384 * (4095 + 90 + 8100) * 8
    t = kernels.chol_inv_bound_s(16384, 90, torch.float64, PEAK)
    assert t == pytest.approx(16384 * 12285 * 8 / 3.35e12)  # bytes bound it: ~0.48 ms
    assert t > kernels.chol_inv_flops(16384, 90) / PEAK["flops"][torch.float64]


def test_k3_roofline_reads_k3_by_its_identity():
    """K3 (``<double, true, 64, 8>``) is read; K1 (``<float, true, 32, 8>``)
    and K4 (no diagonal) are not; nothing is read where the trace and the
    counter disagree."""
    bound_ns = kernels.chol_inv_bound_s(16384, 90, torch.float64, PEAK) * 1e9
    k3 = (K3, 0, 5 * bound_ns)  # a fifth of its roofline
    rec = dict(launches={"inv_cholesky_diag_big": 3, "inv_cholesky_diag": 1},
               shapes={K3_SHAPE: 3, ("inv_cholesky_diag", 2048, 50, torch.float32): 1},
               peaks=PEAK,
               trace=dict(events=[k3, (K1, 0, 1e6), k3, (K4, 0, 1e6), k3,
                                  ("elementwise_kernel<128, 4>", 0, 5e5)]))
    assert read("k3_roofline_pct.pod", rec) == pytest.approx(20.0)
    rec["launches"]["inv_cholesky_diag_big"] = 4
    assert read("k3_roofline_pct.pod", rec) is None
    rec["launches"]["inv_cholesky_diag_big"] = 3
    assert read("k3_roofline_pct.pod", dict(rec, trace=None)) is None
    assert read("k3_roofline_pct.pod", dict(rec, peaks=None)) is None


def test_ipm_iters_and_kernels_per_ipm_iter_read_k3():
    """Three calls, 24 K3 launches (IPM iterations), 300 kernels an
    iteration and copies that are not kernels; K1 launches are not read."""
    events = [("chol_inv_kernel<double, true, 64, 8>", 0, 1)] * 24 \
        + [("gemvx::kernel", 0, 1)] * (24 * 299) + [("Memcpy DtoD (Device -> Device)", 0, 1)] * 7
    rec = dict(launches={"inv_cholesky_diag_big": 24, "inv_cholesky_diag": 5},
               solves=[dict(n=256, converged=256, iters=[])] * 3, trace=dict(events=events))
    assert read("ipm_iters.pod", rec) == 8.0
    assert read("kernels_per_ipm_iter.pod", rec) == 300.0
    assert read("kernels_per_ipm_iter.pod", dict(rec, trace=None)) is None
    rec["launches"] = {"inv_cholesky_diag": 5}  # the headline cells: no K3
    assert read("ipm_iters.pod", rec) is None
    assert read("kernels_per_ipm_iter.pod", rec) is None


def test_pod_tiny_run_is_correct():
    res, numbers, _ = run_tiny(CELL)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0, numbers
