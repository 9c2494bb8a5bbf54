"""The control (the reference in float32 with TF32 matmuls in the program's
place) comes out not correct. TF32 exists only on the card: this test runs
there (``-m cuda``) and skips elsewhere."""

import time

import pytest
import torch

from portbench import control, harness
from portbench.tests._tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m32n30.b64", "m32n30.b1024"])
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("TF32, the control's precision, exists only on a CUDA device")
    cell = tiny_cell(name, M=32, N=30, Nc=5, B=16, sample=16)  # the widths, a small batch
    res, numbers, _ = harness.execute(cell, 2**31 + 11, 1.0, 0, time.perf_counter(),
                                      torch.device("cuda", 0), build=control.build)
    assert res["correct"] is False, numbers
