"""Operations and bytes of the program's hand kernels, and the chip's
published peaks: the yardstick of a kernel's roofline share.

``chol_inv``: one batched inverse Cholesky factor Minv = L^-1 of SPD blocks
(n x n), optionally with a diagonal added (``ops/chol_inv.py``). Its least
traffic is the lower triangle of A and the diagonal w read once and the full
block written once, batch (n(n+1)/2 + n + n^2) itemsize bytes; its work is
the factor and the triangular inverse, 2 n^3 / 3 flops a block.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W; FP32
# and FP64 outside the tensor cores (the kernel uses neither's tensor path)
PEAKS = {"H100": dict(bytes_per_s=3.35e12, flops={torch.float32: 67e12, torch.float64: 34e12})}


def peaks(device_name: str):
    """The published peaks of the card named ``device_name``, or None."""
    return next((v for k, v in PEAKS.items() if k in device_name), None)


def chol_inv_bytes(batch: int, n: int, itemsize: int) -> int:
    return batch * (n * (n + 1) // 2 + n + n * n) * itemsize


def chol_inv_flops(batch: int, n: int) -> float:
    return batch * 2.0 * n ** 3 / 3.0


def chol_inv_bound_s(batch: int, n: int, dtype, peak) -> float:
    """The least time of one launch: the larger of its bytes at the memory
    bandwidth and its flops at the dtype's peak."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(chol_inv_bytes(batch, n, itemsize) / peak["bytes_per_s"],
               chol_inv_flops(batch, n) / peak["flops"][dtype])
