"""Solves against the inverse Cholesky factor ``Minv = L^{-1}``.

Twin of ``pmpc_tpu/ops/block_chol.py:126-133``: two batched matmuls, left to
cuBLAS as the JAX package left them to XLA.
"""

from __future__ import annotations

import torch


def inv_chol_apply(Minv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^{-1} b = Minv' (Minv b); b (..., n) or (..., n, k)."""
    vector = b.ndim == Minv.ndim - 1
    if vector:
        b = b[..., None]
    x = Minv.mT @ (Minv @ b)
    return x[..., 0] if vector else x
