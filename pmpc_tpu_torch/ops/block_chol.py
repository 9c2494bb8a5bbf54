"""The inverse Cholesky factor ``Minv = L^{-1}`` outside any hand-written
kernel, and the solves against it.

Twin of ``pmpc_tpu/ops/block_chol.py``. There `inv_cholesky` is a blocked
factorization out of batched GEMMs, written because XLA's own Cholesky is
slow on the TPU; it runs outside any Pallas kernel and takes the blocks the
kernels do not (n > 96). Here the same function is the library's
``cholesky_ex`` + ``solve_triangular``. `inv_chol_apply` is two batched
matmuls, left to cuBLAS as the JAX package left them to XLA.
"""

from __future__ import annotations

import torch


def inv_cholesky(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Minv = L^{-1}, L L' = A + jitter I, for A (..., n, n) of any n; a
    block whose factor fails (a non-positive pivot, or a NaN, which the
    library reports on the CPU and only passes on on the card) is all NaN."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A + jitter * eye)
    Minv = torch.linalg.solve_triangular(
        L, eye.expand(A.shape).contiguous(), upper=False)
    failed = (info > 0) | torch.isnan(Minv).any(-1).any(-1)
    return torch.where(failed[..., None, None],
                       torch.full_like(Minv, float("nan")), Minv)


def inv_chol_apply(Minv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^{-1} b = Minv' (Minv b); b (..., n) or (..., n, k)."""
    vector = b.ndim == Minv.ndim - 1
    if vector:
        b = b[..., None]
    x = Minv.mT @ (Minv @ b)
    return x[..., 0] if vector else x
