"""Batched SPD factor/solve for the solver core.

Twin of ``pmpc_tpu/ops/linalg.py:142-191``. The factor is always the inverse
Cholesky factor ``Minv = L^{-1}`` and every solve is two batched matmuls
(`block_chol.inv_chol_apply`). The block size alone decides the route, as
in the JAX package (``linalg.py:153-154``): n <= 96 goes to `chol_inv` (on a
CUDA tensor the hand-written kernel, f32 or f64, which raises
``NotImplementedError`` for other dtypes; on a CPU tensor its plain version),
larger blocks to `block_chol.inv_cholesky`, which is outside any kernel in
both packages.
"""

from __future__ import annotations

import torch

from . import block_chol
from .block_chol import inv_chol_apply
from .chol_inv import MAX_N, inv_cholesky, inv_cholesky_diag


def spd_factor(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Factor a (batched) SPD matrix (..., n, n) for `spd_apply`."""
    n = A.shape[-1]
    if n > MAX_N:
        return block_chol.inv_cholesky(A, jitter)
    Minv = inv_cholesky(A.reshape(-1, n, n).contiguous(), jitter)
    return Minv.reshape(A.shape)


def spd_factor_diag(A: torch.Tensor, w: torch.Tensor,
                    jitter: float = 0.0) -> torch.Tensor:
    """Factor (A + diag(w)) for `spd_apply`; the diagonal is added inside the
    kernel, so a loop-invariant A is never copied per call."""
    n = A.shape[-1]
    if n > MAX_N:
        return block_chol.inv_cholesky(A + torch.diag_embed(w + jitter))
    Minv = inv_cholesky_diag(A.reshape(-1, n, n).contiguous(),
                             w.reshape(-1, n).contiguous(), jitter)
    return Minv.reshape(A.shape)


def spd_apply(F: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given F = spd_factor(A)."""
    return inv_chol_apply(F, b)
