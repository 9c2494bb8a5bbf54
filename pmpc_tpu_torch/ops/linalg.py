"""Batched SPD factor/solve for the solver core.

Twin of ``pmpc_tpu/ops/linalg.py:142-191``. The factor is always the inverse
Cholesky factor ``Minv = L^{-1}`` and every solve is two batched matmuls
(`block_chol.inv_chol_apply`). The device decides the route
(`chol_inv`): a CUDA tensor goes to the hand-written kernel (n <= 96, f32
or f64), which raises ``NotImplementedError`` for what it does not take
(n > 96: ROADMAP §2, the twin of ``block_chol.inv_cholesky``; other dtypes);
a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from .block_chol import inv_chol_apply
from .chol_inv import inv_cholesky, inv_cholesky_diag


def spd_factor(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Factor a (batched) SPD matrix (..., n, n) for `spd_apply`."""
    n = A.shape[-1]
    Minv = inv_cholesky(A.reshape(-1, n, n).contiguous(), jitter)
    return Minv.reshape(A.shape)


def spd_factor_diag(A: torch.Tensor, w: torch.Tensor,
                    jitter: float = 0.0) -> torch.Tensor:
    """Factor (A + diag(w)) for `spd_apply`; the diagonal is added inside the
    kernel, so a loop-invariant A is never copied per call."""
    n = A.shape[-1]
    Minv = inv_cholesky_diag(A.reshape(-1, n, n).contiguous(),
                             w.reshape(-1, n).contiguous(), jitter)
    return Minv.reshape(A.shape)


def spd_apply(F: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given F = spd_factor(A)."""
    return inv_chol_apply(F, b)
