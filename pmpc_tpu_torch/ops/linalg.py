"""Batched SPD factor/solve for the solver core.

Twin of ``pmpc_tpu/ops/linalg.py:142-191``. The factor is always the inverse
Cholesky factor ``Minv = L^{-1}`` and every solve is two batched matmuls
(`block_chol.inv_chol_apply`). The block size alone decides the route, as
in the JAX package (``linalg.py:153-154``): n <= 96 goes to `chol_inv` (on a
CUDA tensor the hand-written kernel, f32 or f64, which raises
``NotImplementedError`` for other dtypes; on a CPU tensor its plain version),
larger blocks to `block_chol.inv_cholesky`, which is outside any kernel in
both packages.

`cholesky_factor` / `cholesky_solve` / `psd_solve` are the twins of
``pmpc_tpu/ops/linalg.py:194-216``: the plain Cholesky factor L and the
two triangular solves against it, for the small stage blocks of the Riccati
sweeps. They run outside any kernel in both packages, so they are the
library's calls here.
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


def cholesky_factor(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Cholesky factor L of a (batched) SPD matrix, with optional diagonal
    jitter. A block that is not SPD (or holds a NaN, which the library
    reports on the CPU and only passes on on the card) is all NaN, as
    ``jnp.linalg.cholesky`` gives it: never an exception."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A)
    failed = (info > 0) | torch.isnan(L).flatten(-2).any(-1)
    return torch.where(failed[..., None, None], torch.nan, L)


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given the (batched) Cholesky factor ``L`` of ``A``;
    ``b`` a vector (..., n) or a matrix (..., n, k)."""
    vector = b.ndim == L.ndim - 1
    if vector:
        b = b[..., None]
    x = torch.cholesky_solve(b, L)
    return x[..., 0] if vector else x


def psd_solve(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve a (batched) SPD system via Cholesky."""
    return cholesky_solve(cholesky_factor(A, jitter=jitter), b)
