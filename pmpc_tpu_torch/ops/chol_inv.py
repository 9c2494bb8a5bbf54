"""Batched inverse Cholesky factor ``Minv = L^{-1}`` of small SPD blocks.

Replaces the TPU kernels of ``pmpc_tpu/ops/pallas_chol.py``:
- K1 ``_chol_inv_kernel_small_diag`` (``inv_cholesky_diag``): the IPM's
  per-particle Newton blocks ``Hff + diag(w)``; flagship (2048, 50, 50) f32,
  once per IPM iteration;
- K2 ``_chol_inv_kernel_small`` (``inv_cholesky``): the consensus Schur
  complement (64, 10, 10) and the cold-start factors.

Both are one CUDA kernel, ``csrc/chol_inv.cu``, templated on the dtype (f32,
f64) and on whether a diagonal is added. What bounds it on the H100 is
latency, not bandwidth: K1 at the flagship reads 2048*50*50*4 B ~ 20 MB a
call (~6 us at the H100 SXM's 3.35 TB/s peak), while each matrix is a chain
of ~2n dependent
column steps. The design keeps that chain in shared memory: one CTA (128
threads) per matrix, the block loaded once with a padded row stride (at most
64*65*8 B + 1 KB per CTA, so many CTAs share an SM and hide each other's
barrier waits), factor and substitution in place, one coalesced write.

On a CPU tensor each entry point runs its plain PyTorch version
(``cholesky_ex`` + ``solve_triangular``, NaN where the factor fails); on a
CUDA tensor it launches the kernel or raises. The kernel is built with
``nvcc`` at first use from ``csrc/`` into ``_build/<source hash>/`` and bound
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

MAX_N = 64  # the kernel's limit; larger blocks are ROADMAP K3/K4

# launches of each CUDA entry point (plain CPU calls are not counted)
LAUNCHES = {"inv_cholesky": 0, "inv_cholesky_diag": 0}

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "chol_inv.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the chol_inv "
                           "kernel cannot be built")
    return found


def build() -> Path:
    """Compile ``csrc/chol_inv.cu`` (once per source hash) and return the
    shared library's path."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _PKG / "_build" / key
    lib = out_dir / "libchol_inv.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("pmpc_chol_inv_f32", "pmpc_chol_inv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(A: torch.Tensor, w, jitter: float) -> torch.Tensor:
    if A.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"chol_inv kernel takes float32/float64, got {A.dtype} "
            "(other dtypes: ROADMAP K3/K4)")
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected (batch, n, n), got {tuple(A.shape)}")
    B, n = A.shape[0], A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise NotImplementedError(
            f"chol_inv kernel takes 1 <= n <= {MAX_N}, got n={n} "
            "(larger blocks: ROADMAP K3/K4)")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if w is not None:
        if w.shape != (B, n) or w.dtype != A.dtype or w.device != A.device:
            raise ValueError(f"w must be ({B}, {n}) {A.dtype} on {A.device}")
        if not w.is_contiguous():
            raise ValueError("w must be contiguous")
    out = torch.empty_like(A)
    fn = _lib().pmpc_chol_inv_f32 if A.dtype == torch.float32 \
        else _lib().pmpc_chol_inv_f64
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), None if w is None else w.data_ptr(),
                 float(jitter), out.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: cudaError {err}")
    return out


def _on_cuda(A: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if A.device.type == "cuda":
        return True
    if A.device.type == "cpu":
        return False
    raise NotImplementedError(f"no chol_inv path for device {A.device}")


def inv_cholesky(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Minv = L^{-1}, L L' = A + jitter I, for A (batch, n, n)."""
    if not _on_cuda(A):
        return inv_cholesky_plain(A, jitter)
    out = _launch(A, None, jitter)
    LAUNCHES["inv_cholesky"] += 1
    return out


def inv_cholesky_diag(A: torch.Tensor, w: torch.Tensor,
                      jitter: float = 0.0) -> torch.Tensor:
    """Minv = L^{-1}, L L' = A + diag(w) + jitter I, for A (batch, n, n),
    w (batch, n)."""
    if not _on_cuda(A):
        return inv_cholesky_diag_plain(A, w, jitter)
    out = _launch(A, w, jitter)
    LAUNCHES["inv_cholesky_diag"] += 1
    return out


def inv_cholesky_plain(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same result, NaN blocks
    where the factor fails."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A + jitter * eye)
    Minv = torch.linalg.solve_triangular(
        L, eye.expand(A.shape).contiguous(), upper=False)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(Minv, float("nan")), Minv)


def inv_cholesky_diag_plain(A: torch.Tensor, w: torch.Tensor,
                            jitter: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the diagonal-adding kernel."""
    return inv_cholesky_plain(A + torch.diag_embed(w + jitter), 0.0)
