"""Batched inverse Cholesky factor ``Minv = L^{-1}`` of small SPD blocks.

Replaces the four TPU kernels of ``pmpc_tpu/ops/pallas_chol.py``:
- K1 ``_chol_inv_kernel_small_diag`` (``inv_cholesky_diag``, n <= 64): the
  IPM's per-particle Newton blocks ``Hff + diag(w)``; flagship (2048, 50, 50)
  f32, once per IPM iteration;
- K2 ``_chol_inv_kernel_small`` (``inv_cholesky``, n <= 64): the consensus
  Schur complement (64, 10, 10), the cold-start factors, the state-box
  Newton blocks;
- K3 ``_chol_inv_kernel_big_diag`` (``inv_cholesky_diag``, 64 < n <= 96): the
  pod-scale shape's Newton blocks, (2048, 90, 90) f32 at B=32;
- K4 ``_chol_inv_kernel_big`` (``inv_cholesky``, 64 < n <= 96): the
  unbounded solve and the cold start at that shape.

All four are one CUDA kernel body, ``csrc/chol_inv.cu``, templated on the
dtype (f32, f64), on whether a diagonal is added and on the CTA's thread
count. The size route is static: `_route` picks the launch counter and the
thread count (`THREADS`) from n alone. The memory floor of a call is each
input read once and the output written once, 2*batch*n*n*4 B in f32: ~41 MB
at the flagship (~12 us at the H100 SXM's 3.35 TB/s peak), ~133 MB at
(2048, 90, 90) (~40 us). What it actually waits on is latency: each matrix is
a chain of ~2n dependent column steps with two barriers each. The design
keeps that chain in shared memory: one CTA per matrix, the block loaded once
with an odd row stride (at most 75 KB per CTA in f64 at n = 96, 37 KB in f32,
so several CTAs share an SM and hide each other's barrier waits), factor and
substitution in place, one coalesced write.

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

SMALL_N = 64  # K1/K2 up to here, K3/K4 ("_big") above
MAX_N = 96  # the kernel's limit (the TPU kernels' `_fits_big`)
# CTA size by route ("" = K1/K2, "_big" = K3/K4), each the faster of 128 and
# 256 at its route's main shape (PERF.md)
THREADS = {"": 128, "_big": 256}

# launches of each kernel (plain CPU calls are not counted)
LAUNCHES = {"inv_cholesky": 0, "inv_cholesky_diag": 0,
            "inv_cholesky_big": 0, "inv_cholesky_diag_big": 0}
# every (counter name, batch, n, dtype) launched since it was last cleared:
# what a card-side check has to hold against the plain versions
SHAPES = set()

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
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _route(n: int) -> str:
    """The route's suffix in `LAUNCHES` and `THREADS`: "" (K1/K2) or "_big"
    (K3/K4), from the block size alone."""
    return "" if n <= SMALL_N else "_big"


def _launch(A: torch.Tensor, w, jitter: float, threads=None) -> torch.Tensor:
    """Check the operands and launch; ``threads`` (128 or 256) overrides the
    route's CTA size (for timing one against the other)."""
    if A.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"chol_inv kernel takes float32/float64, got {A.dtype}")
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected (batch, n, n), got {tuple(A.shape)}")
    B, n = A.shape[0], A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise NotImplementedError(
            f"chol_inv kernel takes 1 <= n <= {MAX_N}, got n={n} (larger "
            "blocks: ROADMAP §2, the twin of block_chol.inv_cholesky)")
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
                 float(jitter), out.data_ptr(), B, n,
                 THREADS[_route(n)] if threads is None else threads, stream)
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


def _count(name: str, A: torch.Tensor) -> None:
    LAUNCHES[name] += 1
    SHAPES.add((name, A.shape[0], A.shape[-1], A.dtype))


def inv_cholesky(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Minv = L^{-1}, L L' = A + jitter I, for A (batch, n, n)."""
    if not _on_cuda(A):
        return inv_cholesky_plain(A, jitter)
    out = _launch(A, None, jitter)
    _count("inv_cholesky" + _route(A.shape[-1]), A)
    return out


def inv_cholesky_diag(A: torch.Tensor, w: torch.Tensor,
                      jitter: float = 0.0) -> torch.Tensor:
    """Minv = L^{-1}, L L' = A + diag(w) + jitter I, for A (batch, n, n),
    w (batch, n)."""
    if not _on_cuda(A):
        return inv_cholesky_diag_plain(A, w, jitter)
    out = _launch(A, w, jitter)
    _count("inv_cholesky_diag" + _route(A.shape[-1]), A)
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
