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
count, which the C side picks from n alone (32 threads up to n = 64, 64
above); `_route` names the launch counter the same way. The memory floor of
a call is the lower triangle of A (and w) read once and the full block
written once, batch*(n(n+1)/2 + n*n + n)*4 B in f32: ~31 MB at the flagship
(~9 us at the H100 SXM's 3.35 TB/s peak), ~101 MB at (2048, 90, 90)
(~30 us). The kernel runs at about a sixth of
it: a matrix is a chain of ceil(n / 8) dependent panels, and what it waits
on is that chain's latency (a serial stretch on one warp for each 8 x 8
diagonal block, three barriers a panel), not memory and not the FMA units.
The design keeps the chain short and many chains in flight: one small CTA
per matrix; the lower triangle alone in shared memory (half the space, twice
the matrices an SM holds); one right-looking sweep that builds the factor
and its inverse together panel by panel; the diagonal blocks in registers
with warp shuffles and one division a pivot; the trailing updates as
register-tiled 4 x 4 products fed by 16-byte shared loads; asynchronous
copies in, one coalesced write out. PERF.md has the times beside the bound.

On a CPU tensor each entry point runs its plain PyTorch version
(``cholesky_ex`` + ``solve_triangular``, NaN where the factor fails); on a
CUDA tensor it launches the kernel or raises. The kernel is built with
``nvcc`` at first use from ``csrc/`` into ``_build/<source hash>/`` and bound
with ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import block_chol

SMALL_N = 64  # K1/K2 up to here, K3/K4 ("_big") above
MAX_N = 96  # the kernel's limit (the TPU kernels' `_fits_big`)

# launches of each kernel (plain CPU calls are not counted)
LAUNCHES = {"inv_cholesky": 0, "inv_cholesky_diag": 0,
            "inv_cholesky_big": 0, "inv_cholesky_diag_big": 0}
# every (counter name, batch, n, dtype) launched since it was last cleared,
# with its launches: what a card-side check has to hold against the plain
# versions, and the launches of each shape
SHAPES = collections.Counter()

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
        lib.pmpc_empty_launch.argtypes = [ctypes.c_void_p]
        lib.pmpc_empty_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _route(n: int) -> str:
    """The route's suffix in `LAUNCHES`: "" (K1/K2) or "_big" (K3/K4), from
    the block size alone, as the C side picks its instantiation."""
    return "" if n <= SMALL_N else "_big"


def _launch(A: torch.Tensor, w, jitter: float) -> torch.Tensor:
    """Check the operands and launch."""
    if A.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"chol_inv kernel takes float32/float64, got {A.dtype}")
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected (batch, n, n), got {tuple(A.shape)}")
    B, n = A.shape[0], A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise NotImplementedError(
            f"chol_inv kernel takes 1 <= n <= {MAX_N}, got n={n} (larger "
            "blocks: linalg.spd_factor sends them to block_chol.inv_cholesky)")
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


def empty_launch() -> None:
    """Launch a kernel that does nothing on the current stream: what any
    launch costs, the floor under a launch-bound shape. Not a counted kernel."""
    err = _lib().pmpc_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


def _on_cuda(A: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if A.device.type == "cuda":
        return True
    if A.device.type == "cpu":
        return False
    raise NotImplementedError(f"no chol_inv path for device {A.device}")


def _count(name: str, A: torch.Tensor) -> None:
    LAUNCHES[name] += 1
    SHAPES[(name, A.shape[0], A.shape[-1], A.dtype)] += 1


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
    where the factor fails (the library route, `block_chol.inv_cholesky`)."""
    return block_chol.inv_cholesky(A, jitter)


def inv_cholesky_diag_plain(A: torch.Tensor, w: torch.Tensor,
                            jitter: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the diagonal-adding kernel."""
    return inv_cholesky_plain(A + torch.diag_embed(w + jitter), 0.0)
