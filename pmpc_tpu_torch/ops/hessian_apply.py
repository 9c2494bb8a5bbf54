"""The box IPM's factored Hessian apply, kernel K5 (``csrc/hessian_apply.cu``).

For each particle p of scenario b, with w_p = [uc_b; uf_p] (NU = N udim):

    Hw_p = Ft_p' (Qt_p (Ft_p w_p)) + Rt_p w_p + sl_p (T kron I) w_p + sl0_p E00 w_p

the factored form of the condensed Hessian's product (`reduced.CondensedQP`
says why the form is kept), once an IPM iteration in `grad_lagrangian` and in
`solve_eq`'s refinement.

Replaces no TPU kernel: the JAX package computes it with XLA dots
(``pmpc_tpu/solvers/reduced.py::H_apply_factored``), and so does the plain
version here. On the card that formula was two batched gemvs over the dense
Ft and ~13 small kernels an iteration; the kernel reads only Ft's lower blocks
(``Ft[j, l] = 0`` for ``l > j``, which `dynamics.condense` builds exactly:
the kernel's precondition), each once, and writes Hw once. Its bound is those
bytes at the memory rate: 0.146 ms at B M = 32,768, N = 30, xdim 4, udim 2 in
f32; 0.40 ms at B M = 16,384, N = 50 in f64 (H100 SXM, 3.35 TB/s). The
source's note says how its design meets it.

On a CPU tensor `hessian_apply` runs the plain version; on a CUDA tensor it
launches the kernel or raises. The kernel is built into the same library as
K1-K4 (`chol_inv.build`) and bound with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import chol_inv

# launches the device ran (plain CPU calls are not counted; a CUDA graph's
# launches count at each replay, `count_replay`)
LAUNCHES = {"hessian_apply": 0}
_TALLY = None  # while a graph is captured: its launches
_FN = {}


def _fn(dtype):
    if not _FN:
        lib = chol_inv._lib()
        for dt, name in ((torch.float32, "pmpc_hessian_apply_f32"),
                         (torch.float64, "pmpc_hessian_apply_f64")):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FN[dt] = fn
    return _FN[dtype]


@contextlib.contextmanager
def tally():
    """Count the launches of the enclosed block, a CUDA graph's capture, into
    the one-item list it yields instead of `LAUNCHES`."""
    global _TALLY
    prev, _TALLY = _TALLY, [0]
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def count_replay(launches) -> None:
    """Count a captured block's launches (`tally`) once: one replay ran them."""
    LAUNCHES["hessian_apply"] += launches[0]


def _count() -> None:
    if _TALLY is not None:
        _TALLY[0] += 1
    else:
        LAUNCHES["hessian_apply"] += 1


def hessian_apply(Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf) -> torch.Tensor:
    """Hw (..., M, NU) of Ft (..., M, NX, NU), Qt (..., M, N, xdim, xdim),
    Rt (..., M, N, udim, udim), sl_reg and sl_reg0 (..., M), uc (..., nc),
    uf (..., M, nf)."""
    if Ft.device.type == "cpu":
        return hessian_apply_plain(Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf)
    if Ft.device.type != "cuda":
        raise NotImplementedError(f"no hessian_apply path for device {Ft.device}")
    out = _launch(Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf)
    _count()
    return out


def _launch(Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf) -> torch.Tensor:
    """Check the operands and launch. Ft, Qt and Rt must be contiguous (a
    copy would move more bytes than the kernel); the small operands are
    copied where they are not (the IPM's first iterate may be a slice)."""
    sl_reg, sl_reg0, uc, uf = (a.contiguous() for a in (sl_reg, sl_reg0, uc, uf))
    args = (Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf)
    names = ("Ft", "Qt", "Rt", "sl_reg", "sl_reg0", "uc", "uf")
    if Ft.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"hessian_apply kernel takes float32/float64, got {Ft.dtype}")
    for name, a in zip(names, args):
        if a.dtype != Ft.dtype or a.device != Ft.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; Ft is {Ft.dtype} on "
                             f"{Ft.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Qt.ndim < 5 or Rt.ndim != Qt.ndim or Ft.ndim != Qt.ndim - 1:
        raise ValueError(f"expected Ft (..., M, NX, NU), Qt (..., M, N, xdim, xdim), Rt "
                         f"(..., M, N, udim, udim); got {tuple(Ft.shape)}, "
                         f"{tuple(Qt.shape)}, {tuple(Rt.shape)}")
    lead = Qt.shape[:-4]
    M, N, xdim = Qt.shape[-4:-1]
    NU = Ft.shape[-1]
    udim = max(NU // N, 1)
    nc = uc.shape[-1]
    want = {"Ft": lead + (M, N * xdim, N * udim), "Qt": lead + (M, N, xdim, xdim),
            "Rt": lead + (M, N, udim, udim), "sl_reg": lead + (M,), "sl_reg0": lead + (M,),
            "uc": lead + (nc,), "uf": lead + (M, NU - nc)}
    for name, a in zip(names, args):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {want[name]}")
    out = torch.empty(lead + (M, NU), dtype=Ft.dtype, device=Ft.device)
    if out.numel() == 0:
        return out
    P = out.numel() // NU
    with torch.cuda.device(Ft.device):
        stream = torch.cuda.current_stream(Ft.device).cuda_stream
        err = _fn(Ft.dtype)(*(a.data_ptr() for a in args), out.data_ptr(), P, M, N, xdim,
                            udim, nc, stream)
    if err != 0:
        raise RuntimeError(f"hessian_apply kernel launch failed: cudaError {err}")
    return out


def hessian_apply_plain(Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf) -> torch.Tensor:
    """Plain PyTorch version: the factored formula over the dense Ft."""
    N, xdim = Qt.shape[-3], Qt.shape[-1]
    udim = Rt.shape[-1]
    w = torch.cat([uc[..., None, :].expand(uf.shape[:-1] + uc.shape[-1:]), uf], dim=-1)
    lead = w.shape[:-1]
    Ftw = (Ft @ w[..., None])[..., 0]  # (..., M, NX)
    QFtw = (Qt @ Ftw.reshape(lead + (N, xdim, 1))).reshape(lead + (-1,))
    Hw = (QFtw[..., None, :] @ Ft)[..., 0, :]  # (..., M, NU)
    U = w.reshape(lead + (N, udim))
    Hw = Hw + (Rt @ U[..., None]).reshape(lead + (-1,))
    # slew coupling: sl_reg * (T kron I) w + sl_reg0 on the first block
    d = U[..., 1:, :] - U[..., :-1, :]  # (..., M, N-1, udim)
    Sw = torch.zeros_like(U)
    Sw[..., :-1, :] -= d
    Sw[..., 1:, :] += d
    Hw = Hw + sl_reg[..., None] * Sw.reshape(lead + (-1,))
    Hw[..., :udim] += sl_reg0[..., None] * U[..., 0, :]
    return Hw
