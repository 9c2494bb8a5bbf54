"""Numeric and placement policy of the port: matmul precision, the working
dtype and the default device.

Twin of ``pmpc_tpu/utils.py:125-200``. On the TPU the f32 hot cores ran at
'high' (3-pass bf16); on the card the port runs IEEE f32 throughout, with TF32
off in both cuBLAS and cuDNN. Any TF32 use needs its own accuracy A/B.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision_scope():
    """Run the enclosed code with full-precision f32 matmuls (TF32 off), then
    restore the previous settings."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def lane_where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select: ``cond`` (B,) broadcast over the trailing dims of a/b.
    The twin of ``jnp.where`` on a per-lane scalar under ``jax.vmap``."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def default_dtype() -> torch.dtype:
    """The working dtype: torch's default floating dtype (float32 unless the
    caller set float64)."""
    return torch.get_default_dtype()


def default_device() -> torch.device:
    """Where an entry point puts its tensors when the caller names no device:
    the card. There is no quiet CPU run: without a CUDA device this raises,
    and a caller that wants the CPU (the tests) says ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false): pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
