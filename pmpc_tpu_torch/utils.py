"""Shared utilities of the port: the iteration table, shape helpers, and the
numeric and placement policy (matmul precision, the working dtype, the
default device, one-transfer device-to-host reads).

Twin of ``pmpc_tpu/utils.py``. The table prints the same strings as the JAX
package's. On the TPU the f32 hot cores ran at 'high' (3-pass bf16); on the
card the port runs IEEE f32 throughout, with TF32 off in both cuBLAS and
cuDNN. Any TF32 use needs its own accuracy A/B.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class _Column:
    """One table column: a header plus a printf-style cell format."""

    name: str
    fmt: str

    @property
    def width(self) -> int:
        """Inner cell width: widest of header and representative rendered values."""
        probes: tuple
        if self.fmt.endswith("s"):
            probes = ("",)
        else:
            probes = (0, -1, 1)
        try:
            rendered = max(len(self.fmt % p) for p in probes)
        except TypeError as e:
            raise ValueError(f"Unrecognized print format [{self.fmt}]") from e
        return max(rendered, len(self.name)) + 2

    def cell(self, value) -> str:
        text = self.fmt % value
        pad = self.width - len(text)
        # numeric cells lean right: the spare space (odd widths) goes left
        return " " * (pad - pad // 2) + text + " " * (pad // 2)

    def head(self) -> str:
        return self.name.center(self.width)


class TablePrinter:
    """ASCII iteration-log table (``+---+`` rules, centered cells).

    Construct with column names and printf formats, then emit
    ``make_header()`` once, ``make_values(row)`` per iteration, and
    ``make_footer()`` at the end.
    """

    def __init__(self, names: Sequence[str], fmts: Optional[Sequence[str]] = None,
                 prefix: str = ""):
        fmts = list(fmts) if fmts is not None else ["%9.4e"] * len(names)
        self.cols = [_Column(n, f) for n, f in zip(names, fmts)]
        self.prefix = prefix
        # validate formats eagerly (width raises on unsupported conversions)
        for c in self.cols:
            _ = c.width

    @property
    def names(self):
        return [c.name for c in self.cols]

    @property
    def fmts(self):
        return [c.fmt for c in self.cols]

    @property
    def widths(self):
        return [c.width for c in self.cols]

    def _rule(self) -> str:
        return self.prefix + "+" + "+".join("-" * c.width for c in self.cols) + "+"

    def _row(self, cells: Sequence[str]) -> str:
        return self.prefix + "|" + "|".join(cells) + "|"

    def make_header(self) -> str:
        rule = self._rule()
        return "\n".join([rule, self._row([c.head() for c in self.cols]), rule])

    def make_footer(self) -> str:
        return self._rule()

    def make_values(self, vals: Sequence) -> str:
        if len(vals) != len(self.cols):
            raise ValueError(f"expected {len(self.cols)} values, got {len(vals)}")
        return self._row([c.cell(v) for c, v in zip(self.cols, vals)])

    def print_header(self) -> None:
        print(self.make_header())

    def print_footer(self) -> None:
        print(self.make_footer())

    def print_values(self, vals: Sequence) -> None:
        print(self.make_values(vals))


def atleast_nd(x, n: int):
    """Left-pad the shape of ``x`` with 1s until it has ``n`` dims (None passes through)."""
    if x is None:
        return None
    if not hasattr(x, "ndim"):
        x = np.asarray(x)
    missing = n - x.ndim
    if missing <= 0:
        return x
    return x[(None,) * missing]


def numpy_dtype(d) -> np.dtype:
    """A dtype given as a torch dtype, a numpy dtype or its name, as numpy's."""
    if isinstance(d, torch.dtype):
        return np.dtype(str(d).replace("torch.", ""))
    return np.dtype(d)


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Read tensors of one device back to the host in ONE transfer: flattened
    into one vector of the first tensor's floating dtype, copied once, split
    again. Integer and boolean tensors come back as floats of that dtype
    (exact for counts and flags)."""
    dt = tensors[0].dtype
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    return out


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


def full_matmul_precision(fn):
    """Run ``fn`` inside `matmul_precision_scope`: the twin of the JAX
    package's ``with_matmul_precision`` decorator on a solver core."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with matmul_precision_scope():
            return fn(*args, **kwargs)

    return wrapped


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
