"""Problem data and solver state carried across from the JAX package.

The inputs arrive as numpy arrays (``np.asarray`` on each field of a JAX
``SCPData`` or warm tuple), so this module needs neither JAX nor
``pmpc_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .torch_scp import SCPData


def _t(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def scp_data_from_numpy(d, device, dtype) -> SCPData:
    """A JAX ``SCPData`` (or any object with its fields) -> the port's."""
    for name in ("params", "u_soc_r"):
        if getattr(d, name, None) is not None:
            raise NotImplementedError(
                f"SCPData.{name} is not ported yet (ROADMAP §1.4/§1.5)")
    return SCPData(*(_t(getattr(d, f), device, dtype)
                     for f in SCPData._fields if f not in ("params", "u_soc_r")))


def warm_from_numpy(warm, device, dtype):
    """The IPM warm tuple (uc, uf, s, lam) -> tensors; None passes through."""
    if warm is None:
        return None
    return tuple(_t(a, device, dtype) for a in warm)
