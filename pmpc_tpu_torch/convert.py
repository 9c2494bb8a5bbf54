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
    if getattr(d, "u_soc_r", None) is not None:
        raise NotImplementedError(
            "SCPData.u_soc_r is not ported yet (ROADMAP §1.4)")
    params = getattr(d, "params", None)
    return SCPData(*(_t(getattr(d, f), device, dtype)
                     for f in SCPData._fields if f not in ("params", "u_soc_r")),
                   params=None if params is None else _t(params, device, dtype))


def warm_from_numpy(warm, device, dtype):
    """The IPM warm tuple (uc, uf, s, lam) -> tensors (s and lam carry the
    state rows when the solver has state boxes); None passes through."""
    if warm is None:
        return None
    return tuple(_t(a, device, dtype) for a in warm)
