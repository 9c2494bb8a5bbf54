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
    """An IPM warm tuple -> tensors; None passes through. The condensed IPM's
    is (uc, uf, s, lam), s and lam ``2 nc + 2 M nf`` long (plus
    ``2 M N xdim`` state rows with state boxes). The Riccati IPM's is (theta,
    uf, s, lam) in its own layout: theta padded to ``nct = max(Nc udim, 1)``
    entries (one dead entry without a consensus block), s and lam
    ``2 nct + 2 M nf (+ 2 M N xdim)`` long. A state from one package's
    solver starts the other's built with the same method."""
    if warm is not None and len(warm) != 4:
        raise NotImplementedError(
            "a warm tuple with SOC slacks and duals (sq, zq) is not ported "
            "yet (ROADMAP §1.4, §1.7)")
    return None if warm is None else tuple(_t(a, device, dtype) for a in warm)
