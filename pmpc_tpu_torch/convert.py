"""Problem data and solver state carried across from the JAX package.

The inputs arrive as numpy arrays (``np.asarray`` on each field of a JAX
``SCPData``, warm tuple or problem dict), so this module needs neither JAX
nor ``pmpc_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .torch_scp import SCPData


def _t(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def scp_data_from_numpy(d, device, dtype) -> SCPData:
    """A JAX ``SCPData`` (or any object with its fields) -> the port's;
    ``params`` and ``u_soc_r`` may be None."""
    opt = ("params", "u_soc_r")
    return SCPData(*(_t(getattr(d, f), device, dtype)
                     for f in SCPData._fields if f not in opt),
                   **{f: None if getattr(d, f, None) is None
                      else _t(getattr(d, f), device, dtype) for f in opt})


def warm_from_numpy(warm, device, dtype):
    """An IPM warm tuple -> tensors; None passes through. The condensed IPM's
    is (uc, uf, s, lam), s and lam ``2 nc + 2 M nf`` long (plus
    ``2 M N xdim`` state rows with state boxes). The Riccati IPM's is (theta,
    uf, s, lam) in its own layout: theta padded to ``nct = max(Nc udim, 1)``
    entries (one dead entry without a consensus block), s and lam
    ``2 nct + 2 M nf (+ 2 M N xdim)`` long. With cones both carry the cone
    slacks and duals (sq, zq), ``(Nc + M (N - Nc), 1 + udim)`` each, as
    entries 5 and 6. A state from one package's solver starts the other's
    built with the same method."""
    if warm is not None and len(warm) not in (4, 6):
        raise ValueError(f"an IPM warm tuple has 4 or 6 entries, not {len(warm)}")
    return None if warm is None else tuple(_t(a, device, dtype) for a in warm)


def cone_warm_from_numpy(warm, device, dtype):
    """The composed cone solve's warm tuple ``solver_state["cone_warm"]``
    (v, zl, zq) of one problem, numpy, -> tensors on ``device``; None passes
    through. Both packages' serial solves store it as numpy, so a state from
    one starts the other as it is; this gives the tensors that
    `solvers.coneipm.cone_qp_solve` takes (add a leading batch axis)."""
    if warm is not None and len(warm) != 3:
        raise ValueError(f"a cone warm tuple (v, zl, zq) has 3 entries, not {len(warm)}")
    return None if warm is None else tuple(_t(a, device, dtype) for a in warm)


def cone_warm_to_numpy(warm):
    """The inverse of `cone_warm_from_numpy`: tensors (any device) -> numpy."""
    return None if warm is None else tuple(a.detach().cpu().numpy() for a in warm)


def problem_from_numpy(p, dynamics, device, dtype=torch.float64):
    """A JAX package problem dict (numpy arrays, ``f_fx_fu_fn``) -> the
    port's: the torch step function under ``dynamics``, every array (in
    ``solver_settings`` and its ``extra_cstrs`` tuples too) a tensor on
    ``device`` in ``dtype``. `conebatch.solve_problems_cone` takes either
    form."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return _t(v, device, dtype)
        if isinstance(v, dict):
            return {k: conv(a) for k, a in v.items()}
        if isinstance(v, (list, tuple)) and any(isinstance(a, np.ndarray) for a in v):
            return type(v)(conv(a) for a in v)
        return v

    out = {k: conv(v) for k, v in p.items() if k != "f_fx_fu_fn"}
    if "solver_settings" in out and out["solver_settings"].get("extra_cstrs"):
        out["solver_settings"]["extra_cstrs"] = [conv(tuple(ec)) for ec in
                                                 p["solver_settings"]["extra_cstrs"]]
    out["dynamics"] = dynamics
    return out
