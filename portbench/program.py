"""The system under test: the fused batched SCP solver of ``pmpc_tpu_torch``,
built from a configuration file, and the constant part of its inputs.

Everything the benchmark takes from the program passes through here: the
solver (`build`), its kernel (`load_kernels`), its input container
(`inputs`), and its launch counters (`counters`). A check that puts another
solver in the program's place (the control, a planted fault) replaces
`build`.
"""

from __future__ import annotations

import functools

import torch

from portbench import find


def dtype_of(cfg):
    return {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]


def dynamics(cfg):
    """The configuration's user dynamics f(x, u) with its parameters bound."""
    mod = find.module("dynamics", cfg["dynamics"])
    return functools.partial(mod.step, p=tuple(cfg["dynamics_params"]))


def build(cfg):
    """``solver(data) -> (X, U, info)`` of the configuration:
    ``pmpc_tpu_torch.build_scp_solver`` with its dimensions and options."""
    from pmpc_tpu_torch import build_scp_solver
    return build_scp_solver(dynamics(cfg), N=cfg["N"], xdim=cfg["xdim"], udim=cfg["udim"],
                            M=cfg["M"], Nc=cfg["Nc"], **cfg["solver"])


def load_kernels(device):
    """Load the program's hand kernel on a card (built into the checkout's
    ``pmpc_tpu_torch/_build/`` by a checkout's first run) with one empty
    launch, so that set-up times the load apart from the warm-up call."""
    if device.type == "cuda":
        from pmpc_tpu_torch.ops import chol_inv
        chol_inv.empty_launch()


def inputs(cfg, B, device):
    """The (B, M, ...) problem of the configuration with x0 = 0 and the
    references X_ref = 0, U_ref = 0 (the tracking target at the origin):
    the traffic replaces x0, and X_ref where it moves the target. A
    configuration that states ``u_soc_r`` gets that radius on every stage
    of every particle."""
    from pmpc_tpu_torch import make_scp_data
    M, N, xdim, udim = cfg["M"], cfg["N"], cfg["xdim"], cfg["udim"]
    dt = dtype_of(cfg)
    lead = (B, M, N)
    eye = lambda d, s: (s * torch.eye(d, dtype=dt, device=device)).expand(lead + (d, d)).clone()
    cone = {} if "u_soc_r" not in cfg else \
        dict(u_soc_r=torch.full(lead, cfg["u_soc_r"], dtype=dt, device=device))
    return make_scp_data(
        torch.zeros(B, M, xdim, dtype=dt, device=device), eye(xdim, cfg["q"]),
        eye(udim, cfg["r"]), reg_x=cfg["reg_x"], reg_u=cfg["reg_u"],
        u_l=torch.full(lead + (udim,), cfg["u_lo"], dtype=dt, device=device),
        u_u=torch.full(lead + (udim,), cfg["u_hi"], dtype=dt, device=device),
        dtype=dt, device=device, **cone)


def counters():
    """The program's launch counters: K1 launches, and the launches of each
    (kernel, batch, n, dtype) shape."""
    from pmpc_tpu_torch.ops import chol_inv
    return dict(chol_inv.LAUNCHES), dict(chol_inv.SHAPES)
