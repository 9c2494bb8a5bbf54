"""What the example scripts share: the unicycle car in torch ops, the smoke
switch, the command line and the plots."""

from __future__ import annotations

import argparse
import os

import torch

DT = 0.25


def unicycle(x, u):
    """Unicycle car: x = [px, py, v, theta], u = [accel, turn rate], one step
    of DT."""
    px, py, v, th = x[0], x[1], x[2], x[3]
    return torch.stack([
        px + DT * v * torch.cos(th),
        py + DT * v * torch.sin(th),
        v + DT * u[0],
        th + DT * u[1],
    ])


def fast() -> bool:
    """``PMPC_EXAMPLES_FAST=1``: the seconds-long smoke sizes."""
    return os.environ.get("PMPC_EXAMPLES_FAST") == "1"


def settings(dtype=None, **kw) -> dict:
    """``solver_settings`` with the working dtype when one is given (else the
    frontend's default, torch's default dtype)."""
    return dict(kw, dtype=dtype) if dtype is not None else kw


def run(main, doc: str, argv=None):
    """The scripts' command line: ``--device`` (the card when not given)
    and ``--out`` (the directory for plots)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the solves run: cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the plots into this directory (simple_demo draws them; "
                         "only where matplotlib imports)")
    a = ap.parse_args(argv)
    return main(device=a.device, out=a.out)


def save_plot(out, name, X, U):
    """States and controls of each particle into ``out/name.png``; nothing
    without ``out`` or matplotlib."""
    if out is None:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    os.makedirs(out, exist_ok=True)
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.2))
    Xs = X if X.ndim == 3 else X[None]
    Us = U if U.ndim == 3 else U[None]
    for m in range(Xs.shape[0]):
        ls = "-" if m == 0 else "--"
        for i in range(Xs.shape[-1]):
            ax[0].plot(Xs[m, :, i], ls, color=f"C{i}", alpha=0.7,
                       label=f"x{i}" if m == 0 else None)
        for i in range(Us.shape[-1]):
            ax[1].plot(Us[m, :, i], ls, color=f"C{i}", alpha=0.7,
                       label=f"u{i}" if m == 0 else None)
    ax[0].set_title("states")
    ax[1].set_title("controls")
    ax[0].legend(fontsize=7)
    ax[1].legend(fontsize=7)
    path = os.path.join(out, f"{name}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"  plot -> {path}")
