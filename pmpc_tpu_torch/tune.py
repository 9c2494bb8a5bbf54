"""SCP regularization auto-tuning over the port's `scp.scp_solve`.

Twin of ``pmpc_tpu/tune.py`` (the reference's ``tune_scp``,
``pmpc/scp_mpc.py:460-497``): sweep the proximal regularization strength over
a log-spaced grid (with ``reg_u`` tied to ``reg_x`` by a fixed ratio), score
each setting by the final SCP residual, and return the best pair. Optionally
renders a log-log residual-vs-regularization plot (matplotlib is imported
only then).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .scp import scp_solve

#: score assigned to a failed solve (NaN contract) so it never wins the sweep
#: — infinite, not a finite sentinel: a merely-bad residual (> any finite
#: sentinel) must still beat a reg for which the solve fails outright
FAILED_SCORE = float("inf")


def _final_residual(solve_fn: Callable, args, kwargs) -> float:
    """Run one solve and report its last-iteration residual (FAILED_SCORE on failure)."""
    _, _, data = solve_fn(*args, **kwargs)
    if data is None or not data.get("hist"):
        return FAILED_SCORE
    return float(data["hist"][-1]["resid"])


def _plot_sweep(regs, scores, reg_ratio, savefig):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.loglog(regs, scores)
    plt.ylabel("final residual")
    plt.xlabel("reg_x")
    plt.title("reg_u = reg_x * %6.1e" % reg_ratio)
    plt.tight_layout()
    plt.grid(visible=True, which="major")
    plt.grid(visible=True, which="minor")
    if savefig is not None:
        plt.savefig(savefig, dpi=200)


def tune_scp(
    *args,
    sample_nb: int = 14,
    reg_rng: Tuple[int, int] = (-3, 3),
    solve_fn: Callable = scp_solve,
    savefig: Optional[str] = None,
    plot: bool = False,
    **kwargs,
) -> Tuple[float, float]:
    """Pick (reg_x, reg_u) minimizing the final SCP residual over a log grid."""
    reg_ratio = float(kwargs.pop("reg_ratio", 1e-1))
    candidates: Sequence[float] = kwargs.pop(
        "reg_list", np.logspace(reg_rng[0], reg_rng[1], sample_nb)
    )

    scores = []
    for reg in candidates:
        trial_kw = dict(kwargs, reg_x=reg, reg_u=reg * reg_ratio, verbose=False)
        scores.append(_final_residual(solve_fn, args, trial_kw))

    if plot or savefig is not None:
        _plot_sweep(candidates, scores, reg_ratio, savefig)

    best = min(range(len(candidates)), key=scores.__getitem__)
    reg_x = float(candidates[best])
    return reg_x, reg_x * reg_ratio
