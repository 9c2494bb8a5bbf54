"""The comparison that decides ``correct``: the solves the window returned,
judged by the plain reference (``reference/scp.py``, float64), which reads
only the inputs the benchmark made and the program's answers.

Two numbers, each against the limit in ``checks/<cell>.json``:
- ``failed``: solves whose U or X is not finite or whose U leaves the box
  by more than the configuration's ``box_tol`` (a guarantee the
  configuration states), and calls that raised; limit 0. A configuration
  that states a cone radius ``u_soc_r`` states its guarantee too: a solve
  with any stage at ||u_{m,j}||_2 > u_soc_r + ``soc_tol`` fails as well.
- ``u_err``: over ``sample`` of the solves drawn from the seed, the largest
  |U - U*|, where U* is the KKT point of the same problem (with its cones,
  where the configuration states them) that the reference's descent
  reaches in float64 from the program's U. The problem
  is not convex (a car that faces away from its target may turn either
  way), so an answer is held to the local minimum it lies at, not to one
  the reference picked; garbage, a lane solved for another's inputs, or an
  imprecise answer still lies far from every KKT point. A drawn solve from
  which the reference does not reach a KKT point reads inf.
Every returned answer may be drawn, converged or not: a solve that stops
short of res_tol still returns its best iterate, and only the rate counts
it out. A solve whose U or X is not finite is left to ``failed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import program
from portbench.reference import scp as reference

REF_TOL, REF_MAX_IT, REF_QP_TOL = 1e-9, 60, 1e-14  # the float64 reference's stopping


def judge(cfg, check, ans, seed, n_failed_calls=0):
    """(numbers {name: (value, limit)}, correct, failed solves, extra notes)."""
    f = program.dynamics(cfg)
    lo, hi, tol = cfg["u_lo"], cfg["u_hi"], cfg["box_tol"]
    soc_r = cfg.get("u_soc_r")
    limits = check["limits"]
    notes = {}
    if ans is None:
        failed, uerr = n_failed_calls, math.inf
    else:
        U, X, conv = ans["U"], ans["X"], ans["converged"]
        finite = torch.isfinite(U).flatten(1).all(1) & torch.isfinite(X).flatten(1).all(1)
        inside = ((U >= lo - tol) & (U <= hi + tol)).flatten(1).all(1)
        if soc_r is not None:
            excess = U.norm(dim=-1) - soc_r
            inside = inside & (excess <= cfg["soc_tol"]).flatten(1).all(1)
            notes["cone_excess_max"] = float(excess[finite].max()) if finite.any() else None
        failed = int((~(finite & inside)).sum()) + n_failed_calls
        idx = torch.nonzero(finite).flatten()
        uerr = math.inf
        if idx.numel():
            rng = np.random.default_rng([seed, 1 << 30])
            draw = rng.choice(idx.numel(), size=min(check["sample"], idx.numel()), replace=False)
            pick = idx[torch.from_numpy(np.sort(draw)).to(idx.device)]
            U_star, _, ref_conv, ref_its = reference.solve(
                f, ans["x0"][pick], ans["X_ref"][pick], ans["U_ref"][pick], cfg["q"], cfg["r"],
                lo, hi, cfg["Nc"], REF_TOL, REF_MAX_IT, REF_QP_TOL, U0=U[pick].double(),
                soc_r=soc_r)
            # a lane where the reference stopped short of a KKT point gives no
            # reading: its U* may be the program's U, moved little or not at all
            gap = (U[pick].double() - U_star).abs().flatten(1).amax(1)
            uerr = float(torch.where(ref_conv, gap, torch.full_like(gap, math.inf)).max())
            notes.update(sampled=int(pick.numel()), sampled_converged=int(conv[pick].sum()),
                         reference_converged=int(ref_conv.sum()),
                         reference_iters_max=int(ref_its.max()))
        notes["converged_solves"] = int(conv.sum())
    numbers = dict(failed=(failed, limits["failed"]), u_err=(uerr, limits["u_err"]))
    correct = all(v <= lim for v, lim in numbers.values())
    return numbers, correct, failed, notes
