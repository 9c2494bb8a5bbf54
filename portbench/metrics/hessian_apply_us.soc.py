"""Layer: box IPM (``solvers/reduced.H_apply_factored``) with the per-stage
control cones. Device time of the factored Hessian apply a batched IPM
iteration, in us: the traced window's kernel K5 (``hessian_apply_kernel``,
``csrc/hessian_apply.cu``) over its cone IPM iterations, the program's K2
(``inv_cholesky``) launch counter (one factor an iteration,
`ipm_iters.soc`). A program without K5 has no such events, and nothing is
read."""

import re

K5 = re.compile(r"\bhessian_apply_kernel<")


def read(rec):
    n = rec["launches"].get("inv_cholesky", 0)
    if rec["trace"] is None or not n:
        return None
    times = [e[2] for e in rec["trace"]["events"] if K5.search(e[0])]
    return sum(times) * 1e-3 / n if times else None
