"""Layer: host dispatch of the box IPM (``solvers/ipm.py``,
``solvers/reduced.py``) at the pod-scale width. Device kernels in the
traced window over its K3 launches (batched IPM iterations): what the
host launches, or a graph replays, an iteration."""

from portbench.trace import is_kernel


def read(rec):
    n = rec["launches"].get("inv_cholesky_diag_big", 0)
    if rec["trace"] is None or not n:
        return None
    return sum(1 for e in rec["trace"]["events"] if is_kernel(e[0])) / n
