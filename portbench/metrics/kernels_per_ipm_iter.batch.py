"""Layer: host dispatch of the eager IPM (``solvers/ipm.py``,
``solvers/reduced.py``). Device kernels in the traced window over its K1
launches (batched IPM iterations): what the host launches an iteration."""

from portbench.trace import is_kernel


def read(rec):
    n = rec["launches"].get("inv_cholesky_diag", 0)
    if rec["trace"] is None or not n:
        return None
    return sum(1 for e in rec["trace"]["events"] if is_kernel(e[0])) / n
