"""Layer: host dispatch of the cone IPM (``solvers/ipm.py``,
``solvers/coneipm.py``, ``solvers/reduced.py``). Device kernels in the
traced window over its K2 launches (batched IPM iterations,
`ipm_iters.soc`): what the host launches, or a graph replays, an
iteration."""

from portbench.trace import is_kernel


def read(rec):
    n = rec["launches"].get("inv_cholesky", 0)
    if rec["trace"] is None or not n:
        return None
    return sum(1 for e in rec["trace"]["events"] if is_kernel(e[0])) / n
