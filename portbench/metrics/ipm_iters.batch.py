"""Layer: box IPM (``solvers/ipm.py``). Batched IPM iterations a call: the
program's K1 (``inv_cholesky_diag``) launch counter over the traced window,
one launch an IPM iteration of the box path, over its calls."""


def read(rec):
    n = rec["launches"].get("inv_cholesky_diag", 0)
    return n / len(rec["solves"]) if n and rec["solves"] else None
