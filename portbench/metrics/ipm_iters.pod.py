"""Layer: box IPM (``solvers/ipm.py``). Batched IPM iterations a call at the
pod-scale width (nf = 90 > 64): the program's K3
(``inv_cholesky_diag_big``) launch counter over the traced window, one
launch an IPM iteration of the box path (a graph replay counts its captured
launches), over its calls."""


def read(rec):
    n = rec["launches"].get("inv_cholesky_diag_big", 0)
    return n / len(rec["solves"]) if n and rec["solves"] else None
