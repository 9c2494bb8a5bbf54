"""Layer: box IPM (``solvers/ipm.py``) with the per-stage control cones.
Batched IPM iterations a call: the program's K2 (``inv_cholesky``) launch
counter over the traced window, over its calls. With cones the Newton
matrix is formed and factored without a diagonal, one K2 launch an IPM
iteration (a graph replay counts its captured launches); every subproblem
starts warm, so no cold-start factor adds one."""


def read(rec):
    n = rec["launches"].get("inv_cholesky", 0)
    return n / len(rec["solves"]) if n and rec["solves"] else None
