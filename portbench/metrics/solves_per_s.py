"""Converged solves completed in the window over the window's whole time
(host clock, first call's start to last call's end). A solve counts when the
program reports its SCP residual under the configuration's res_tol."""


def read(rec):
    n = sum(s["converged"] for s in rec["solves"])
    return n / rec["window_s"] if rec["window_s"] > 0 else None
