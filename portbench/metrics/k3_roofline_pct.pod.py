"""Layer: kernels (``ops/chol_inv.py``, ``csrc/chol_inv.cu``). K3's share of
its roofline: the least time of the traced window's K3 launches at their
shapes (the larger of bytes at the HBM bandwidth and flops at the dtype's
peak, `portbench.kernels`) over their time in the device trace.

K3 is the program's ``inv_cholesky_diag_big`` route (64 < n <= 96): the
kernel ``chol_inv_kernel`` instantiated with a diagonal (``HAS_DIAG`` true,
its second template argument) and 64 threads (its third), whatever its
dtype or panel width; K1 (32 threads) and K2 / K4 (no diagonal) are not
read. Where the trace's count of such launches is not the program's K3
launch counter (another route ran with the same instantiation, or the
trace lost events), the time and the bound would not describe the same
launches, and nothing is read."""

import re

from portbench.kernels import chol_inv_bound_s

K3 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*true\s*,\s*64\s*,")


def read(rec):
    n = rec["launches"].get("inv_cholesky_diag_big", 0)
    if rec["trace"] is None or rec["peaks"] is None or not n:
        return None
    times = [e[2] for e in rec["trace"]["events"] if K3.search(e[0])]
    if len(times) != n:
        return None
    bound = sum(c * chol_inv_bound_s(b, m, dt, rec["peaks"])
                for (name, b, m, dt), c in rec["shapes"].items()
                if name == "inv_cholesky_diag_big")
    t = sum(times) * 1e-9
    return 100.0 * bound / t if t > 0 and bound > 0 else None
