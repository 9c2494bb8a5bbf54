"""Layer: kernels (``ops/chol_inv.py``, ``csrc/chol_inv.cu``). K2's share of
its roofline: the least time of the traced window's K2 launches at their
shapes (the larger of bytes at the HBM bandwidth and flops at the dtype's
peak) over their time in the device trace.

K2 is the program's ``inv_cholesky`` route (n <= 64): the kernel
``chol_inv_kernel`` instantiated without a diagonal (``HAS_DIAG`` false, its
second template argument) and 32 threads (its third), whatever its dtype or
panel width; K1 and K3 (a diagonal) and K4 (64 threads) are not read. Its
least traffic is the lower triangle of A read once and the full block
written once, batch (n(n+1)/2 + n^2) itemsize bytes: `portbench.kernels`'s
count less the diagonal that K2 does not read. The profiler can lose a few
of a call's ~340,000 kernel records (on the H100, 7 of 448 K2 events in one
traced call of `n20.soc.b512`): where the trace holds fewer such events than
the program's K2 launch counter and every counted launch has one shape, the
share is that shape's bound over the events' mean time. Where the trace
holds more (another route ran with the same instantiation), or fewer over
several shapes, the time and the bound would not describe the same
launches, and nothing is read."""

import re

import torch

from portbench.kernels import chol_inv_flops

K2 = re.compile(r"\bchol_inv_kernel<[^,<>]+,\s*false\s*,\s*32\s*,")


def k2_bound_s(batch, n, dtype, peak):
    """The least time of one K2 launch."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    bytes_ = batch * (n * (n + 1) // 2 + n * n) * itemsize
    return max(bytes_ / peak["bytes_per_s"], chol_inv_flops(batch, n) / peak["flops"][dtype])


def read(rec):
    n = rec["launches"].get("inv_cholesky", 0)
    if rec["trace"] is None or rec["peaks"] is None or not n:
        return None
    times = [e[2] for e in rec["trace"]["events"] if K2.search(e[0])]
    shapes = {s: c for s, c in rec["shapes"].items() if s[0] == "inv_cholesky"}
    if len(times) == n:
        bound = sum(c * k2_bound_s(b, m, dt, rec["peaks"]) for (_, b, m, dt), c in shapes.items())
    elif 0 < len(times) < n and len(shapes) == 1:
        (_, b, m, dt), = shapes
        bound = len(times) * k2_bound_s(b, m, dt, rec["peaks"])
    else:
        return None
    t = sum(times) * 1e-9
    return 100.0 * bound / t if t > 0 and bound > 0 else None
