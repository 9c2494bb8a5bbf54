"""PyTorch/CUDA port of pmpc_tpu: the fused condensed SCP main path.

The JAX package ``pmpc_tpu`` is the reference; this package never imports it
or JAX. The slice ported so far: Dubins-style dynamics linearization,
condensed consensus assembly, the box-constrained Mehrotra IPM whose arrow
factors run on a hand-written CUDA kernel (``ops/chol_inv.py``), and the
batched SCP loop with Anderson acceleration and early exit.
"""

from .torch_scp import SCPData, build_scp_solver, make_scp_data

__all__ = ["SCPData", "build_scp_solver", "make_scp_data"]
