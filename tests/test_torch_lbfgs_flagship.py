"""The iteration count of `chip_smoke.py` phase 21's L-BFGS gate, on the
CPU, f64: the port's `barrier_core` against the JAX package's on the
flagship subproblem (1e-7), and the JAX package's optax L-BFGS within the
gate's 5e-3 of that Newton after the gate's 8000 iterations (ROADMAP §3
F8). The port's L-BFGS takes ~45 s for 8000 iterations on the CPU, so the
card holds it (phase 21); `tests/test_torch_barrier.py` holds it against the
JAX package on a small instance."""

import numpy as np
import torch

from pmpc_tpu.solvers import barrier as jb
from pmpc_tpu.solvers import ipm as jipm
from pmpc_tpu.solvers.reduced import assemble_condensed as j_assemble
from pmpc_tpu_torch.flagship import flagship_subproblem
from pmpc_tpu_torch.solvers import barrier as tb
from pmpc_tpu_torch.solvers import ipm as tipm
from pmpc_tpu_torch.solvers.reduced import assemble_condensed

torch.set_num_threads(1)


def test_lbfgs_iterations_of_the_flagship_gate():
    """`chip_smoke.py` phase 21 holds the port's L-BFGS, 8000 iterations, to
    5e-3 of `barrier_core` on the flagship subproblem (M = 32, logbarrier
    alpha 50; the optimum lies within 1e-4 of the box). Its reference point
    is the JAX package's (the two Newtons to 1e-7), and the JAX package's
    optax L-BFGS meets the same bound at the same count (ROADMAP §3 F8)."""
    b, r, ul, uu, Nc = flagship_subproblem(M=32)
    M, N, udim = ul.shape
    nc, nf = Nc * udim, (N - Nc) * udim
    cqp = j_assemble(*b, *r, Nc=Nc)
    bj = jipm._layout_bounds(ul, uu, None, None, M, N, N * 4, nc, nf, udim, np.float64)
    ucj, ufj, _ = jb.barrier_core(cqp, bj, "logbarrier", 50.0, 1.0, True, False, iters=40)
    T = lambda a: torch.as_tensor(np.asarray(a))[None]
    cq = assemble_condensed(*(T(a) for a in b + r), Nc=Nc)
    bt = tipm._layout_bounds(ul, uu, None, None, M, N, N * 4, nc, nf, udim, np.float64)
    uc, uf, st = tb.barrier_core(cq, bt, "logbarrier", 50.0, 1.0, True, False, iters=40)
    np.testing.assert_allclose(uc[0].numpy(), np.asarray(ucj), atol=1e-7, rtol=0)
    np.testing.assert_allclose(uf[0].numpy(), np.asarray(ufj), atol=1e-7, rtol=0)
    U_newton = np.concatenate([np.broadcast_to(np.asarray(ucj), (M, nc)), np.asarray(ufj)],
                              -1).reshape(M, N, udim)
    _, Uj, dj = jb.barrier_solve_np(b, r, ul, uu, None, None, Nc=Nc, method="logbarrier",
                                    alpha=50.0, settings=dict(solver="LBFGS", max_it=8000))
    e = np.abs(Uj - U_newton).max()
    print(f"optax L-BFGS, 8000 iterations, on the flagship subproblem: {e:.3e} from the "
          f"Newton, objective {dj['obj']:.9g} against {float(st['obj'][0]):.9g}")
    assert e <= 5e-3
