"""Dense second-order smooth solvers: the CVX and SQP entries of the solver
registry.

Twin of ``pmpc_tpu/solvers/second_order.py`` (the reference's experimental
registry, ``pmpc/experimental/solver_definitions.py:25-28,92-105``, and its
dense solvers, ``pmpc/experimental/second_order_solvers.py``):

- ``CVX``: damped Newton with Cholesky solves and a line search (the
  ``ConvexSolver`` role),
- ``SQP``: the same with an automatic Hessian regularization, a bisection
  for about the smallest ``lam`` that makes ``H + lam I`` positive definite
  (the ``SQPSolver`` role, ``second_order_solvers.py:177-215``), for a user
  ``diff_cost_fn`` that makes the objective locally nonconvex.

They work on the dense stacked variable z = [u_cons; u_free_1..M], as the
reference's dense solvers work on vec(U). The factors are the library's
(`ops.linalg.cholesky_factor`, NaN where a factor fails, and
`ops.linalg.cholesky_solve`, the JAX module's ``_chol_solve``), as the JAX
package takes ``jnp.linalg.cholesky`` outside any kernel. Every function takes an
explicit leading batch axis B; the objective is written for one lane and
mapped over the batch with ``torch.func.vmap``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.linalg import cholesky_factor, cholesky_solve
from ..utils import full_matmul_precision


def positive_cholesky_factorization(H: torch.Tensor, lo: float = 1e-10, hi: float = 1e10,
                                    steps: int = 40):
    """(L, lam) per lane of H (B, n, n): the Cholesky factor of ``H + lam I``
    with about the smallest lam in [lo, hi] that makes it positive definite,
    lam = 0 where H itself factors. Log-space bisection over a fixed number
    of steps (``second_order_solvers.py:177-215``)."""
    B, n = H.shape[0], H.shape[-1]
    dtype, dev = H.dtype, H.device
    eye = torch.eye(n, dtype=dtype, device=dev)

    def ok(lam):  # lam (B,)
        return torch.isfinite(cholesky_factor(H + lam[:, None, None] * eye)).flatten(1).all(-1)

    base_ok = ok(torch.zeros(B, dtype=dtype, device=dev))
    # log10 bounds: llo fails (or is untested), lhi works
    llo = torch.full((B,), math.log10(lo), dtype=dtype, device=dev)
    lhi = torch.full((B,), math.log10(hi), dtype=dtype, device=dev)
    ten = torch.tensor(10.0, dtype=dtype, device=dev)
    for _ in range(steps):
        mid = 0.5 * (llo + lhi)
        good = ok(ten ** mid)
        llo, lhi = torch.where(good, llo, mid), torch.where(good, mid, lhi)
    lam = torch.where(base_ok, 0.0, ten ** lhi)
    return cholesky_factor(H + lam[:, None, None] * eye), lam


@full_matmul_precision
def dense_newton_solve(objective: Callable, z0: torch.Tensor, obj_args: tuple = (),
                       iters: int = 20, ls_steps: int = 25, regularized: bool = False):
    """Damped (possibly regularized) dense Newton on ``objective(z, *obj_args)``
    of every lane.

    ``objective`` maps one lane's z (n,) and its ``obj_args`` (without the
    batch axis) to a scalar; z0 (B, n) and every ``obj_args`` entry carry the
    lane axis. ``regularized=False`` is the ``ConvexSolver`` role (a fixed
    1e-10 jitter), ``regularized=True`` the ``SQPSolver`` role. A step whose
    factor failed (NaN) is the gradient step -g. Each iteration takes the
    best of ``ls_steps`` halvings 0.5^k, k = 0.., where the objective drops
    (none: no move). Returns (z (B, n), the final objective (B,))."""
    dtype, dev = z0.dtype, z0.device
    B, n = z0.shape
    f1 = lambda z, *a: objective(z, *a)
    fval_of = torch.func.vmap(f1)
    grad_of = torch.func.vmap(torch.func.grad(f1))
    hess_of = torch.func.vmap(torch.func.hessian(f1))
    # the ladder: every halving of every lane at once
    fladder = torch.func.vmap(torch.func.vmap(f1, in_dims=(0,) + (None,) * len(obj_args)))
    ts = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    z = z0
    fval = fval_of(z, *obj_args)
    for _ in range(iters):
        g = grad_of(z, *obj_args)
        H = hess_of(z, *obj_args)
        if regularized:
            L, _ = positive_cholesky_factorization(H)
        else:
            L = cholesky_factor(H + 1e-10 * eye)
        dz = -cholesky_solve(L, g)
        dz = torch.where(torch.isfinite(dz).all(-1, keepdim=True), dz, -g)
        f_t = fladder(z[:, None] + ts[:, None] * dz[:, None], *obj_args)
        # the best strict decrease; ties go to the first (largest) step
        f_t = torch.where(torch.isnan(f_t), torch.inf, f_t)
        k = f_t.argmin(-1)
        f_best = f_t.gather(-1, k[:, None])[:, 0]
        better = f_best < fval
        t_best = torch.where(better, ts[k], 0.0)
        fval = torch.where(better, f_best, fval)
        z = z + t_best[:, None] * dz
    return z, fval
