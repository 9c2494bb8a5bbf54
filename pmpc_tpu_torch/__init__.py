"""PyTorch/CUDA port of pmpc_tpu: particle SCP-MPC on one NVIDIA GPU.

The JAX package ``pmpc_tpu`` is the reference; this package never imports it
or JAX. Ported so far: the fused batched SCP solver (`build_scp_solver`:
the condensed and Riccati IPMs, whose factors run on a hand-written CUDA
kernel, ``ops/chol_inv.py``), the batched cone programs
(`conebatch.solve_problems_cone`: the composed route and the structured
arrow-IPM route), the smooth-constraint solvers, the host frontend with the
JAX package's API (``solve`` / ``scp_solve``, ``Problem``, ``aff_solve``,
the per-iteration dispatcher `solvers.dispatch.affine_solve_np`,
``accelerated_scp_solve``, ``tune_scp``), and batching and serving:
``solve_problems`` (stacked, fused and cone routes), the ZMQ solve farm
``remote`` (``python -m pmpc_tpu_torch.remote``), ``warmup`` (builds the
kernel and runs a shape once), ``sensitivity`` (feedback gains by the
implicit function theorem, `torch.func`) and ``native`` (the ctypes binding
of ``native/``'s host library). ``solve_problems`` and ``remote`` load on
first use.

Quick start (a torch step function f(x, u) -> x_next; every solve runs on
``device``, the card when None)::

    f_fx_fu_fn = pmpc_tpu_torch.make_f_fx_fu_fn(step, device="cuda")
    X, U, data = pmpc_tpu_torch.solve(f_fx_fu_fn, Q, R, x0, u_l=u_l, u_u=u_u,
                                      device="cuda")
"""

from .canonical import lqp_generate_problem_matrices  # noqa: F401
from .dynamics import linearize, make_f_fx_fu_fn, rollout  # noqa: F401
from .problem import Problem  # noqa: F401
from .scp import aff_solve, scp_solve, solve, solve_with_a_dict  # noqa: F401
from .torch_scp import SCPData, build_scp_solver, make_scp_data  # noqa: F401

__all__ = ["SCPData", "build_scp_solver", "make_scp_data", "solve", "scp_solve", "aff_solve",
           "solve_with_a_dict", "Problem", "make_f_fx_fu_fn", "linearize", "rollout",
           "lqp_generate_problem_matrices", "SOLVE_KWS", "solve_problems", "remote"]

# Keyword-compatible arguments of `solve` (the JAX package's SOLVE_KWS, whose
# parity is pmpc/__init__.py:5-31), plus the placement of the solves
SOLVE_KWS = {
    "X_ref",
    "U_ref",
    "X_prev",
    "U_prev",
    "x_l",
    "x_u",
    "u_l",
    "u_u",
    "verbose",
    "debug",
    "max_it",
    "time_limit",
    "res_tol",
    "reg_x",
    "reg_u",
    "slew_rate",
    "u_slew",
    "u0_slew",
    "cost_fn",
    "lin_cost_fn",
    "diff_cost_fn",
    "extra_cstrs_fns",
    "method",
    "solver_settings",
    "solver_state",
    "filter_method",
    "filter_window",
    "filter_it0",
    "device",
}


def __getattr__(name):
    # lazy imports keep the base import light
    if name == "accelerated_scp_solve":
        from .accelerated import accelerated_scp_solve

        return accelerated_scp_solve
    if name == "tune_scp":
        from .tune import tune_scp

        return tune_scp
    if name == "solve_problems":
        from .batch import solve_problems

        return solve_problems
    if name == "remote":
        import importlib

        return importlib.import_module(".remote", __name__)
    raise AttributeError(f"module 'pmpc_tpu_torch' has no attribute {name!r}")
