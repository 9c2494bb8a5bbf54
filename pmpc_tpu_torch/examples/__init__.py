"""The example scripts, run through the port: twins of the JAX package's
``examples/*.py`` with the same sizes, solver options, printed lines and
checks, the dynamics written in torch ops.

    python3 -m pmpc_tpu_torch.examples.simple_demo [--device cpu] [--out DIR]
    python3 -m pmpc_tpu_torch.examples.batch_solver
    python3 -m pmpc_tpu_torch.examples.custom_cost
    python3 -m pmpc_tpu_torch.examples.receding_horizon
    python3 -m pmpc_tpu_torch.examples.arbitrary_constraints

Each solves on the card unless given ``--device cpu``.
``PMPC_EXAMPLES_FAST=1`` runs the seconds-long smoke sizes;
``PMPC_RH_HOST=1`` adds ``receding_horizon``'s host-API loop. Each module's
``main(device=None, ...)`` returns the numbers it prints (a dict). Plots
(``simple_demo``) are written only under ``--out DIR``, and only where
matplotlib imports.
"""
