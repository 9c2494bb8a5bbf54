"""BASELINE config 5, the pod-scale deployment, as the benchmark's cell
``m64n50.b256`` runs it (``portbench/configs/dubins_m64_n50_f64.json``):
float64, ``max_it`` 40, ``res_tol`` 1e-3, 12 IPM iterations a subproblem,
Anderson acceleration.

On the CPU, cut to N = 40, Nc = 5 (nf = 70, the width that goes to K3 on
the card), M = 3, B = 2, from the cold-batch draw of the cell's traffic:
the port's U against the KKT point that the benchmark's plain reference
(``portbench/reference/scp.py``) reaches from it; and the cell resolves by
name, cut to a tiny size, with the numbers the configuration states.
"""

import pytest
import torch

from pmpc_tpu_torch.ops import chol_inv
from portbench import check, find, program
from portbench.reference import scp as reference
from portbench.tests._tiny import tiny_cell

CELL = "m64n50.b256"
# The port stops where its SCP step's residual falls under res_tol = 1e-3,
# not at the KKT point: on these seeds its U lies 2.2e-3 to 4.6e-3 from it
# (the card's sound readings of the cell's check lie in the same range). A
# lane's answer held against another lane's KKT point lies over 1e-1 away.
# So 1e-2: twice the largest distance, ten times under that fault.
U_TOL = 1e-2


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_port_meets_the_reference_at_k3_width(seed):
    cell = find.cell(CELL)
    cfg = dict(cell["config"], N=40, M=3)
    assert (cfg["N"] - cfg["Nc"]) * cfg["udim"] == 70 > chol_inv.SMALL_N  # K3's route
    mix = dict(cell["traffic"], B=2)
    x0 = torch.from_numpy(find.module("generators", mix["generator"]).x0_batch(cfg, mix, seed, 1))
    data = program.inputs(cfg, mix["B"], torch.device("cpu"))._replace(x0=x0)
    X, U, info = program.build(cfg)(data)
    assert U.dtype == torch.float64 and info["converged"].all()
    U_star, X_star, conv, its = reference.solve(
        program.dynamics(cfg), x0, data.X_ref, data.U_ref, cfg["q"], cfg["r"], cfg["u_lo"],
        cfg["u_hi"], cfg["Nc"], check.REF_TOL, check.REF_MAX_IT, check.REF_QP_TOL, U0=U)
    assert conv.all() and (its < check.REF_MAX_IT).all(), its
    assert (U - U_star).abs().max() < U_TOL
    # a wrong answer is caught: lane 1's U is far from lane 0's KKT point
    assert (U[1] - U_star[0]).abs().max() > 10 * U_TOL


def test_the_cell_resolves_with_the_configuration_it_states():
    cell = tiny_cell(CELL, M=4, N=10, Nc=2, B=4, sample=3)
    cfg, mix = cell["config"], cell["traffic"]
    assert (cfg["M"], cfg["N"], cfg["Nc"], mix["B"], cell["check"]["sample"]) == (4, 10, 2, 4, 3)
    assert cell["workload"]["config"] == "dubins_m64_n50_f64" and cell["workload"]["chips"] == 1
    assert program.dtype_of(cfg) == torch.float64
    assert cfg["solver"] == dict(method="condensed", has_u_bounds=True, max_it=40,
                                 res_tol=1e-3, accel="AA", ipm_iters=12)
    assert mix == dict(generator="cold_batch", B=4, spread=0.0, particle_sigma=0.02)
    assert cell["check"]["limits"]["failed"] == 0
    full = find.cell(CELL)["config"]
    assert (full["M"], full["N"], full["Nc"], full["xdim"], full["udim"]) == (64, 50, 5, 4, 2)
    assert find.cell(CELL)["traffic"]["B"] == 256
    layer = {m["name"] for m in cell["per_layer"]}
    assert {"ipm_iters.pod", "kernels_per_ipm_iter.pod", "k3_roofline_pct.pod",
            "scp_iters.batch", "device_idle_pct.batch"} <= layer
    assert {m["name"] for m in cell["end_to_end"]} == {"solves_per_s", "setup_s"}
