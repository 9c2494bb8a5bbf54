"""The control of the check: the plain reference put in the program's place
and computed one precision below the configuration's. The configurations
state float32 with TF32 off (the program's IEEE matmuls), so the control
runs the reference in float32 with TF32 matmuls on, with the program's
stopping rule (its res_tol and max_it on the step, its IPM tolerance 1e-6,
at most 30 interior-point iterations a QP: float32 rarely reaches 1e-6).
Its answers go through the same check as the program's and must come out
not correct; every number it reads is printed beside the program's limit.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 5]

runs on the card (TF32 exists only there), at the cell's own size, one
short window for each seed in one process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

CONTROL_QP_TOL, CONTROL_QP_ITERS = 1e-6, 30  # the program's float32 IPM tolerance
BLOCK = 4096  # particles (lanes times M) the control solves at once


def build(cfg):
    """``solver(data) -> (X, U, info)`` with the program's
    contract, computed by the reference in the data's dtype with TF32."""
    from portbench import program
    from portbench.reference import scp as reference
    f = program.dynamics(cfg)
    sol = cfg["solver"]

    def solver(data):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        n = max(1, BLOCK // cfg["M"])
        try:
            out = [reference.solve(f, data.x0[i:i + n], data.X_ref[i:i + n], data.U_ref[i:i + n],
                                   cfg["q"], cfg["r"], cfg["u_lo"], cfg["u_hi"], cfg["Nc"],
                                   sol["res_tol"], sol["max_it"], CONTROL_QP_TOL,
                                   U0=data.U_prev[i:i + n], qp_max_iter=CONTROL_QP_ITERS,
                                   soc_r=cfg.get("u_soc_r"))
                   for i in range(0, data.x0.shape[0], n)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.set_float32_matmul_precision(prev[1])
        U, X, conv, its = (torch.cat(t) for t in zip(*out))
        return X, U, dict(converged=conv, iters=its)

    return solver


def main(argv=None):
    p = argparse.ArgumentParser(description="the control of a cell's check, on the card")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench import find, harness
    if not torch.cuda.is_available():
        sys.exit("the control needs a CUDA device: TF32 exists only there")
    cell = find.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, numbers, notes = harness.execute(cell, seed, args.seconds, 0, t0,
                                                 torch.device("cuda", 0), build=build)
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=result["correct"],
                              attempted=result["attempted"], seconds=time.perf_counter() - t0,
                              notes=notes, compared=result["compared"])), flush=True)


if __name__ == "__main__":
    main()
