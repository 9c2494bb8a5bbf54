"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; a failed check is printed where it
happens and the run exits non-zero before the two JSON lines:
1. the card (nvidia-smi name and power limit); no CUDA -> exit 1;
2. build the inverse-Cholesky kernels from pmpc_tpu_torch/csrc/ (nvcc);
3. kernels against their plain PyTorch versions on the card, f32 and f64,
   at every shape a phase below launches: K1 (2048, 50, 50) and (8, 50, 50),
   K2 (64, 10, 10), (32, 10, 10), (1, 10, 10) and (2048, 50, 50) (the
   state-box Newton blocks), K3 and K4 (2048, 90, 90); a ragged batch of 37
   at n in {1, 7, 8, 9, 33, 63, 64, 65, 72, 95, 96}; the NaN contract at
   n = 50 and 90 (a non-SPD block, a bad pivot inside a panel, a NaN entry, a
   NaN weight); blocks with weights over twelve orders of magnitude, where
   the kernel's residual must stay within four times the plain version's;
   n = 97 refused; then each kernel timed with CUDA events at its main
   shape (K2 also at (2048, 50, 50)) beside its plain version, the library
   calls and its bound, and K2 at (64, 10, 10) beside the launch of a kernel
   that does nothing; then K5 (`hessian_apply`, the box IPM's factored
   Hessian apply) at the four benchmark cells' shapes, B M = 2,048 and
   32,768 at N = 30 in f32, 16,384 at N = 50 in f64, and config 3's 512 at
   N = 20 with no shared stages in f32, against the formula in f64, and
   timed with CUDA events over 50 launches beside its plain version, the
   formula with the consensus sum on cuBLAS (`H_apply_factored` before K5)
   and its bound; phases 5, 6 and 14 hold its launches to one a box-IPM
   iteration (K1's, K3's, K2's);
4. the accuracy-probe config in f32 against the JAX package's f64 answer
   (benchmarks/accuracy_ref_u64.npy), to 1e-3;
5. the headline program: B=64 scenarios, M=32, N=30, Nc=5, f32, Anderson
   acceleration (K1 + K2);
6. the pod-scale shape (BASELINE config 5): B=32, M=64, N=50, Nc=5, box
   controls, f32 then f64, each timed after one warm-up (K3 + K2); f64 must
   converge (f32 at this horizon is reported, not gated:
   tests/test_torch_scp.py holds the port's f32 floor to the JAX solver's);
7. the same shape without bounds, f32 then f64: the unconstrained solve
   (K4 + K2);
8. the flagship instance with a speed box |v| <= 1.2, which binds on most
   particles (the unconstrained speeds reach -1.35): state boxes in the IPM
   (K2 at 50 x 50 and at 10 x 10);
9. every (kernel, batch, n, dtype) that phases 4-8 launched and phase 3 did
   not hold against its plain version is held against it now;
10. the O(N) Riccati route against the condensed route on the card, f64: the
   flagship instance at B=4 (M=32, N=30, Nc=5), 8 SCP iterations with tight
   IPM solves: U within 1e-7 and equal IPM iteration counts per SCP
   iteration;
11. the headline program through the Riccati route: B=64, M=32, N=30, Nc=5,
   f32, Anderson acceleration; |U_riccati - U_condensed| against phase 5's
   answer is reported (two f32 fixed points at res_tol=1e-3);
12. the long-horizon configuration (one Dubins car, M=1, control boxes, state
   boxes +-6, slew, f32) at N=280 and N=140 with max_it=4 and max_it=12:
   ms per SCP iteration as (t12 - t4) / 8; N=280 stacked to B=64, max_it=4;
   N=280 in f64 beside f32; controls and states within their boxes, and the
   returned trajectory's defect against the dynamics linearized at it;
13. the pod-scale shape (config 5) through the Riccati route, f32 and f64
   (f64 must converge);
phases 10-13 reach no hand-written kernel (the JAX package's Riccati path
reaches no Pallas kernel either): their launch counts must stay 0;
14. BASELINE config 3 (one Dubins car, N=20, box controls +-1 and the cone
   ||u_j|| <= 0.9 on every stage) at its full batch B=512, f32 and f64, each
   warmed: ms per call, converged solves/s, converged_frac (f64 gated at
   0.95), the slowest lane's SCP iterations, lanes whose IPM gave up, the
   largest |u| and ||u_j|| (both dtypes gated), |U32 - U64|; the cone path
   forms its 40 x 40 Newton blocks, so K2 alone at (512, 40, 40), with one
   K5 launch a K2 launch, and the cone IPM replays CUDA graphs
   (``ipm_cone_replay`` rises);
15. the flagship instance with the cone ||u_j|| <= 0.9 on every stage, B=4,
   f64, tight IPM solves: the condensed route (K2 at (128, 50, 50) and
   (4, 10, 10)) against the Riccati route (no kernel), U within 1e-7, the
   IPM iteration counts printed;
16. linear extra rows (`ExtraRows`) that restate some control upper bounds,
   against the same bounds as boxes, on the flagship instance's first
   subproblem in f64 (U within 1e-6; the rows' l x l Schur factor is K2);
   then the B=64 flagship with ``ipm_predictor=False`` and with
   ``ipm_gondzio=2``, f32: converged_frac and rate reported;
17. the batched CVaR program (`flagship.cvar_batch`: B=64 problems of the
   Dubins car, M=4, N=20, full consensus, k=3, f64, `conebatch.
   solve_problems_cone`): ms per warm call beside the same call on the CPU,
   converged count (gated at 0.95 B), SCP and IPM iterations; its Newton
   matrix is 45 x 45, so K2 alone at (64, 45, 45) f64; the card against the
   CPU on every problem's first SCP iteration (U to 1e-7, equal IPM counts;
   the full calls of the first 4 problems reported beside the CPU's own
   spread under a 1e-15 change of x0); lane 0's first subproblem
   against a scipy oracle (1e-5); on every lane whose IPM converged, the
   program's objective against the k-worst sum of the particle costs
   computed in numpy (1e-6 relative);
18. extras on the composed route (`flagship.extras_batch`: B=64, M=2, N=20,
   Nc=5, box controls, a keep-in cone on every position, a soft bound
   through an auxiliary slack, the terminal cross cost): K4 alone at
   (64, 71, 71) f64, boxes and cones held to 1e-6, the card against the CPU
   at B=4 (U to 1e-7); then squareplus smoothing under control cones
   (nv = 210): no hand kernel, zero launches;
then phase 9 once more for the shapes phases 10-18 launched;
19. logbarrier smoothing of phase 18's program (smooth_alpha 50, f64, B=64):
   the box rows and the extras' linear rows become exponential cones, the
   keep-in cones stay SOCs (nv = 213: the library's factor, zero launches),
   solved by the central-path barrier method: converged >= 0.95 B, every u
   strictly inside the box, every barrier solve of the last SCP iteration
   converged; the first SCP iteration of 4 problems on the card against the
   host CPU (U to 1e-6, to 1e-8 where the Newton counts agree, both counts
   printed) and problem 0's first SINGLE_IT = 3 SCP iterations on both
   (reported; its full call, 10-15 SCP iterations, is cut to that depth to
   make room for phases 26-27);
20. phase 18's program plus one user exponential cone per particle (a soft
   terminal-speed limit whose aux costs linearly): nv = 73, K4 alone at
   (64, 73, 73) f64; converged >= 0.95 B, boxes and keep-in cones to 1e-6,
   every exp slack of every lane's first subproblem inside its cone to 1e-9,
   the card against the CPU as in 19, and lane 0's first subproblem through
   the serial `composed_cone_solve` on the card (exp_device, no host
   fallback, U to 1e-6 of the batch's lane 0);
21. the smooth-constraint solvers on the headline instance's first
   subproblem (M=32, N=30, Nc=5, box +-1): `barrier_solve_np` under
   logbarrier (alpha 50) and squareplus (alpha 8), f32 and f64 (K1 + K2:
   its ipm_core warm start and the Newton blocks (32, 50, 50); the f32
   squareplus U held by the f64 objective at it, 1e-6 relative);
   `barrier_core` from the previous controls (strictly inside, K2 twice a
   Newton step); L-BFGS against it (8000 iterations, 5e-3); a quadratic
   ``diff_cost_fn`` against the exact solve (2e-3); CVX and SQP against
   `barrier_core` (1e-6; M cut to 8 if one dense Newton step of the
   1610-vector takes over 0.5 s, and the cut is printed);
22. the Riccati smooth Newton (no hand kernel): squareplus against the
   condensed Newton on 21's subproblem in f64 (1e-5), then the long-horizon
   configuration at N = 280 (M=1, box +-1, state box +-6, slew 0.1) in f32:
   finite, the smoothed boxes respected, ms a call;
then phase 9 once more for the shapes phases 19-22 launched;
23. the host frontend (`pmpc_tpu_torch.solve`, the dispatcher, the host IPM
   entry points) with the Dubins step through `make_f_fx_fu_fn` on the card:
   (a) the flagship instance (M=32, N=30, Nc=5, box +-1) in f64, 5 SCP
   iterations with tight IPM solves, against the fused solver at B=1 (U to
   5e-5, the bound of tests/test_fuzz_paths.py; K1 and K2 launched);
   (b) the same in f32 and f64 at res_tol 1e-3 (reported: converged, SCP
   iterations, ms a call, ms a subproblem, |U32 - U64|); (c) config 5's
   width (M=64, N=50) bounded (K3) and unbounded (K4); (d) the cone
   ||u_j|| <= 0.9 (condensed cone route, K2, held to 1e-6), then the same
   cones as extra_cstrs SOC blocks plus a linear row, detected and solved
   on the structured route (never the composed program), U to 1e-6;
   (e) the long-horizon configuration at N=280 (f32) with no method: the
   auto-route to the Riccati IPM, no kernel launched, boxes held, ms per SCP
   iteration; then the flagship instance through method="riccati" with
   linear extra rows restating the first stage's bounds at +-0.3 against the
   same bounds as boxes (U to 1e-6); phase 9 once more. Phase 23 prints its
   seconds.
24. batched serving (`pmpc_tpu_torch.solve_problems`) with the Dubins step
   through `make_f_fx_fu_fn`: (a) the reference's GPU demo batch, 1000
   single-particle problems (N=20, box +-1, seeded x0), `warmup.warm_fused`
   at that shape first, then the fused route in f64 (res_tol 1e-5; max_it
   60: at 25, 17 of 1000 converge, on the CPU) and in f32 (1e-3):
   K1 alone at (1000, 40, 40), boxes to 1e-5, f64 converged >= 0.95 B,
   three problems against their serial `solve` (1e-4), then the stacked
   host route at max_it 5 (ms an SCP iteration); (b) config 3's width as 512
   problem dicts with ||u_j|| <= 0.9 as SOC extra_cstrs plus a linear row,
   f32 and f64 on the structured route of the cone batcher (the composed
   program never built, K2 at (512, 40, 40)): box, cone and row held in both,
   f64 converged >= 0.95 B, the histogram of SCP iterations per problem;
   then at B=8, f64, tight, against the composed route (1e-6); (c) 64
   problems of the flagship's width (M=32, N=30, Nc=5, box +-1) with one
   binding linear row each: K1 at (2048, 50, 50), K2 at (64, 10, 10),
   consensus and the row to 1e-6, one problem against its serial `solve`
   (1e-6); (d) `sensitivity.sensitivity_L` at t=0 on one flagship particle
   (N=30, logbarrier alpha 100, f64) at the smoothed optimum, the card's
   gain against the CPU's (1e-8), ms a call. Then phase 9 once more, and
   phase 24 prints its seconds. The farm (`remote`) is not driven here: it
   needs pyzmq, zstandard and cloudpickle.
25. the last modules of the port: (a) lane refill, `stream.solve_stream`:
   512 single-particle Dubins problems at config 3's width (N=20, box +-1,
   x0 = ones + s N(0, 1), s cycling over 0.05-0.4), f64, res_tol 1e-5, on 64
   lanes 4 SCP iterations a chunk (K1 alone at (64, 40, 40)); the first 64
   run to their batch maximum through the same solver (U to 1e-7, equal
   counts); all 512 as one fused scenario (`solve_problems(fused=True)`,
   K1 at (512, 40, 40)); ms, the lanes' idle share and host reads of each
   mode, |U_fused - U_stream| reported; (b) relin_stale 0 against 1 on the
   headline program (f32, B=64): converged_frac, SCP iterations, ms a call;
   (c) method="priccati" against "riccati", unbounded, f64, at N=280 (M=1)
   and at the headline width (B=64): U to 1e-8, ms and device kernels (the
   profiler) an SCP iteration, no hand kernel; (d) `parallel.
   make_sharded_solver`: the headline program at B=8 on an NCCL group of
   world size 1 against the plain solver, then two ranks spawned on this
   card over gloo (`parallel.check`), meshes 1 x 2 and 2 x 1, f64, against
   the unsharded solver (U to 1e-7, equal counts), each rank's K1 / K2
   launches by shape (K1 at (128, 50, 50) and K2 at (8, 10, 10) on the
   particle mesh); each spawned rank then holds every shape it launched
   against the plain version. Then phase 9 once more; phase 25 prints its
   seconds.
26. BASELINE configs 1, 2 and 4 (`flagship.baseline_config`: the Dubins car
   at N=20, unbounded, so every subproblem is `solve_eq`; 1: M=1, B=512; 2:
   M=10 sharing the first control, B=128; 4: config 1 with the obstacle
   ``lin_cost_fn``, B=512) under CONFIG_KW (max_it 25, res_tol 1e-3, AA),
   f32 then f64, each warmed: `report`'s numbers, the launches by shape
   (K2 alone), |U32 - U64|, f64 converged_frac >= 0.95, config 2's spread
   of u_0 over the particles <= 1e-6 in f64 (reported in f32); the first 8
   lanes in f64 on the card against the CPU (plain factors), U to 1e-7;
27. the five example scripts of the port (`pmpc_tpu_torch.examples`) at
   their full sizes on the card: simple_demo, batch_solver (B=1000: K1 at
   (1000, 40, 40) gated), custom_cost, receding_horizon (N=20, T=30, the
   fused and the host loop: both must reduce the tracking error) and
   arbitrary_constraints; each timed, its returned numbers printed (finite),
   its own checks gated, its launches by shape; then every shape phases
   26-27 launched that phase 3 did not time is timed beside its plain
   version, the library calls and its bound, with its launches per call,
   and phase 9 once more. Each of 26-27 prints its seconds.
Then one JSON line for the kernels and, last, one JSON line for the run.
Every solver phase sets
the launch counts to 0 before its timed call and reads them after it.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import pmpc_tpu_torch
from pmpc_tpu_torch import conebatch, sensitivity, tracing, warmup
from pmpc_tpu_torch.conebatch import _canon_problem, solve_problems_cone
from pmpc_tpu_torch.dynamics import dynamics_violation, linearize
from pmpc_tpu_torch.flagship import (EXP_KAPPA, EXP_VMAX, HEADLINE_KW, KEEP_IN_C, KEEP_IN_R,
                                     _x0_seed0,
                                     SOC_R3, baseline_config, cvar_batch, dubins,
                                     extras_batch, flagship, flagship_subproblem, long_horizon,
                                     long_horizon_subproblem, podscale, probe, stack_varied)
from pmpc_tpu_torch.ops import chol_inv, hessian_apply
from pmpc_tpu_torch.solvers import barrier, compose, ipm
from pmpc_tpu_torch.solvers.compose import (COST_ANCHOR_EPS, composed_cone_solve,
                                            composed_solve_batch_device)
from pmpc_tpu_torch.solvers.extras import _canon_extras, terminal_cross_cost
from pmpc_tpu_torch.solvers.reduced import assemble_condensed, recover_XU, solve_eq
from pmpc_tpu_torch.utils import matmul_precision_scope

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # relative, cond(A) <~ 1e2
PROBE_TOL = 1e-3  # the repo's f32 accuracy envelope (BASELINE.md)
B_FLAGSHIP, B_POD = 64, 32
V_BOX = 1.2
B_AGREE = 4  # phase 10: depth cut only, the widths stay
X_BOX = 6.0  # the long-horizon configuration's state box
# the returned trajectory's largest per-step defect against the car's dynamics,
# by max_it (the SCP residual is still large after 4 iterations)
DEFECT_MAX = {4: 1e-2, 12: 1e-4}
JITTER = 1e-7
SOURCE = "pmpc_tpu_torch/csrc/chol_inv.cu"
# name -> (TPU kernel it replaces, adds a diagonal, main-path shape (batch, n),
#          the phase whose launches the kernels line reports)
KERNELS = {
    "inv_cholesky_diag": ("pmpc_tpu/ops/pallas_chol.py:136", True, (2048, 50), "flagship"),
    "inv_cholesky": ("pmpc_tpu/ops/pallas_chol.py:161", False, (64, 10), "flagship"),
    "inv_cholesky_diag_big": ("pmpc_tpu/ops/pallas_chol.py:149", True, (2048, 90), "podscale"),
    "inv_cholesky_big": ("pmpc_tpu/ops/pallas_chol.py:176", False, (2048, 90), "unbounded"),
}
# published peaks of one H100 SXM: HBM bytes/s, FLOP/s outside the tensor cores
# (f32 67e12; f64 34e12, NVIDIA's data sheet)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# further shapes the phases launch: (adds a diagonal, batch, n)
OTHER_SHAPES = ((True, 8, 50), (False, 1, 10), (False, 32, 10), (False, 2048, 50),
                (False, 512, 40), (False, 128, 50), (False, 4, 10), (False, 64, 45),
                (False, 64, 71), (False, 64, 73), (True, 32, 50), (False, 32, 50),
                (True, 1000, 40), (False, 512, 1), (False, 64, 1), (True, 64, 40),
                (True, 128, 50), (False, 8, 10))
K2_WIDE = (2048, 50)  # K2's second timed shape, from the state-box phase
K2_CONE = (512, 40)  # K2's third timed shape: config 3's cone Newton blocks
K2_CVAR = (64, 45)  # K2 in f64: the CVaR program's Newton matrix (phase 17)
K4_EXTRAS = (64, 71)  # K4 in f64: the extras program's (phase 18)
K4_EXP = (64, 73)  # K4 in f64: the exp-cone extras program's barrier Newton matrix (phase 20)
K2_SMOOTH = (32, 50)  # K2: the smooth Newton's per-particle blocks (phase 21)
K1_SERVE = (1000, 40)  # K1: the reference's 1000-problem GPU batch, fused (phase 24 (a))
K1_STREAM = (64, 40)  # K1 in f64: the lane-refill stream's 64 lanes (phase 25 (a))
K1_SHARD = (128, 50)  # K1 in f64: one rank's particle blocks, the 1 x 2 mesh (phase 25 (d))
K2_SHARD = (8, 10)  # K2 in f64: one rank's consensus Schur blocks after the all-reduce (25 (d))
B_CONFIG3 = 512
B_CONE, M_CVAR, K_CVAR, B_CHECK = 64, 4, 3, 4  # phases 17-20
SINGLE_IT = 3  # phases 19-20: the SCP iterations of problem 0's card-against-CPU call
ALPHA_LOG, ALPHA_SQ = 50.0, 8.0  # phases 19 and 21-22: logbarrier and squareplus alpha
NV_LOG, NV_EXP = 213, 73  # the composed programs' widths in phases 19 and 20
LBFGS_ITERS, COST_ITERS = 8000, 1000  # phase 21: L-BFGS iterations (logbarrier, user cost)
NEWTON_SMOOTH = 40  # phase 21: Newton steps of the references
HOST_IT = 5  # phase 23 (a): SCP iterations of the host-against-fused pair
# K5 (hessian_apply): the cells' shapes (B, M, N, dtype, Nc) at xdim 4, udim 2
# (config 3's cone cell: one particle, no shared stages), and its tolerance
# against the formula in f64, relative to the largest entry (sums of ~200
# terms of size ~1 in f32)
K5_SHAPES = ((64, 32, 30, torch.float32, 5), (1024, 32, 30, torch.float32, 5),
             (256, 64, 50, torch.float64, 5), (512, 1, 20, torch.float32, 0))
K5_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
FAILED = []
CHECKED = set()  # (adds a diagonal, batch, n, dtype) held against plain


def require(cond, msg):
    """Record a failed check (the run goes on, then exits non-zero)."""
    if not bool(cond):
        FAILED.append(msg)
        print(f"  FAILED: {msg}")


def spd_inputs(B, n, dtype, dev, seed=0):
    """SPD blocks G G'/n + I (condition number ~10) and weights in [0.1, 2]."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n)) / np.sqrt(n)
    A = G @ np.swapaxes(G, -1, -2) + np.eye(n)
    w = rng.uniform(0.1, 2.0, size=(B, n))
    return (torch.from_numpy(A).to(dev, dtype).contiguous(),
            torch.from_numpy(w).to(dev, dtype).contiguous())


def run(diag, A, w, plain=False):
    if diag:
        f = chol_inv.inv_cholesky_diag_plain if plain else chol_inv.inv_cholesky_diag
        return f(A, w, JITTER)
    f = chol_inv.inv_cholesky_plain if plain else chol_inv.inv_cholesky
    return f(A, JITTER)


def library(diag, A, w):
    """The PyTorch library calls for the same function (no single call
    returns L^-1): cholesky_ex, then solve_triangular against the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    K = A + torch.diag_embed(w + JITTER) if diag else A + JITTER * eye
    return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(K)[0],
                                         eye.expand_as(A), upper=False)


def bound(diag, A, w):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of the bytes the function must move (the lower triangle of A and
    the weights read once, the full block written once) over the memory rate,
    and n^3/3 (factor) + n^3/3 (triangular inverse) flops per block over the
    rate of A's dtype."""
    B, n = A.shape[0], A.shape[-1]
    nbytes = B * (n * (n + 1) // 2 + n * n + (n if diag else 0)) * A.element_size()
    t_bytes, t_ops = nbytes / PEAK_BYTES, B * (2.0 / 3.0) * n ** 3 / PEAK_FLOPS[A.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def factor_residual(Minv, K):
    """|Minv K Minv' - I|_max with the products in f64."""
    M = Minv.double()
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (M @ K @ M.mT - eye).abs().max().item()


def check(diag, A, w):
    """Kernel vs plain on the card: the max abs error."""
    out, ref = run(diag, A, w), run(diag, A, w, plain=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    tol = TOL[A.dtype]
    what = f"{'diag' if diag else 'plain-A'} {tuple(A.shape)} {str(A.dtype)[6:]}"
    print(f"  {what}: max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g})")
    require(rel <= tol and (torch.triu(out, 1) == 0).all(),
            f"kernel {what} disagrees with its plain version")
    CHECKED.add((diag, A.shape[0], A.shape[-1], A.dtype))
    return err


def time_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_shape(name, diag, B, n, dtype, dev, card, r, note=""):
    """Kernel, plain version and library calls at one shape, timed in the
    order plain, library, kernel, kernel, library, plain, and the bound:
    into ``r`` and one printed line."""
    A, w = spd_inputs(B, n, dtype, dev)
    fns = {"plain": lambda: run(diag, A, w, plain=True),
           "library": lambda: library(diag, A, w),
           "kernel": lambda: run(diag, A, w)}
    t = {}
    for k in ("plain", "library", "kernel", "kernel", "library", "plain"):
        t.setdefault(k, []).append(time_ms(fns[k]))
    r["ms"], r["plain_ms"], r["library_ms"] = (
        sum(t[k]) / 2 for k in ("kernel", "plain", "library"))
    r["bound_ms"], r["bound_by"] = bound(diag, A, w)
    TIMED.add((name, B, n, dtype))
    print(f"  {name} ({B}, {n}, {n}) {str(dtype)[6:]}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library (cholesky_ex + solve_triangular) "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4g} ms by "
          f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.3g}% of it){note} [{card}]")
    return r


def phase_card():
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"[1] torch {torch.__version__} CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    lib = chol_inv.build()
    chol_inv._lib()
    print(f"[2] built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(dev, card):
    print("[3] kernels vs plain on the card")
    results = {}
    for name, (_, diag, (B, n), _) in KERNELS.items():
        for dtype in (torch.float32, torch.float64):
            A, w = spd_inputs(B, n, dtype, dev)
            chol_inv.reset_launch_counts()
            err = check(diag, A, w)
            require(chol_inv.LAUNCHES[name] == 1 and sum(chol_inv.LAUNCHES.values()) == 1,
                    f"{name} is not the kernel that ({B}, {n}, {n}) routes to")
            if dtype == torch.float32:
                results[name] = {"shape": [B, n, n], "max_abs_err": err}
    other = {}
    for diag, B, n in OTHER_SHAPES:
        for dtype in (torch.float32, torch.float64):
            err = check(diag, *spd_inputs(B, n, dtype, dev))
            if (B, n) in (K2_WIDE, K2_CONE, K2_CVAR, K4_EXTRAS, K4_EXP, K2_SMOOTH, K1_SERVE,
                          K1_STREAM, K1_SHARD, K2_SHARD):
                other[(B, n, dtype)] = {"shape": [B, n, n], "dtype": str(dtype)[6:],
                                        "max_abs_err": err}
    for n in (1, 7, 8, 9, 33, 63, 64, 65, 72, 95, 96):
        for dtype in (torch.float32, torch.float64):
            A, w = spd_inputs(37, n, dtype, dev, seed=n)
            for diag in (True, False):
                check(diag, A, w)
    # NaN contract: a block that is not SPD (all of it, one pivot in the
    # middle of a panel, a NaN below the diagonal, a NaN weight) is all NaN,
    # its neighbours are untouched
    for n in (50, 90):
        for bad in ("block", "pivot", "nan_entry", "nan_weight"):
            A, w = spd_inputs(5, n, torch.float32, dev, seed=9)
            if bad == "block":
                A[3] = -2.5 * torch.eye(n, device=dev)
            elif bad == "pivot":
                A[3, 11, 11] = -5.0
            elif bad == "nan_entry":
                A[3, n - 1, n - 2] = torch.nan
            else:
                w[3, 13] = torch.nan
            for diag in (True, False) if bad != "nan_weight" else (True,):
                out, ref = run(diag, A, w), run(diag, A, w, plain=True)
                ok = [0, 1, 2, 4]
                require(torch.isnan(out[3]).all() and torch.isnan(ref[3]).all()
                        and torch.isfinite(out[ok]).all()
                        and (out[ok] - ref[ok]).abs().max() <= TOL[A.dtype] * ref[ok].abs().max(),
                        f"NaN contract broken at n={n}, diag={diag}, bad {bad}")
    print("  NaN contract (n = 50, 90; non-SPD block, bad pivot inside a panel, NaN "
          "entry, NaN weight): that block is all NaN, its neighbours match")
    # conditioning: weights log-uniform over [1e-6, 1e6], as the IPM's late
    # iterations give them. The kernel takes its sums in another order than
    # the library's factor, not by another algorithm, so its residual may
    # differ from the plain version's by a small factor but no more: 4x.
    for n in (50, 90):
        A, _ = spd_inputs(256, n, torch.float32, dev, seed=11)
        w = torch.from_numpy(10.0 ** np.random.default_rng(12).uniform(
            -6, 6, size=(256, n))).to(dev, torch.float32)
        K = A.double() + torch.diag_embed(w.double() + JITTER)
        res, ref = (factor_residual(run(True, A, w, plain=pl), K) for pl in (False, True))
        print(f"  conditioning (256, {n}, {n}) f32, w in [1e-6, 1e6]: "
              f"|Minv K Minv' - I|_max kernel {res:.3e}, plain {ref:.3e}")
        require(res <= 4 * ref, f"kernel residual {res:.3e} > 4 x plain {ref:.3e} at n={n}")
    try:
        chol_inv.inv_cholesky(torch.eye(97, device=dev).expand(2, 97, 97).contiguous())
        require(False, "n = 97 was not refused")
    except NotImplementedError as e:
        print(f"  n = 97 refused: {e}")
    # time at the main-path shapes, f32 (K2's cone shape in f64 too): plain,
    # library, kernel, kernel, library, plain
    f32, f64 = torch.float32, torch.float64
    results["inv_cholesky"]["other_shapes"] = [other[K2_WIDE + (f32,)], other[K2_CONE + (f32,)],
                                               other[K2_CVAR + (f64,)],
                                               other[K2_SMOOTH + (f32,)],
                                               other[K2_CONE + (f64,)],
                                               other[K2_SHARD + (f64,)]]
    results["inv_cholesky_diag"]["other_shapes"] = [other[K1_SERVE + (f64,)],
                                                    other[K1_SERVE + (f32,)],
                                                    other[K1_STREAM + (f64,)],
                                                    other[K1_SHARD + (f64,)]]
    results["inv_cholesky_big"]["other_shapes"] = [other[K4_EXTRAS + (f64,)],
                                                   other[K4_EXP + (f64,)]]
    timed = [(name, diag, B, n, f32, results[name])
             for name, (_, diag, (B, n), _) in KERNELS.items()]
    timed[2:2] = [("inv_cholesky", False, *K2_WIDE, f32, other[K2_WIDE + (f32,)]),
                  ("inv_cholesky", False, *K2_CONE, f32, other[K2_CONE + (f32,)]),
                  ("inv_cholesky", False, *K2_CONE, f64, other[K2_CONE + (f64,)]),
                  ("inv_cholesky", False, *K2_CVAR, f64, other[K2_CVAR + (f64,)])]
    timed.insert(6, ("inv_cholesky", False, *K2_SMOOTH, f32, other[K2_SMOOTH + (f32,)]))
    timed.append(("inv_cholesky_big", False, *K4_EXTRAS, f64, other[K4_EXTRAS + (f64,)]))
    timed.append(("inv_cholesky_big", False, *K4_EXP, f64, other[K4_EXP + (f64,)]))
    timed += [("inv_cholesky_diag", True, *K1_SERVE, dt, other[K1_SERVE + (dt,)])
              for dt in (f64, f32)]
    timed += [("inv_cholesky_diag", True, *K1_STREAM, f64, other[K1_STREAM + (f64,)]),
              ("inv_cholesky_diag", True, *K1_SHARD, f64, other[K1_SHARD + (f64,)]),
              ("inv_cholesky", False, *K2_SHARD, f64, other[K2_SHARD + (f64,)])]
    for name, diag, B, n, dtype, r in timed:
        time_shape(name, diag, B, n, dtype, dev, card, r)
    # K2's main shape is launch-bound: its floor is a kernel that does nothing
    k2 = results["inv_cholesky"]
    k2["launch_floor_ms"] = time_ms(chol_inv.empty_launch)
    print(f"  inv_cholesky (64, 10, 10) f32: kernel {k2['ms']:.4f} ms beside "
          f"{k2['launch_floor_ms']:.4f} ms for the launch of an empty kernel [{card}]")
    return results


def k5_inputs(B, M, N, dtype, dev, xdim=4, udim=2, Nc=5, seed=0):
    """A condensed QP of random dynamics (stable, fx = I + 0.05 N(0, 1)),
    with slew terms and particle weights, and a random iterate:
    (Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf), K5's operands."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=dtype)
    u = lambda *s: torch.rand(*s, generator=g, device=dev, dtype=dtype) + 0.5
    lead = (B, M)
    eye = lambda d: torch.eye(d, dtype=dtype, device=dev)
    G = r(*lead, N, xdim, xdim)
    cqp = assemble_condensed(
        r(*lead, xdim), r(*lead, N, xdim), eye(xdim) + 0.05 * r(*lead, N, xdim, xdim),
        r(*lead, N, xdim, udim), r(*lead, N, xdim), r(*lead, N, udim),
        G @ G.mT / xdim + eye(xdim), 0.1 * eye(udim).expand(lead + (N, udim, udim)),
        r(*lead, N, xdim), r(*lead, N, udim), u(*lead), 0.01 * u(*lead), u(*lead), u(*lead),
        r(*lead, udim), Nc=Nc, weights=u(*lead))
    nc = Nc * udim
    return (cqp.Ft, cqp.Qt, cqp.Rt, cqp.sl_reg, cqp.sl_reg0, r(B, nc),
            r(B, M, N * udim - nc))


def k5_bound_ms(ins):
    """The least time of one K5 launch: the bytes it must move at the memory
    rate (Ft's lower blocks, Qt, Rt, the weights and the iterate read once,
    Hw written once); its 4 flops a lower entry of Ft are far under the FMA
    rate."""
    Ft, Qt, Rt, sl, sl0, uc, uf = ins
    N, xdim, udim = Qt.shape[-3], Qt.shape[-1], Rt.shape[-1]
    P = sl.numel()
    lower = xdim * udim * N * (N + 1) // 2
    n = P * lower + Qt.numel() + Rt.numel() + 2 * P + uc.numel() + 2 * uf.numel() \
        + P * uc.shape[-1]
    return n * Ft.element_size() / PEAK_BYTES * 1e3


def phase_hessian_apply(dev, card):
    """K5 against its plain version at the cells' shapes, then timed: plain
    version, the formula with the consensus sum on cuBLAS (what
    `H_apply_factored` ran before K5), kernel, kernel, formula, plain."""
    print("[3] K5 (hessian_apply) vs plain on the card")
    results = []
    for B, M, N, dtype, Nc in K5_SHAPES:
        ins = k5_inputs(B, M, N, dtype, dev, Nc=Nc)
        nc = ins[5].shape[-1]
        before = hessian_apply.LAUNCHES["hessian_apply"]
        out = hessian_apply.hessian_apply(*ins)
        ref = hessian_apply.hessian_apply_plain(*(a.double() for a in ins))
        torch.cuda.synchronize()
        rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
        what = f"(B {B}, M {M}, N {N}, Nc {Nc}) {str(dtype)[6:]}"
        require(rel <= K5_TOL[dtype] and hessian_apply.LAUNCHES["hessian_apply"] == before + 1,
                f"K5 {what} disagrees with its plain version (rel {rel:.3e}) or did not launch")

        def formula():
            Hw = hessian_apply.hessian_apply_plain(*ins)
            return Hw[..., :nc].sum(dim=-2), Hw[..., nc:]

        fns = {"plain": lambda: hessian_apply.hessian_apply_plain(*ins), "formula": formula,
               "kernel": lambda: hessian_apply.hessian_apply(*ins)}
        t = {}
        for k in ("plain", "formula", "kernel", "kernel", "formula", "plain"):
            t.setdefault(k, []).append(time_ms(fns[k]))
        r = {"shape": [B, M, N], "dtype": str(dtype)[6:], "rel_err": rel,
             **{f"{k}_ms": sum(v) / 2 for k, v in t.items()}, "bound_ms": k5_bound_ms(ins)}
        print(f"  K5 {what}: rel err {rel:.3e} against f64 (tol {K5_TOL[dtype]:g}); kernel "
              f"{r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, the formula with "
              f"the consensus sum {r['formula_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by bytes "
              f"({100 * r['bound_ms'] / r['kernel_ms']:.3g}% of it) [{card}]")
        results.append(r)
        del ins, out, ref
        torch.cuda.empty_cache()
    return results


def phase_probe(dev):
    solver, data = probe(torch.float32, device=dev)
    chol_inv.reset_launch_counts()
    X, U, info = solver(data)
    torch.cuda.synchronize()
    launches = dict(chol_inv.LAUNCHES)
    ref = np.load(ROOT / "benchmarks" / "accuracy_ref_u64.npy")
    err = float(np.abs(U[0].double().cpu().numpy() - ref).max())
    print(f"[4] accuracy probe f32 on the card: |U32 - U64_jax|_inf = {err:.3e} "
          f"(tol {PROBE_TOL:g}), scp iters {info['iters'].item()}, "
          f"resid {info['resid'].item():.3e}, launches {launches}")
    require(torch.isfinite(X).all() and U.shape == (1,) + ref.shape,
            "probe output is not finite or has the wrong shape")
    require(err <= PROBE_TOL, f"probe error {err:.3e} > {PROBE_TOL:g}")
    k1, k2 = launches["inv_cholesky_diag"], launches["inv_cholesky"]
    # one K1 and one K2 launch per batched IPM iteration (warm start: no
    # cold-start factor)
    require(k1 > 0 and k1 == k2, f"kernel launches on the probe path: {launches}")


def timed_call(solver, stack, warm_solver=None):
    """One warm-up call, then one timed call with the launch counts (K5's
    too) reset before it and read after it: (X, U, info, seconds, launches
    of K1-K4). The long
    Riccati calls launch the same small kernels hundreds of thousands of
    times: they are warmed by ``warm_solver``, a solver of the same shapes
    with fewer SCP iterations (a no-op where the caller has warmed)."""
    (warm_solver or solver)(stack)
    torch.cuda.synchronize()
    chol_inv.reset_launch_counts()
    hessian_apply.LAUNCHES["hessian_apply"] = 0
    t0 = time.perf_counter()
    X, U, info = solver(stack)
    torch.cuda.synchronize()
    return X, U, info, time.perf_counter() - t0, dict(chol_inv.LAUNCHES)


def report(tag, what, info, dt, launches, card):
    conv = info["converged"].cpu().numpy()
    resid = info["resid"].double().cpu().numpy()
    iters = info["iters"].cpu().numpy()
    print(f"[{tag}] {what}: {conv.sum() / dt:.2f} converged solves/s, "
          f"{dt * 1e3:.1f} ms/call, converged_frac {conv.mean():.4f}, "
          f"resid_max {resid.max():.3e}, resid_median {np.median(resid):.3e}, "
          f"iters_median {float(np.median(iters))}, iters_max {iters.max()} "
          f"[{card}]; launches {launches}")
    return float(conv.mean()), resid, iters


def only_launched(launches, names):
    return all((launches[k] > 0) == (k in names) for k in launches)


def phase_flagship(dev, card):
    solver, data = flagship(dtype=torch.float32, device=dev, **HEADLINE_KW)
    X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_FLAGSHIP))
    frac, _, _ = report(5, f"flagship B={B_FLAGSHIP} M=32 N=30 Nc=5 f32 AA",
                        info, dt, launches, card)
    require(torch.isfinite(X).all() and torch.isfinite(U).all()
            and U.shape == (B_FLAGSHIP, 32, 30, 2),
            "flagship output is not finite or has the wrong shape")
    require(frac >= 0.95, f"flagship converged_frac {frac} < 0.95")
    require(only_launched(launches, ("inv_cholesky_diag", "inv_cholesky"))
            and launches["inv_cholesky_diag"] == launches["inv_cholesky"],
            f"flagship launches {launches}: expected K1 == K2 > 0 and no other")
    # K5 once a box-IPM iteration
    require(hessian_apply.LAUNCHES["hessian_apply"] == launches["inv_cholesky_diag"],
            f"flagship K5 launches {hessian_apply.LAUNCHES}: expected K1's")
    return launches, U


def phase_podscale(dev, card):
    solver, data = podscale(torch.float32, device=dev)
    X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_POD, scale=0.02))
    what = f"pod-scale B={B_POD} M=64 N=50 Nc=5 box"
    frac, resid, _ = report(6, what + " f32 AA", info, dt, launches, card)
    print(f"    f32 converged_frac at 2.5e-3: {frac:.4f}; at 1e-3: "
          f"{float((resid < 1e-3).mean()):.4f}")
    require(torch.isfinite(X).all() and torch.isfinite(U).all()
            and U.shape == (B_POD, 64, 50, 2),
            "pod-scale f32 output is not finite or has the wrong shape")
    # K3 (90 x 90 Newton blocks) and K2 (the 10 x 10 Schur block) once per
    # batched IPM iteration; never K1, and no cold-start factor (K4)
    require(only_launched(launches, ("inv_cholesky_diag_big", "inv_cholesky"))
            and launches["inv_cholesky_diag_big"] == launches["inv_cholesky"],
            f"pod-scale launches {launches}: expected K3 == K2 > 0 and no other")
    require(hessian_apply.LAUNCHES["hessian_apply"] == launches["inv_cholesky_diag_big"],
            f"pod-scale K5 launches {hessian_apply.LAUNCHES}: expected K3's")
    pod_f64(6, what, True, U, card)
    return launches


def pod_f64(tag, what, bounded, U32, card):
    """The same stack in f64 (the card has native FP64): it must converge,
    which f32 at this horizon does not always do."""
    solver, data = podscale(torch.float64, bounded=bounded)
    X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_POD, scale=0.02))
    frac, resid, _ = report(tag, what + " f64 AA", info, dt, launches, card)
    print(f"    f64 converged_frac at 1e-3: {float((resid < 1e-3).mean()):.4f}; "
          f"|U32 - U64|_inf = {(U32.double() - U).abs().max().item():.3e}")
    require(torch.isfinite(X).all() and torch.isfinite(U).all(),
            f"{what} f64 output is not finite")
    require(frac >= 0.95, f"{what} f64 converged_frac {frac} < 0.95 at 2.5e-3")


def phase_unbounded(dev, card):
    solver, data = podscale(torch.float32, device=dev, bounded=False)
    X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_POD, scale=0.02))
    what = f"unbounded pod-scale shape B={B_POD} (solve_eq)"
    frac, resid, iters = report(7, what + " f32 AA", info, dt, launches, card)
    print(f"    f32 converged_frac at 2.5e-3: {frac:.4f}; at 1e-3: "
          f"{float((resid < 1e-3).mean()):.4f}")
    require(torch.isfinite(X).all() and torch.isfinite(U).all()
            and U.shape == (B_POD, 64, 50, 2),
            "unbounded output is not finite or has the wrong shape")
    # one K4 (2048, 90, 90) and one K2 (32, 10, 10) factor per SCP iteration
    require(only_launched(launches, ("inv_cholesky_big", "inv_cholesky"))
            and launches["inv_cholesky_big"] == launches["inv_cholesky"] == iters.max(),
            f"unbounded launches {launches}: expected K4 == K2 == {iters.max()}")
    pod_f64(7, what, False, U, card)
    return launches


def phase_state_box(dev, card):
    solver, data = flagship(dtype=torch.float32, device=dev, has_x_bounds=True,
                            **dict(HEADLINE_KW, max_it=40))
    x_u = torch.full_like(data.x_u, torch.inf)
    x_u[..., 2] = V_BOX
    stack = stack_varied(data._replace(x_l=-x_u, x_u=x_u), B_FLAGSHIP)
    X, U, info, dt, launches = timed_call(solver, stack)
    frac, _, _ = report(8, f"state box |v| <= {V_BOX}, flagship instance B={B_FLAGSHIP} f32 AA",
                        info, dt, launches, card)
    v = X[:, :, 1:, 2].abs()
    touching = float((v.amax(-1) > V_BOX - 1e-3).float().mean())
    print(f"    max |v| = {v.max().item():.6f}; the box binds on "
          f"{100 * touching:.1f}% of the particles")
    require(torch.isfinite(X).all() and torch.isfinite(U).all(),
            "state-box output is not finite")
    require(frac >= 0.95, f"state-box converged_frac {frac} < 0.95")
    require(v.max().item() <= V_BOX + 1e-3, "the speed box is violated")
    require(touching > 0, "the speed box binds nowhere")
    # the formed Newton blocks go to the factor without a diagonal: two
    # K2-family launches ((2048, 50, 50) and (64, 10, 10)) per IPM iteration
    require(only_launched(launches, ("inv_cholesky",)) and launches["inv_cholesky"] % 2 == 0,
            f"state-box launches {launches}: expected K2 only, twice per iteration")
    return launches


def phase_launched_shapes(dev):
    """Hold against plain whatever the solver phases launched that the
    kernels phase did not check."""
    seen = {("_diag" in name, B, n, dtype) for name, B, n, dtype in chol_inv.SHAPES}
    print(f"[9] the solver phases launched {len(seen)} (kernel, batch, n, dtype) "
          f"shapes; {len(seen - CHECKED)} not yet held against plain")
    for diag, B, n, dtype in sorted(seen - CHECKED, key=str):
        check(diag, *spd_inputs(B, n, dtype, dev))
    require(seen <= CHECKED, "a launched shape was not held against its plain version")


def no_kernel(tag, launches):
    require(only_launched(launches, []),
            f"[{tag}] the Riccati route launched a chol_inv kernel: {launches}")


def phase_riccati_agrees(dev, card):
    """Riccati against condensed on the card in f64: identical Mehrotra
    steps, only the Newton solver differs."""
    kw = dict(max_it=8, res_tol=1e-7, ipm_iters=40, ipm_tol_exp=-10, collect_stats=True,
              adaptive_tol=False, dtype=torch.float64, device=dev)
    out = {}
    for method in ("condensed", "riccati"):
        solver, data = flagship(method=method, **kw)
        out[method] = timed_call(solver, stack_varied(data, B_AGREE))
    (_, Uc, ic, dtc, lc), (Xr, Ur, ir, dtr, lr) = out["condensed"], out["riccati"]
    err = (Ur - Uc).abs().max().item()
    its_c, its_r = (i["scan_stats"]["ipm_iters"] for i in (ic, ir))
    print(f"[10] riccati vs condensed, flagship instance B={B_AGREE} M=32 N=30 Nc=5 f64, "
          f"8 SCP iterations: |U_riccati - U_condensed|_inf = {err:.3e} (tol 1e-7), IPM "
          f"iterations per SCP iteration (lane 0) riccati {its_r[0].tolist()} condensed "
          f"{its_c[0].tolist()}; {dtr * 1e3:.1f} ms/call riccati, {dtc * 1e3:.1f} ms/call "
          f"condensed [{card}]; launches riccati {lr}")
    require(torch.isfinite(Xr).all() and torch.isfinite(Ur).all(),
            "[10] riccati f64 output is not finite")
    require(err <= 1e-7, f"[10] riccati and condensed differ by {err:.3e} > 1e-7 in f64")
    require(torch.equal(its_c, its_r), "[10] riccati and condensed took different IPM "
            "iteration counts")
    require(lc["inv_cholesky_diag"] > 0, "[10] the condensed run launched no K1")
    no_kernel(10, lr)


def phase_riccati_flagship(dev, card, U_condensed):
    solver, data = flagship(dtype=torch.float32, device=dev, method="riccati", **HEADLINE_KW)
    X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_FLAGSHIP))
    frac, _, _ = report(11, f"flagship through the riccati route B={B_FLAGSHIP} M=32 N=30 "
                        "Nc=5 f32 AA", info, dt, launches, card)
    print(f"    max |u| = {U.abs().max().item():.6f}; |U_riccati - U_condensed|_inf = "
          f"{(U - U_condensed).abs().max().item():.3e} (two f32 fixed points at "
          "res_tol=1e-3: reported, not gated)")
    require(torch.isfinite(X).all() and torch.isfinite(U).all()
            and U.shape == (B_FLAGSHIP, 32, 30, 2),
            "[11] riccati flagship output is not finite or has the wrong shape")
    require(frac >= 0.95, f"[11] riccati flagship converged_frac {frac} < 0.95")
    require(U.abs().max().item() <= 1 + 1e-5, "[11] the control box is violated")
    no_kernel(11, launches)


def defect(X, U):
    """Largest per-step violation of the dynamics linearized at the returned
    trajectory itself (there it is x_j - f(x_{j-1}, u_j): how far the
    iterate is from a trajectory of the car), and the lane totals' largest."""
    x0, Xn = X[:, :, 0], X[:, :, 1:]
    f, fx, fu = linearize(dubins, X[:, :, :-1], U)
    total, viols = dynamics_violation(x0, f, fx, fu, Xn, U, Xn, U)
    return viols.max().item(), total.max().item()


def long_call(N, max_it, B, dtype, dev):
    """(X, U, info, seconds, launches) of the long-horizon configuration:
    the one problem as it is (B=1), or stacked to B lanes with varied x0.
    Warmed by one SCP iteration at the same shapes."""
    solver, data = long_horizon(N, dtype, device=dev, max_it=max_it)
    warm_solver, _ = long_horizon(N, dtype, device=dev, max_it=1)
    return timed_call(solver, stack_varied(data, B, scale=0.0 if B == 1 else 0.05),
                      warm_solver)


def phase_long_horizon(dev, card):
    f32 = torch.float32
    for N in (280, 140):
        t = {}
        for max_it in (4, 12):
            X, U, info, t[max_it], launches = long_call(N, max_it, 1, f32, dev)
            worst, total = defect(X, U)
            print(f"[12] long horizon N={N} M=1 f32 riccati (boxes + slew) max_it={max_it}: "
                  f"{t[max_it] * 1e3:.1f} ms/call, scp iters {info['iters'].tolist()}, resid "
                  f"{info['resid'].max().item():.3e}, max |u| {U.abs().max().item():.6f}, "
                  f"max |x| {X.abs().max().item():.4f}, dynamics defect per step max "
                  f"{worst:.3e} (sum {total:.3e}) [{card}]")
            require(torch.isfinite(X).all() and torch.isfinite(U).all()
                    and U.shape == (1, 1, N, 2), f"[12] N={N} output is not finite")
            require(U.abs().max().item() <= 1 + 1e-5, f"[12] N={N}: the control box is violated")
            require(X.abs().max().item() <= X_BOX + 1e-4, f"[12] N={N}: the state box is violated")
            require(worst <= DEFECT_MAX[max_it],
                    f"[12] N={N} max_it={max_it}: dynamics defect {worst:.3e} > "
                    f"{DEFECT_MAX[max_it]:g}")
            no_kernel(12, launches)
            if N == 280 and max_it == 4:
                U32 = U
        print(f"    N={N}: {(t[12] - t[4]) / 8 * 1e3:.1f} ms per SCP iteration "
              f"((t12 - t4) / 8) [{card}]")
    # the same call over 64 lanes: about the same time while launches bound it
    X, U, info, dt, launches = long_call(280, 4, B_FLAGSHIP, f32, dev)
    print(f"[12] long horizon N=280 stacked to B={B_FLAGSHIP}, max_it=4: {dt * 1e3:.1f} ms/call, "
          f"max |u| {U.abs().max().item():.6f}, max |x| {X.abs().max().item():.4f} [{card}]")
    require(torch.isfinite(X).all() and torch.isfinite(U).all(), "[12] B=64 output is not finite")
    require(U.abs().max().item() <= 1 + 1e-5 and X.abs().max().item() <= X_BOX + 1e-4,
            "[12] B=64: a box is violated")
    no_kernel(12, launches)
    X, U, info, dt, launches = long_call(280, 4, 1, torch.float64, dev)
    err = (U32.double() - U).abs().max().item()
    print(f"[12] long horizon N=280 f64, max_it=4: {dt * 1e3:.1f} ms/call; "
          f"|U32 - U64|_inf = {err:.3e} [{card}]")
    require(torch.isfinite(U).all(), "[12] N=280 f64 output is not finite")
    no_kernel(12, launches)


def phase_riccati_podscale(dev, card):
    what = f"pod-scale through the riccati route B={B_POD} M=64 N=50 Nc=5 box"
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        solver, data = podscale(dtype, device=dev, method="riccati")
        warm_solver, _ = podscale(dtype, device=dev, method="riccati", max_it=2)
        X, U, info, dt, launches = timed_call(
            solver, stack_varied(data, B_POD, scale=0.02), warm_solver)
        frac, resid, _ = report(13, f"{what} {name} AA", info, dt, launches, card)
        print(f"    {name} converged_frac at 2.5e-3: {frac:.4f}; at 1e-3: "
              f"{float((resid < 1e-3).mean()):.4f}")
        require(torch.isfinite(X).all() and torch.isfinite(U).all()
                and U.shape == (B_POD, 64, 50, 2),
                f"[13] riccati pod-scale {name} output is not finite or has the wrong shape")
        no_kernel(13, launches)
    require(frac >= 0.95, f"[13] {what} f64 converged_frac {frac} < 0.95 at 2.5e-3")


def phase_config3(dev, card):
    """BASELINE config 3 at its full batch, f32 then f64. Returns the f32
    call's launches."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        solver, data, B = baseline_config(3, dtype, device=dev)
        stack = stack_varied(data, B, scale=0.02)
        # the warm-up: a call that keeps the per-iteration stats (it runs all
        # max_it iterations), for the lanes whose IPM gave up in some SCP
        # iteration
        stats = baseline_config(3, dtype, device=dev, collect_stats=True)[0](stack)[2]
        failed = int(stats["scan_stats"]["ipm_failed"].any(1).sum())
        replays = tracing.COUNTS["ipm_cone_replay"]
        X, U, info, dt, launches = timed_call(solver, stack, warm_solver=lambda _: None)
        replays = tracing.COUNTS["ipm_cone_replay"] - replays
        k5 = hessian_apply.LAUNCHES["hessian_apply"]
        frac, _, _ = report(14, f"config 3 (box +-1, cone ||u_j|| <= {SOC_R3}) B={B} M=1 N=20 "
                            f"{name} AA", info, dt, launches, card)
        u_max, u_norm_max = U.abs().max().item(), U.norm(dim=-1).max().item()
        print(f"    lanes whose IPM gave up in some SCP iteration: {failed}; max |u| "
              f"{u_max:.7f}, max ||u_j|| {u_norm_max:.7f}; K2 (inv_cholesky) launches at "
              f"({B}, 40, 40): {launches['inv_cholesky']}, K5 (hessian_apply) launches: {k5}, "
              f"replays of chunks with cones: {replays}")
        require(torch.isfinite(X).all() and torch.isfinite(U).all()
                and U.shape == (B, 1, 20, 2), f"[14] config 3 {name} output is not finite "
                "or has the wrong shape")
        require(u_max <= 1 + 1e-5, f"[14] config 3 {name}: the control box is violated")
        require(u_norm_max <= SOC_R3 + 1e-4, f"[14] config 3 {name}: the cone is violated")
        # nc = 0 and formed Newton blocks: K2 at (512, 40, 40) alone
        require(only_launched(launches, ("inv_cholesky",))
                and ("inv_cholesky", B, 40, dtype) in chol_inv.SHAPES,
                f"[14] config 3 {name} launches {launches}: expected K2 at ({B}, 40, 40) only")
        # one factored Hessian apply (K5) an IPM iteration, as one K2 factor;
        # the cone IPM replayed as CUDA graphs, not eager
        require(k5 == launches["inv_cholesky"], f"[14] config 3 {name}: K5 launches {k5}, "
                f"expected K2's {launches['inv_cholesky']}")
        require(replays > 0, f"[14] config 3 {name}: no replay of a chunk with cones")
        out[dtype] = (U, frac, launches)
    (U32, _, launches32), (U64, frac64, _) = out[torch.float32], out[torch.float64]
    print(f"    |U32 - U64|_inf = {(U32.double() - U64).abs().max().item():.3e}")
    require(frac64 >= 0.95, f"[14] config 3 f64 converged_frac {frac64} < 0.95")
    return launches32


def phase_soc_agrees(dev, card):
    """The cone-constrained flagship instance through both routes, f64:
    the same Mehrotra steps, only the Newton solver differs."""
    kw = dict(max_it=8, res_tol=1e-7, ipm_iters=40, ipm_tol_exp=-8, collect_stats=True,
              adaptive_tol=False, dtype=torch.float64, device=dev, u_soc_r=SOC_R3)
    out = {}
    for method in ("condensed", "riccati"):
        solver, data = flagship(method=method, **kw)
        out[method] = timed_call(solver, stack_varied(data, B_AGREE))
    (_, Uc, ic, dtc, lc), (Xr, Ur, ir, dtr, lr) = out["condensed"], out["riccati"]
    err = (Ur - Uc).abs().max().item()
    its_c, its_r = (i["scan_stats"]["ipm_iters"] for i in (ic, ir))
    print(f"[15] cone ||u_j|| <= {SOC_R3} on the flagship instance B={B_AGREE} M=32 N=30 Nc=5 "
          f"f64, 8 SCP iterations: |U_riccati - U_condensed|_inf = {err:.3e} (tol 1e-7), "
          f"IPM iterations per SCP iteration (lane 0) riccati {its_r[0].tolist()} condensed "
          f"{its_c[0].tolist()}, equal on {int((its_r == its_c).sum())} of {its_c.numel()}; "
          f"{dtr * 1e3:.1f} ms/call riccati, {dtc * 1e3:.1f} ms/call condensed [{card}]; "
          f"launches condensed {lc}")
    require(torch.isfinite(Xr).all() and torch.isfinite(Ur).all(),
            "[15] riccati f64 output is not finite")
    require(err <= 1e-7, f"[15] riccati and condensed differ by {err:.3e} > 1e-7 in f64")
    require(max(U.norm(dim=-1).max().item() for U in (Uc, Ur)) <= SOC_R3 + 1e-7,
            "[15] the cone is violated")
    require(only_launched(lc, ("inv_cholesky",)), f"[15] condensed launches {lc}: expected K2 only")
    no_kernel(15, lr)


def phase_extra_rows(dev, card):
    """Extra rows that restate control bounds against the same bounds as
    boxes, then the flagship with the single-solve mode and with Gondzio
    correctors."""
    solver, data = flagship(dtype=torch.float64, device=dev)
    st = stack_varied(data, B_AGREE)
    Nc, N, udim, xdim = 5, 30, 2, 4
    Bn, M = st.x0.shape[:2]
    nc, nf = Nc * udim, (N - Nc) * udim
    f, fx, fu = linearize(dubins, torch.cat([st.x0[:, :, None], st.X_prev[:, :, :-1]], 2),
                          st.U_prev)
    cqp = assemble_condensed(st.x0, f, fx, fu, st.X_prev, st.U_prev, st.Q, st.R, st.X_ref,
                             st.U_ref, st.reg_x, st.reg_u, st.slew_reg, st.slew_reg0,
                             st.slew_um1, Nc=Nc)
    one = torch.ones((Bn, M, N * udim), dtype=torch.float64, device=dev)
    box = ipm.BoxBounds(-one[:, 0, :nc], one[:, 0, :nc], -one[:, :, nc:], one[:, :, nc:])
    # the rows' dual accuracy is ~sqrt(tol) (`ipm_core`): 1e-12 for 1e-6 in U
    kw = dict(iters=60, tol_exp=-12)
    uc, uf, _ = ipm.ipm_core(cqp, box, **kw)
    # the six free controls of particle 0 that the box solve pushes most, held
    # to half their value: as tighter boxes, and as rows +-u <= h
    idx = uf[:, 0].abs().topk(6, dim=-1).indices  # (B, 6)
    val = uf[:, 0].gather(-1, idx)
    lo_f, hi_f = box.lo_f.clone(), box.hi_f.clone()
    hi_f[:, 0].scatter_(-1, idx, torch.where(val > 0, 0.5 * val, 1.0))
    lo_f[:, 0].scatter_(-1, idx, torch.where(val < 0, 0.5 * val, -1.0))
    tight = box._replace(lo_f=lo_f, hi_f=hi_f)
    G = torch.zeros((Bn, 6, nc + M * nf + M * N * xdim), dtype=torch.float64, device=dev)
    G.scatter_(-1, (nc + idx)[..., None], torch.sign(val)[..., None])
    rows = ipm.map_extras_rows(cqp, G, 0.5 * val.abs())
    chol_inv.reset_launch_counts()
    uc_b, uf_b, st_b = ipm.ipm_core(cqp, tight, **kw)
    uc_e, uf_e, st_e = ipm.ipm_core(cqp, box, ex=rows, has_ex=True, **kw)
    torch.cuda.synchronize()
    launches = dict(chol_inv.LAUNCHES)
    err = max((uc_e - uc_b).abs().max().item(), (uf_e - uf_b).abs().max().item())
    moved = (uf_b[:, 0].gather(-1, idx) - val).abs().min().item()
    print(f"[16] extra rows restating 6 control bounds (flagship instance, first subproblem, "
          f"B={B_AGREE}, f64): |U_rows - U_boxes|_inf = {err:.3e} (tol 1e-6), IPM iterations "
          f"rows {st_e['iters'].tolist()} boxes {st_b['iters'].tolist()}; the bounds move "
          f"those controls by >= {moved:.3e}; launches {launches}")
    require(st_e["converged"].all() and st_b["converged"].all(), "[16] an IPM did not converge")
    require(err <= 1e-6, f"[16] extra rows and boxes differ by {err:.3e} > 1e-6")
    require(moved > 1e-3, "[16] the restated bounds do not bind")
    require(("inv_cholesky", Bn, 6, torch.float64) in chol_inv.SHAPES,
            "[16] the rows' 6 x 6 Schur system did not go through K2")
    for opt in (dict(ipm_predictor=False), dict(ipm_gondzio=2)):
        solver, data = flagship(dtype=torch.float32, device=dev, **dict(HEADLINE_KW, **opt))
        X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_FLAGSHIP))
        report(16, f"flagship B={B_FLAGSHIP} f32 AA with {opt}", info, dt, launches, card)
        require(torch.isfinite(X).all() and torch.isfinite(U).all()
                and U.abs().max().item() <= 1 + 1e-5,
                f"[16] flagship with {opt}: output not finite or the box is violated")
        require(only_launched(launches, ("inv_cholesky_diag", "inv_cholesky")),
                f"[16] flagship with {opt} launches {launches}: expected K1 and K2")


def cone_call(problems, dev, stats=None):
    """(results, seconds, launches) of one `solve_problems_cone` call, the
    launch counts reset before it and read after it."""
    chol_inv.reset_launch_counts()
    t0 = time.perf_counter()
    out = solve_problems_cone(problems, device=dev, stats=stats)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(chol_inv.LAUNCHES)


def stack_U(out):
    """(B, M, N, udim) controls of a call's results, NaN where a problem failed."""
    shape = next(U.shape for _, U, _ in out if U is not None)
    return np.stack([np.full(shape, np.nan) if U is None else U for _, U, _ in out])


def first_subproblem(problems, dev):
    """The (B, M, ...) tensors of every problem's first SCP subproblem: the
    dynamics linearized at the start (X_prev = X_ref = 0, U_prev = 0, as the
    SCP loop starts), and its numpy copy."""
    cps = [_canon_problem(p) for p in problems]
    keys = ("x0", "Q", "R", "X_ref", "U_ref", "X_prev", "U_prev", "slew_um1")
    probs = {k: torch.from_numpy(np.stack([cp[k] for cp in cps])).to(dev) for k in keys}
    for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0"):
        probs[k] = torch.from_numpy(np.stack([np.full(cps[0]["M"], cp[k]) for cp in cps])).to(dev)
    x_at = torch.cat([probs["x0"][:, :, None], probs["X_prev"][:, :, :-1]], 2)
    f, fx, fu = linearize(dubins, x_at, probs["U_prev"])
    probs.update(f=f, fx=fx, fu=fu)
    return probs, {k: v.cpu().numpy() for k, v in probs.items()}


def particle_costs(p, U):
    """J_i(U) of every particle of every problem in numpy (the rollout and
    cost of tests/test_cvar.py::_particle_cost): p the numpy subproblem
    (B, M, ...), U (B, M, N, udim) -> (B, M)."""
    B, M, N, xdim = p["f"].shape
    xlin = np.concatenate([p["x0"][:, :, None], p["X_prev"][:, :, :-1]], 2)
    x, X = p["x0"], []
    for j in range(N):
        x = p["f"][:, :, j] + np.einsum("bmij,bmj->bmi", p["fx"][:, :, j], x - xlin[:, :, j]) \
            + np.einsum("bmij,bmj->bmi", p["fu"][:, :, j], U[:, :, j] - p["U_prev"][:, :, j])
        X.append(x)
    X = np.stack(X, 2)
    dX, dU = X - p["X_ref"], U - p["U_ref"]
    J = 0.5 * np.einsum("bmni,bmnij,bmnj->bm", dX, p["Q"], dX)
    J += 0.5 * np.einsum("bmni,bmnij,bmnj->bm", dU, p["R"], dU)
    J += 0.5 * p["reg_x"] * ((X - p["X_prev"]) ** 2).sum((2, 3))
    return J + 0.5 * p["reg_u"] * ((U - p["U_prev"]) ** 2).sum((2, 3))


def cvar_oracle(p, b, k, eps=COST_ANCHOR_EPS):
    """Lane b's first subproblem solved by scipy's SLSQP over the epigraph
    v = (u, y, t): min (1+eps) sum y + (1-eps) k t + 0.5e-8 sigma |v|^2 s.t.
    J_i(u) <= y_i + t, y >= 0, u the shared controls (full consensus). The
    last term is the program's own regularization P = 1e-8 I under its
    objective scale sigma = max(1, mean_i J_i(0)) (``compose.py``, both
    packages): without it the optimum moves ~1e-4 in u on this instance.
    J_i is quadratic in u: its Hessian and gradient come from numpy
    rollouts of unit controls."""
    from scipy.optimize import minimize

    _, M, N, udim = p["U_prev"].shape
    n = N * udim
    E = np.eye(n)
    # J_i at 0, at every e_i and at every e_i + e_j, in one batched rollout
    pts = np.concatenate([np.zeros((1, n)), E, (E[:, None] + E[None]).reshape(n * n, n)])
    many = {key: np.broadcast_to(v[b:b + 1], (len(pts),) + v.shape[1:]) for key, v in p.items()}
    Js = particle_costs(many, np.broadcast_to(pts.reshape(-1, 1, N, udim),
                                              (len(pts), M, N, udim)))
    c0, Jp, Jpq = Js[0], Js[1:n + 1], Js[n + 1:].reshape(n, n, M)
    H = Jpq - Jp[:, None] - Jp[None] + c0  # e_i'H e_j
    g = Jp - c0 - 0.5 * np.einsum("iim->im", H)
    J = lambda u: 0.5 * np.einsum("i,ijm,j->m", u, H, u) + u @ g + c0
    dJ = lambda u: np.einsum("ijm,j->im", H, u) + g
    y0 = J(np.zeros(n))
    t0 = np.sort(y0)[-k]
    v0 = np.concatenate([np.zeros(n), np.maximum(y0 - t0, 0.0) + 1e-3, [t0]])
    obj = np.concatenate([np.zeros(n), np.full(M, 1.0 + eps), [(1.0 - eps) * k]])
    cons = [dict(type="ineq", fun=lambda v: v[n:n + M] + v[-1] - J(v[:n]),
                 jac=lambda v: np.concatenate([-dJ(v[:n]).T, np.eye(M), np.ones((M, 1))], 1)),
            dict(type="ineq", fun=lambda v: v[n:n + M],
                 jac=lambda v: np.concatenate([np.zeros((M, n)), np.eye(M),
                                               np.zeros((M, 1))], 1))]
    reg = 1e-8 * max(1.0, float(np.abs(c0).mean()))
    res = minimize(lambda v: obj @ v + 0.5 * reg * v @ v, v0, jac=lambda v: obj + reg * v,
                   constraints=cons, method="SLSQP", options=dict(maxiter=2000, ftol=1e-14))
    return res.x[:n].reshape(N, udim), res


def phase_cvar(dev, card):
    """The batched CVaR program on the card: K2 alone at (64, 45, 45) f64."""
    probs = cvar_batch(B_CONE, M=M_CVAR, k=K_CVAR)
    solve_problems_cone(probs[:B_CHECK], device=dev)  # warm the allocator
    stats = {}
    out, dt, launches = cone_call(probs, dev, stats)
    U = stack_U(out)
    conv = np.array([d is not None and d["converged"] for _, _, d in out])
    its = stats["ipm_iters"]  # (SCP iterations, B)
    per_scp = its.max(1)
    print(f"[17] batched CVaR B={B_CONE} M={M_CVAR} N=20 full consensus k={K_CVAR} f64 on the "
          f"card: {dt * 1e3:.1f} ms/call, converged {int(conv.sum())} of {B_CONE}, SCP "
          f"iterations {out[0][2]['iters'] if out[0][2] else None}, batched IPM iterations per "
          f"SCP iteration median {float(np.median(per_scp))} max {int(per_scp.max())} "
          f"({int(per_scp.sum())} in all) [{card}]; launches {launches}")
    require(conv.sum() >= 0.95 * B_CONE, f"[17] converged {int(conv.sum())} < 0.95 x {B_CONE}")
    require(np.isfinite(U[conv]).all() and U.shape == (B_CONE, M_CVAR, 20, 2),
            "[17] output is not finite or has the wrong shape")
    require(np.ptp(U[conv], axis=1).max() < 1e-8, "[17] full consensus is broken")
    require(only_launched(launches, ("inv_cholesky",))
            and ("inv_cholesky", B_CONE, 45, torch.float64) in chol_inv.SHAPES,
            f"[17] launches {launches}: expected K2 at ({B_CONE}, 45, 45) f64 only")
    cpu = torch.device("cpu")
    out_c, dt_c, _ = cone_call(probs, cpu)
    print(f"    the same call on the host CPU: {dt_c * 1e3:.1f} ms/call, converged "
          f"{sum(d is not None and d['converged'] for _, _, d in out_c)} of {B_CONE} "
          f"(card {dt * 1e3:.1f} ms: {dt_c / dt:.2f}x) [{card}]")
    # the card against the CPU. The SCP loop amplifies rounding: a corrector
    # or step choice that flips on the last bit moves an iterate by ~1e-6
    # (a 1e-15 relative change of x0 does so on the CPU alone), so the full
    # call's U is set by its inputs to ~1e-7 only. Held to 1e-7 with equal
    # IPM counts: every problem's first SCP iteration (one cone solve each);
    # reported: the first B_CHECK problems' full calls, beside the CPU's own
    # spread under that change of x0
    first = [dict(p, max_it=1) for p in probs]
    st_g, st_c = {}, {}
    out1, _, _ = cone_call(first, dev, st_g)
    out1_c, _, _ = cone_call(first, cpu, st_c)
    err1 = np.abs(stack_U(out1) - stack_U(out1_c)).max()
    same = np.array_equal(st_g["ipm_iters"], st_c["ipm_iters"])
    out4, _, _ = cone_call(probs[:B_CHECK], dev)
    err = np.abs(stack_U(out4) - stack_U(out_c[:B_CHECK])).max()
    rng = np.random.default_rng(0)
    nudged = [dict(p, x0=p["x0"] * (1 + 1e-15 * rng.normal(size=p["x0"].shape)))
              for p in probs[:B_CHECK]]
    spread = np.abs(stack_U(cone_call(nudged, cpu)[0]) - stack_U(out_c[:B_CHECK])).max()
    print(f"    card against the CPU, first SCP iteration of all {B_CONE} problems: |dU|_inf = "
          f"{err1:.3e} (tol 1e-7), IPM counts equal: {same}; full calls, card B={B_CHECK} "
          f"against the CPU's first {B_CHECK} problems: {err:.3e}, card B={B_CONE} lanes "
          f"0-{B_CHECK - 1}: {np.abs(U[:B_CHECK] - stack_U(out_c[:B_CHECK])).max():.3e}, the "
          f"CPU against itself with x0 (1 + 1e-15 N(0, 1)): {spread:.3e} (reported)")
    require(err1 <= 1e-7 and same,
            f"[17] first SCP iteration: card and CPU differ by {err1:.3e} (IPM counts equal: "
            f"{same})")
    # the first subproblem of every lane, solved tight
    probs_t, p_np = first_subproblem(probs, dev)
    X1, U1, aux, st, _ = composed_solve_batch_device(
        probs_t, {}, (), {}, (20, 2, 4), (), "", 1.0, 1.0, Nc=20, k=float(K_CVAR),
        eps=COST_ANCHOR_EPS, has_cvar=True, iters=100, tol_exp=-10, kappa=1e-12)
    U1, aux, ok = U1.cpu().numpy(), aux.cpu().numpy(), st["converged"].cpu().numpy()
    U_o, res = cvar_oracle(p_np, 0, K_CVAR)
    err_o = np.abs(U1[0, 0] - U_o).max()
    J = particle_costs(p_np, U1)  # (B, M)
    Js = np.sort(J, axis=1)[:, ::-1]
    obj = (1 + COST_ANCHOR_EPS) * aux[:, :M_CVAR].sum(1) + (1 - COST_ANCHOR_EPS) * K_CVAR \
        * aux[:, M_CVAR]
    ident = (1 + COST_ANCHOR_EPS) * Js[:, :K_CVAR].sum(1) \
        - 2 * COST_ANCHOR_EPS * K_CVAR * Js[:, K_CVAR - 1]
    rel = np.abs(obj - ident) / np.abs(ident)
    print(f"    first subproblem, lane 0 against scipy SLSQP on the epigraph (status "
          f"{res.status}): |U - U_oracle|_inf = {err_o:.3e} (tol 1e-5); the program's "
          f"objective against (1+eps) S_k - 2 eps k J_(k) of the numpy particle costs on "
          f"{int(ok.sum())} converged lanes: max rel {rel[ok].max():.3e} (tol 1e-6)")
    require(res.success and err_o <= 1e-5,
            f"[17] lane 0 is {err_o:.3e} from the scipy oracle (status {res.status})")
    require(ok.sum() >= 0.95 * B_CONE and rel[ok].max() <= 1e-6,
            "[17] the k-worst identity fails on a converged lane")
    return launches


def phase_extras(dev, card):
    """Extras on the composed route: K4 alone at (64, 71, 71) f64; then
    squareplus under control cones, past every hand kernel."""
    probs = extras_batch(B_CONE)
    solve_problems_cone(probs[:B_CHECK], device=dev)
    stats = {}
    out, dt, launches = cone_call(probs, dev, stats)
    U = stack_U(out)
    ok = np.array([d is not None for _, _, d in out])
    conv = np.array([d is not None and d["converged"] for _, _, d in out])
    X = np.stack([X for X, _, _ in out if X is not None])
    dist = np.linalg.norm(X[:, :, 1:, :2] - np.array(KEEP_IN_C), axis=-1)
    print(f"[18] extras B={B_CONE} M=2 N=20 Nc=5 (box, keep-in cone on every position, soft "
          f"bound through an aux slack, Hf) f64: {dt * 1e3:.1f} ms/call, converged "
          f"{int(conv.sum())} of {B_CONE}, SCP iterations {out[0][2]['iters'] if ok[0] else None}"
          f", batched IPM iterations {int(stats['ipm_iters'].max(1).sum())} [{card}]; launches "
          f"{launches}")
    print(f"    max |u| {np.nanmax(np.abs(U)):.9f}, max distance - radius "
          f"{(dist - KEEP_IN_R).max():.3e}; the keep-in cone binds (within 1e-6) at "
          f"{int((dist > KEEP_IN_R - 1e-6).sum())} of {dist.size} (lane, particle, stage)")
    require(conv.sum() >= 0.95 * B_CONE, f"[18] converged {int(conv.sum())} < 0.95 x {B_CONE}")
    require(np.nanmax(np.abs(U)) <= 1 + 1e-6, "[18] the control box is violated")
    require((dist - KEEP_IN_R).max() <= 1e-6, "[18] a keep-in cone is violated")
    require((dist > KEEP_IN_R - 1e-6).any(), "[18] the keep-in cone binds nowhere")
    require(only_launched(launches, ("inv_cholesky_big",))
            and ("inv_cholesky_big", B_CONE, 71, torch.float64) in chol_inv.SHAPES,
            f"[18] launches {launches}: expected K4 at ({B_CONE}, 71, 71) f64 only")
    out4, _, _ = cone_call(probs[:B_CHECK], dev)
    out_c, dt_c, _ = cone_call(probs[:B_CHECK], torch.device("cpu"))
    err = np.abs(stack_U(out4) - stack_U(out_c)).max()
    print(f"    card B={B_CHECK} against the CPU: |dU|_inf = {err:.3e} (tol 1e-7)")
    require(err <= 1e-7, f"[18] card and CPU differ by {err:.3e} > 1e-7")
    sq = extras_batch(B_CONE, squareplus=True)
    solve_problems_cone(sq[:B_CHECK], device=dev)
    out_s, dt_s, launches_s = cone_call(sq, dev)
    conv_s = sum(d is not None and d["converged"] for _, _, d in out_s)
    U_s = stack_U(out_s)
    print(f"[18] squareplus-smoothed boxes under ||u_j|| <= {SOC_R3}, B={B_CONE} M=2 N=20 Nc=5 "
          f"f64 (nv = 210, the library's factor): {dt_s * 1e3:.1f} ms/call, converged {conv_s} "
          f"of {B_CONE}, max ||u_j|| {np.nanmax(np.linalg.norm(U_s, axis=-1)):.9f} [{card}]; "
          f"launches {launches_s}")
    require(only_launched(launches_s, ()), f"[18] squareplus launched {launches_s}")
    require(np.nanmax(np.linalg.norm(U_s, axis=-1)) <= SOC_R3 + 1e-6,
            "[18] squareplus: the control cone is violated")
    require(conv_s >= 0.95 * B_CONE, f"[18] squareplus converged {conv_s} < 0.95 x {B_CONE}")
    return launches


def lane_newton(stats, it=None):
    """Newton steps of every lane of a barrier-method call: in its SCP
    iteration ``it``, or summed over the call's iterations."""
    n = stats["newton_steps"]
    return n[it] if it is not None else n.sum(0)


def card_against_cpu(tag, first, st_g, out_g, dev, single, card):
    """[19]/[20]: the first SCP iteration of the first B_CHECK problems on the
    card (``out_g``, ``st_g``: the card's call over the batch) against the
    same call on the host CPU: U to 1e-6 and, on the lanes whose Newton step
    counts agree, to 1e-8; then one problem's first SINGLE_IT SCP iterations
    on the card against the CPU (reported)."""
    cpu = torch.device("cpu")
    st_c = {}
    out_c, dt_c, _ = cone_call(first[:B_CHECK], cpu, st_c)
    dU = np.abs(stack_U(out_g[:B_CHECK]) - stack_U(out_c)).reshape(B_CHECK, -1).max(1)
    n_g, n_c = lane_newton(st_g, 0)[:B_CHECK], lane_newton(st_c, 0)
    same = n_g == n_c
    print(f"    card against the CPU, first SCP iteration of problems 0-{B_CHECK - 1}: |dU|_inf "
          f"per lane {np.array2string(dU, precision=3)} (tol 1e-6; 1e-8 where the Newton "
          f"counts agree), Newton steps card {n_g.tolist()} CPU {n_c.tolist()}; the CPU took "
          f"{dt_c * 1e3:.1f} ms for the {B_CHECK} problems [{card}]")
    require(dU.max() <= 1e-6 and (dU[same].max(initial=0.0) <= 1e-8),
            f"[{tag}] first SCP iteration: card and CPU differ by {dU.max():.3e} (equal "
            f"Newton counts on {same.tolist()})")
    single = [dict(p, max_it=SINGLE_IT) for p in single]
    out1, dt1, _ = cone_call(single, dev)
    out1c, dt1c, _ = cone_call(single, cpu)
    print(f"    problem 0's first {SINGLE_IT} SCP iterations: card {dt1 * 1e3:.1f} ms, host CPU "
          f"{dt1c * 1e3:.1f} ms, "
          f"SCP iterations {out1[0][2]['iters']} / {out1c[0][2]['iters']}, |dU|_inf = "
          f"{np.abs(stack_U(out1) - stack_U(out1c)).max():.3e} (reported) [{card}]")


def phase_logbarrier(dev, card):
    """[19] logbarrier smoothing of phase 18's extras program: the box rows
    and the extras' linear rows become exponential cones (the barrier
    method, nv = 213: the library's factor, no hand kernel)."""
    probs = extras_batch(B_CONE, smooth_cstr="logbarrier", smooth_alpha=ALPHA_LOG)
    first = [dict(p, max_it=1) for p in probs]
    st1 = {}
    out1, dt1, _ = cone_call(first, dev, st1)  # also the warm-up of the shapes
    stats = {}
    out, dt, launches = cone_call(probs, dev, stats)
    U = stack_U(out)
    conv = np.array([d is not None and d["converged"] for _, _, d in out])
    per_call = lane_newton(stats)
    print(f"[19] logbarrier (alpha {ALPHA_LOG}) on the extras program B={B_CONE} M=2 N=20 "
          f"Nc=5 f64, exp cones in the barrier method (nv = {NV_LOG}): {dt * 1e3:.1f} ms/call, "
          f"converged {int(conv.sum())} of {B_CONE}, SCP iterations "
          f"{out[0][2]['iters'] if out[0][2] else None}, Newton steps a call median "
          f"{float(np.median(per_call))} max {int(per_call.max())} (first SCP iteration "
          f"{dt1 * 1e3:.1f} ms) [{card}]; launches {launches}")
    print(f"    max |u| {np.nanmax(np.abs(U)):.9f}; barrier solves converged in the last SCP "
          f"iteration: {int(stats['ipm_converged'][-1].sum())} of {B_CONE}")
    require(conv.sum() >= 0.95 * B_CONE, f"[19] converged {int(conv.sum())} < 0.95 x {B_CONE}")
    require(np.isfinite(U[conv]).all() and np.nanmax(np.abs(U)) < 1,
            "[19] a control is not strictly inside the box")
    require(stats["ipm_converged"][-1].all(),
            "[19] a barrier solve did not converge in the last SCP iteration")
    require(only_launched(launches, ()), f"[19] nv = {NV_LOG} launched {launches}")
    card_against_cpu(19, first, st1, out1, dev, probs[:1], card)
    return launches


def phase_exp_extras(dev, card):
    """[20] phase 18's extras program plus one user exponential cone per
    particle (the soft terminal-speed limit, `flagship.exp_speed_extras`):
    nv = 73, the barrier method's Newton and phase-I factors through K4."""
    probs = extras_batch(B_CONE, exp_speed=True)
    first = [dict(p, max_it=1) for p in probs]
    st1 = {}
    out1, dt1, _ = cone_call(first, dev, st1)
    stats = {}
    out, dt, launches = cone_call(probs, dev, stats)
    U = stack_U(out)
    conv = np.array([d is not None and d["converged"] for _, _, d in out])
    X = np.stack([X for X, _, _ in out if X is not None])
    dist = np.linalg.norm(X[:, :, 1:, :2] - np.array(KEEP_IN_C), axis=-1)
    per_call = lane_newton(stats)
    print(f"[20] extras with an exp cone per particle (s_m >= exp({EXP_KAPPA} (v_N - "
          f"{EXP_VMAX}))) B={B_CONE} M=2 N=20 Nc=5 f64 (nv = {NV_EXP}): {dt * 1e3:.1f} ms/call, "
          f"converged {int(conv.sum())} of {B_CONE}, SCP iterations "
          f"{out[0][2]['iters'] if out[0][2] else None}, Newton steps a call median "
          f"{float(np.median(per_call))} max {int(per_call.max())} [{card}]; launches {launches}")
    require(conv.sum() >= 0.95 * B_CONE, f"[20] converged {int(conv.sum())} < 0.95 x {B_CONE}")
    require(np.nanmax(np.abs(U)) <= 1 + 1e-6, "[20] the control box is violated")
    require((dist - KEEP_IN_R).max() <= 1e-6, "[20] a keep-in cone is violated")
    require(only_launched(launches, ("inv_cholesky_big",))
            and ("inv_cholesky_big", B_CONE, NV_EXP, torch.float64) in chol_inv.SHAPES,
            f"[20] launches {launches}: expected K4 at ({B_CONE}, {NV_EXP}, {NV_EXP}) f64 only")
    # the exp slacks of every lane's first subproblem, solved on the card
    # (the aux s_m follow the keep-in tuple's one slack)
    probs_t, _ = first_subproblem(probs, dev)
    bounds = {k: torch.from_numpy(np.stack([p[k] for p in probs])).to(dev) for k in ("u_l", "u_u")}
    ec = [p["solver_settings"]["extra_cstrs"] for p in probs]
    canon = [_canon_extras(e, 10 + 2 * 15 * 2 + 2 * 20 * 4) for e in ec]
    sig = canon[0][0]
    ecs = tuple(tuple(torch.from_numpy(np.stack([c[1][i][j] for c in canon])).to(dev)
                      for j in range(5)) for i in range(len(sig)))
    Hf = torch.from_numpy(np.stack([p["solver_settings"]["Hf"] for p in probs])).to(dev)
    X1, U1, aux, st, _ = composed_solve_batch_device(
        probs_t, bounds, ecs, {"Hf": Hf}, (20, 2, 4), sig, "", 1.0, 1.0, Nc=5, tol_exp=-8)
    s_m, v_N = aux[:, 1:3], X1[:, :, -1, 2]
    margin = (torch.log(s_m) - EXP_KAPPA * (v_N - EXP_VMAX)).min().item()
    dU1 = np.abs(U1.cpu().numpy() - stack_U(out1)).max()
    print(f"    first subproblem of every lane: smallest exp-cone margin log(s_m) - kappa "
          f"(v_N - v_max) = {margin:.3e} (>= -1e-9), converged {int(st['converged'].sum())} of "
          f"{B_CONE}, against the SCP call's first iteration |dU|_inf = {dU1:.3e}")
    require(margin >= -1e-9 and bool(st["converged"].all()),
            f"[20] an exp slack leaves its cone by {-margin:.3e}")
    card_against_cpu(20, first, st1, out1, dev, probs[:1], card)
    # lane 0 through the serial composed solve on the card
    p0 = {k: v[:1] for k, v in probs_t.items()}
    keys = ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref", "reg_x",
            "reg_u", "slew_reg", "slew_reg0", "slew_um1")
    cqp = assemble_condensed(*(p0[k] for k in keys), Nc=5)
    H_extra, q_extra = terminal_cross_cost(cqp, N=20, xdim=4, Hf=Hf[:1])
    chol_inv.reset_launch_counts()
    Xs, Us, ds = composed_cone_solve(cqp, 20, 2, 4, probs[0]["u_l"], probs[0]["u_u"], None, None,
                                     ec[0], settings={}, H_extra=H_extra, q_extra=q_extra)
    torch.cuda.synchronize()
    err = np.abs(Us - stack_U(out1)[0]).max()
    print(f"    lane 0's first subproblem through the serial composed_cone_solve on the card: "
          f"exp_device {ds.get('exp_device')}, exp_host_fallback {ds.get('exp_host_fallback')}, "
          f"|U - U_batch lane 0|_inf = {err:.3e} (tol 1e-6); launches {dict(chol_inv.LAUNCHES)}")
    require(ds.get("exp_device") is True and "exp_host_fallback" not in ds and err <= 1e-6,
            f"[20] the serial exp branch: {ds.get('exp_device')}, {err:.3e}")
    return launches


def flagship_U(uc, uf, M, N=30, udim=2):
    nc = uc.shape[-1]
    return torch.cat([uc[:, None].expand(1, M, nc), uf], -1).reshape(M, N, udim).cpu().numpy()


def smoothed_f64(base, reg, ul, uu, Nc, U, method, alpha, dev):
    """The smoothed objective of the f64 subproblem at controls U (M, N, udim)."""
    M, N, udim = U.shape
    nc, nf = Nc * udim, (N - Nc) * udim
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)[None]
    cqp = assemble_condensed(*(T(a) for a in base + reg), Nc=Nc)
    bt = ipm._layout_bounds(ul, uu, None, None, M, N, N * 4, nc, nf, udim, np.float64,
                            device=dev)
    w = T(U).reshape(M, N * udim)
    F = barrier._Smoothed(cqp, bt, method, alpha, 1.0)
    return float(F(w[0, :nc][None, None], w[:, nc:][None, None])[0, 0])


def phase_smooth_newton(dev, card):
    """[21] the smooth-constraint solvers on the headline instance's first
    subproblem (M=32, N=30, Nc=5, box +-1): the structured Newton of
    `barrier_solve_np` (K1 + K2 in its ipm_core warm start, K2 in the Newton),
    L-BFGS, a user cost, the dense CVX / SQP."""
    base64, reg64, ul, uu, Nc = flagship_subproblem(dtype=np.float64)
    M, N = base64[1].shape[:2]
    nc, nf = Nc * 2, (N - Nc) * 2
    out, objs = {}, {}
    for npdt in (np.float32, np.float64):
        cast = lambda t: tuple(np.asarray(a, npdt) for a in t)
        for method, alpha in (("logbarrier", ALPHA_LOG), ("squareplus", ALPHA_SQ)):
            barrier.barrier_solve_np(cast(base64), cast(reg64), ul, uu, None, None, Nc=Nc,
                                     method=method, alpha=alpha, device=dev)  # warm
            chol_inv.reset_launch_counts()
            t0 = time.perf_counter()
            X, U, d = barrier.barrier_solve_np(cast(base64), cast(reg64), ul, uu, None, None,
                                               Nc=Nc, method=method, alpha=alpha, device=dev)
            torch.cuda.synchronize()
            dt, launches = time.perf_counter() - t0, dict(chol_inv.LAUNCHES)
            out[(npdt, method)], objs[(npdt, method)] = U, d["obj"]
            print(f"[21] barrier_solve_np {method} (alpha {alpha}) {npdt.__name__} on the "
                  f"flagship subproblem: {dt * 1e3:.1f} ms/call, obj {d['obj']:.9g}, max |u| "
                  f"{np.abs(U).max():.9f} [{card}]; launches {launches}")
            require(np.isfinite(U).all() and U.dtype == npdt, f"[21] {method} output")
            require(only_launched(launches, ("inv_cholesky_diag", "inv_cholesky"))
                    and ("inv_cholesky", 32, 50, torch.from_numpy(U).dtype) in chol_inv.SHAPES,
                    f"[21] {method} launches {launches}: expected K1 and K2 (32, 50, 50)")
    # f32 against f64. squareplus: the optimum is flat at f32's resolution of
    # an objective near -3.8e4 (the best-of-halvings search stops where f32
    # cannot see a decrease), in the JAX package too (ROADMAP §3 F9): U may
    # stop ~0.1 from the f64 U, so U32 is held by the f64 objective at it,
    # within 1e-6 relative of the f64 optimum, and the f32 objective to 1e-5.
    # logbarrier: the answer is ipm_core's point (R3), f32 at mu 1e-5, f64 at
    # 1e-8: U to 1e-2
    for method in ("logbarrier", "squareplus"):
        e = np.abs(out[(np.float32, method)] - out[(np.float64, method)]).max()
        o32, o64 = objs[(np.float32, method)], objs[(np.float64, method)]
        rel = abs(o32 - o64) / abs(o64) if np.isfinite(o64) else float("nan")
        msg = (f"    {method}: |U32 - U64|_inf = {e:.3e}, objective f32 {o32:.9g} f64 {o64:.9g} "
               f"(rel {rel:.3e})")
        if method == "squareplus":
            excess = (smoothed_f64(base64, reg64, ul, uu, Nc, out[(np.float32, method)],
                                   method, ALPHA_SQ, dev) - o64) / abs(o64)
            print(f"{msg}; f64 objective at U32 {excess:.3e} above the f64 optimum (tol 1e-6)")
            require(rel <= 1e-5 and 0 <= excess <= 1e-6,
                    f"[21] squareplus f32: objective {rel:.3e} from f64, f64 objective at U32 "
                    f"{excess:.3e} above the optimum")
        else:
            print(msg)
            require(e <= 1e-2, f"[21] logbarrier: f32 and f64 differ by {e:.3e}")
    # the logbarrier Newton from barrier_core's own start (the previous
    # controls, 0: strictly inside); barrier_solve_np's start is ipm_core's
    # point, on the box to rounding, where the logbarrier objective is +inf
    # and no step lowers it (the JAX package does the same: ROADMAP §3 R3)
    T = lambda a: torch.as_tensor(np.asarray(a), device=dev)[None]
    cqp = assemble_condensed(*(T(a) for a in base64 + reg64), Nc=Nc)
    bt = ipm._layout_bounds(ul, uu, None, None, M, N, N * 4, nc, nf, 2, np.float64, device=dev)
    chol_inv.reset_launch_counts()
    t0 = time.perf_counter()
    uc, uf, st = barrier.barrier_core(cqp, bt, "logbarrier", ALPHA_LOG, 1.0, True, False,
                                      iters=NEWTON_SMOOTH)
    torch.cuda.synchronize()
    dt, launches = time.perf_counter() - t0, dict(chol_inv.LAUNCHES)
    U_ref = flagship_U(uc, uf, M)
    obj_ref = float(st["obj"][0])
    print(f"    barrier_core logbarrier f64 from the previous controls, {NEWTON_SMOOTH} Newton "
          f"steps: {dt * 1e3:.1f} ms, obj {obj_ref:.9g}, max |u| {np.abs(U_ref).max():.9f} "
          f"(strictly inside) [{card}]; launches {launches}")
    require(np.abs(U_ref).max() < 1 and np.isfinite(obj_ref),
            "[21] the logbarrier Newton is not strictly inside")
    require(launches["inv_cholesky"] == 2 * NEWTON_SMOOTH
            and only_launched(launches, ("inv_cholesky",)),
            f"[21] barrier_core launches {launches}: expected K2 twice a Newton step")
    # L-BFGS on the same program: its logbarrier optimum sits within 1e-4 of
    # the box, so L-BFGS needs thousands of iterations (optax's in the JAX
    # package too: 6.4e-4 from the Newton after 8000 on the CPU)
    t0 = time.perf_counter()
    X, U, d = barrier.barrier_solve_np(base64, reg64, ul, uu, None, None, Nc=Nc,
                                       method="logbarrier", alpha=ALPHA_LOG, device=dev,
                                       settings=dict(solver="LBFGS", max_it=LBFGS_ITERS))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    e, rel = np.abs(U - U_ref).max(), abs(d["obj"] - obj_ref) / abs(obj_ref)
    print(f"    L-BFGS logbarrier f64, M={M}, {LBFGS_ITERS} iterations: {dt * 1e3:.1f} ms "
          f"({dt * 1e3 / LBFGS_ITERS:.3f} ms/iteration), |U - U_newton|_inf = {e:.3e} (tol 5e-3), "
          f"objective {d['obj']:.9g} against {obj_ref:.9g} (rel {rel:.3e}) [{card}]")
    require(np.isfinite(U).all() and np.abs(U).max() < 1 and e <= 5e-3,
            f"[21] L-BFGS: {e:.3e} from the Newton")
    # a quadratic user cost, no bounds, against the exact solve of the
    # equivalently modified QP (Q + cI, X_ref with (Q + cI) X_ref' = Q X_ref + c a)
    c, a = 2.0, 0.3
    t0 = time.perf_counter()
    X, U, d = barrier.barrier_solve_np(base64, reg64, None, None, None, None, Nc=Nc, device=dev,
                                       settings=dict(max_it=COST_ITERS),
                                       extra_obj=lambda X, U: 0.5 * c * ((X - a) ** 2).sum())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    Q = base64[6]
    Qp = Q + c * np.eye(4)
    Xr = np.linalg.solve(Qp, (np.einsum("mnij,mnj->mni", Q, base64[8]) + c * a)[..., None])[..., 0]
    cq = assemble_condensed(*(T(v) for v in base64[:6] + (Qp, base64[7], Xr, base64[9]) + reg64),
                            Nc=Nc)
    _, U_e = recover_XU(cq, *solve_eq(cq), N=N)
    e = np.abs(U - U_e[0].cpu().numpy()).max()
    print(f"    diff_cost_fn 0.5 c |X - a|^2 through L-BFGS ({COST_ITERS} iterations), no bounds: "
          f"{dt * 1e3:.1f} ms, |U - U_exact|_inf = {e:.3e} (tol 2e-3) [{card}]")
    require(e <= 2e-3, f"[21] diff_cost_fn: {e:.3e} from the exact solve")
    # the dense CVX / SQP: time one Hessian of the full problem first
    Mc = 32
    b, r, ul_c, uu_c, _ = flagship_subproblem(M=Mc, dtype=np.float64)
    t0 = time.perf_counter()
    barrier.barrier_solve_np(b, r, ul_c, uu_c, None, None, Nc=Nc, method="logbarrier",
                             alpha=ALPHA_LOG, device=dev, settings=dict(solver="CVX",
                                                                        newton_iters=1))
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    if t_one > 0.5:
        Mc = 8
        print(f"    CVX / SQP: one dense Newton step of the {10 + 32 * 50}-vector took "
              f"{t_one * 1e3:.1f} ms: M cut to {Mc} for them")
        b, r, ul_c, uu_c, _ = flagship_subproblem(M=Mc, dtype=np.float64)
        cq = assemble_condensed(*(T(v) for v in b + r), Nc=Nc)
        bc = ipm._layout_bounds(ul_c, uu_c, None, None, Mc, N, N * 4, nc, nf, 2, np.float64,
                                device=dev)
        ucc, ufc, stc = barrier.barrier_core(cq, bc, "logbarrier", ALPHA_LOG, 1.0, True, False,
                                             iters=NEWTON_SMOOTH)
        U_c = flagship_U(ucc, ufc, Mc)
    else:
        U_c = U_ref
    for solver in ("CVX", "SQP"):
        t0 = time.perf_counter()
        X, U, d = barrier.barrier_solve_np(b, r, ul_c, uu_c, None, None, Nc=Nc,
                                           method="logbarrier", alpha=ALPHA_LOG, device=dev,
                                           settings=dict(solver=solver,
                                                         newton_iters=NEWTON_SMOOTH))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e = np.abs(U - U_c).max()
        print(f"    {solver} logbarrier f64 M={Mc} ({10 + Mc * 50} variables, {NEWTON_SMOOTH} "
              f"steps): {dt * 1e3:.1f} ms, |U - U_barrier_core|_inf = {e:.3e} (tol 1e-6) "
              f"[{card}]")
        require(e <= 1e-6, f"[21] {solver}: {e:.3e} from barrier_core")
    return launches


def phase_riccati_smooth(dev, card):
    """[22] the Riccati smooth Newton (no hand kernel, as in the JAX package):
    against the condensed Newton on [21]'s subproblem in f64, then the
    long-horizon configuration at N = 280 in f32."""
    base, reg, ul, uu, Nc = flagship_subproblem(dtype=np.float64)
    kw = dict(Nc=Nc, method="squareplus", alpha=ALPHA_SQ, beta=1.0,
              settings=dict(newton_iters=25), device=dev)
    barrier.riccati_barrier_solve_np(base, reg, ul, uu, None, None, **kw)
    chol_inv.reset_launch_counts()
    t0 = time.perf_counter()
    Xr, Ur, dr = barrier.riccati_barrier_solve_np(base, reg, ul, uu, None, None, **kw)
    torch.cuda.synchronize()
    dt, launches = time.perf_counter() - t0, dict(chol_inv.LAUNCHES)
    Xc, Uc, dc = barrier.barrier_solve_np(base, reg, ul, uu, None, None, **kw)
    eU, eX = np.abs(Ur - Uc).max(), np.abs(Xr - Xc).max()
    print(f"[22] Riccati squareplus (alpha {ALPHA_SQ}) f64 on the flagship subproblem: "
          f"{dt * 1e3:.1f} ms/call, against the condensed Newton |dU|_inf = {eU:.3e}, |dX|_inf "
          f"= {eX:.3e} (tol 1e-5) [{card}]; launches {launches}")
    require(eU <= 1e-5 and eX <= 1e-5, f"[22] Riccati and condensed differ by {eU:.3e}")
    no_kernel(22, launches)
    b, r, ul, uu, xl, xu = long_horizon_subproblem(280)
    lkw = dict(Nc=0, method="squareplus", alpha=20.0, beta=200.0, device=dev)
    barrier.riccati_barrier_solve_np(b, r, ul, uu, xl, xu, settings=dict(newton_iters=2), **lkw)
    chol_inv.reset_launch_counts()
    t0 = time.perf_counter()
    X, U, d = barrier.riccati_barrier_solve_np(b, r, ul, uu, xl, xu,
                                               settings=dict(newton_iters=15), **lkw)
    torch.cuda.synchronize()
    dt, launches = time.perf_counter() - t0, dict(chol_inv.LAUNCHES)
    print(f"[22] long horizon N=280 (M=1, box +-1, state box +-{X_BOX}, slew 0.1) f32, squareplus "
          f"(alpha 20, beta 200), 15 Newton steps: {dt * 1e3:.1f} ms/call, max |u| "
          f"{np.abs(U).max():.6f}, max |x| {np.abs(X).max():.6f}, dtype {U.dtype} [{card}]; "
          f"launches {launches}")
    require(np.isfinite(U).all() and np.isfinite(X).all() and U.dtype == np.float32,
            "[22] long horizon: output not finite or not f32")
    require(np.abs(U).max() <= 1 + 1e-2 and np.abs(X).max() <= X_BOX + 1e-2,
            "[22] long horizon: a smoothed box is not respected")
    no_kernel(22, launches)


def flagship_arrays(M=32, N=30, dtype=np.float64):
    """The headline instance (seed-0 x0, Q = I, R = 1e-2 I, box +-1) as the
    numpy arrays of the host frontend: (Q, R, x0, box)."""
    xdim, udim = 4, 2
    x0 = _x0_seed0(M, xdim, torch.float64).astype(dtype)
    Q = np.tile(np.eye(xdim, dtype=dtype), (M, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(dtype), (M, N, 1, 1))
    return Q, R, x0, np.ones((M, N, udim), dtype)


def stage_cone_extras(M, N, Nc, r, xdim=4, udim=2):
    """The cone ||u_j|| <= r on every stage as `extra_cstrs` SOC blocks over
    the full consensus layout (rows [0; -u_j] against h = [r; 0]), the
    encoding `extras.split_stage_u_cones` recognizes, plus one linear row
    that never binds (the first stage's control sum at most 10)."""
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    starts = [j * udim for j in range(Nc)] + [nc + i * nf + k * udim
                                               for i in range(M) for k in range(N - Nc)]
    G = np.zeros((len(starts), udim + 1, n_full))
    for c, s0 in enumerate(starts):
        G[c, 1:, s0:s0 + udim] = -np.eye(udim)
    h = np.zeros((len(starts), udim + 1))
    h[:, 0] = r
    soc = (0, [udim + 1] * len(starts), 0, G.reshape(-1, n_full), np.zeros((G.size // n_full, 0)),
           h.reshape(-1), np.zeros(n_full), np.zeros(0))
    g = np.zeros((1, n_full))
    g[0, :udim] = 1.0
    lin = (1, [], 0, g, np.zeros((1, 0)), np.array([10.0]), np.zeros(n_full), np.zeros(0))
    return [soc, lin]


def host_call(f_fn, Q, R, x0, **kw):
    """One `pmpc_tpu_torch.solve` with the launch counts set to 0 before it:
    (X, U, data, seconds, launches)."""
    chol_inv.reset_launch_counts()
    t0 = time.perf_counter()
    X, U, data = pmpc_tpu_torch.solve(f_fn, Q, R, x0, verbose=False, **kw)
    torch.cuda.synchronize()
    return X, U, data, time.perf_counter() - t0, dict(chol_inv.LAUNCHES)


def phase_host_frontend(dev, card):
    """[23] The host frontend (`pmpc_tpu_torch.solve`, the dispatcher and its
    host IPM entry points) on the card, its numbers beside the card's name and limit."""
    Nc, M, N = 5, 32, 30
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
    Q, R, x0, box = flagship_arrays(M, N)
    base = dict(u_l=-box, u_u=box, reg_x=1.0, reg_u=0.1, device=dev)
    tight = dict(Nc=Nc, dtype=np.float64, ipm_iters=60, ipm_tol_exp=-10)
    # (a) the host loop against the fused solver, f64, tight IPM solves
    X, U, data, dt, launches = host_call(f_fn, Q, R, x0, max_it=HOST_IT, res_tol=0.0,
                                         solver_settings=tight, **base)
    solver, one = flagship(M=M, N=N, Nc=Nc, max_it=HOST_IT, dtype=torch.float64, res_tol=0.0,
                           ipm_iters=60, ipm_tol_exp=-10, adaptive_tol=False, device=dev)
    _, U_f, _ = solver(stack_varied(one, 1, scale=0.0))
    err = (U_f[0].cpu().numpy() - U).__abs__().max()
    print(f"[23] (a) solve() on the flagship instance (M={M}, N={N}, Nc={Nc}, box +-1, f64, "
          f"{HOST_IT} SCP iterations, tight IPM): {dt * 1e3:.1f} ms, IPM iterations "
          f"{[d['ipm_iters'] for d in data['solver_data']]}; |U_host - U_fused|_inf = "
          f"{err:.3e} (tol 5e-5); launches {launches}; {card}")
    require(err < 5e-5, f"[23] host and fused solves differ by {err:.3e} >= 5e-5")
    require(launches["inv_cholesky_diag"] > 0 and launches["inv_cholesky"] > 0,
            f"[23] solve() did not launch K1 and K2: {launches}")
    # (b) the same instance in f32 and f64 at res_tol 1e-3
    U_by = {}
    for dtype in (np.float64, np.float32):
        args = flagship_arrays(M, N, dtype)
        X, U, data, dt, launches = host_call(
            f_fn, *args[:3], max_it=25, res_tol=1e-3, u_l=-args[3], u_u=args[3], reg_x=1.0,
            reg_u=0.1, device=dev, solver_settings=dict(Nc=Nc, dtype=dtype))
        its = len(data["hist"])
        resid = data["hist"][-1]["resid"]
        U_by[dtype] = U
        print(f"[23] (b) solve() {np.dtype(dtype).name} at res_tol 1e-3: converged "
              f"{resid <= 1e-3} (resid {resid:.3e}), {its} SCP iterations, {dt * 1e3:.1f} ms a "
              f"call, {1e3 * np.mean(data['t_aff_solve']):.2f} ms a subproblem "
              f"(t_aff_solve), {1e3 * dt / its:.2f} ms an SCP iteration; launches {launches}; "
              f"{card}")
        require(np.isfinite(U).all() and np.abs(U).max() <= 1 + 1e-5,
                f"[23] (b) {np.dtype(dtype).name}: output not finite or the box is violated")
    print(f"[23] (b) |U32 - U64|_inf = {np.abs(U_by[np.float32] - U_by[np.float64]).max():.3e}")
    # (c) config 5's width through solve(): nf = 90 blocks (K3), then unbounded (K4)
    Q5, R5, _, box5 = flagship_arrays(64, 50)
    x05 = np.ones((64, 4))
    for bounded, name in ((True, "inv_cholesky_diag_big"), (False, "inv_cholesky_big")):
        kw5 = dict(u_l=-box5, u_u=box5) if bounded else {}
        X, U, data, dt, launches = host_call(f_fn, Q5, R5, x05, max_it=3, res_tol=0.0,
                                             reg_x=1.0, reg_u=0.1, device=dev,
                                             solver_settings=dict(Nc=Nc, dtype=np.float64),
                                             **kw5)
        print(f"[23] (c) solve() at config 5's width (M=64, N=50, Nc=5, f64, "
              f"{'box +-1' if bounded else 'unbounded'}, 3 SCP iterations): {dt * 1e3:.1f} ms; "
              f"launches {launches}; {card}")
        require(launches[name] > 0 and np.isfinite(U).all(),
                f"[23] (c) solve() did not launch {name} or returned non-finite controls")
    # (d) control cones through solve(): the condensed cone route (K2); then
    # the same cones as extra_cstrs SOC blocks plus a linear row, detected
    # and kept on the structured route. tau 0.95: at 0.99 the cold first
    # subproblem crawls to the cap at tight tolerances (ROADMAP §3 F5, F7)
    cone_ipm = dict(tight, ipm_tol_exp=-11, ipm_iters=100, ipm_tau=0.95)
    cone = dict(cone_ipm, u_soc_r=np.full((M, N), SOC_R3))
    X, U, data, dt, launches = host_call(f_fn, Q, R, x0, max_it=3, res_tol=0.0,
                                         solver_settings=cone, **base)
    norm = np.linalg.norm(U, axis=-1).max()
    print(f"[23] (d) solve() with ||u_j|| <= {SOC_R3} (f64, 3 SCP iterations, tau 0.95): "
          f"{dt * 1e3:.1f} "
          f"ms, IPM iterations {[d['ipm_iters'] for d in data['solver_data']]}, max ||u_j|| "
          f"{norm:.9f}; launches {launches}; {card}")
    require(norm <= SOC_R3 + 1e-6 and launches["inv_cholesky"] > 0,
            f"[23] (d) cone violated ({norm}) or K2 not launched ({launches})")
    real = compose.composed_cone_solve

    def refuse(*a, **k):
        raise AssertionError("stage cone extras went to the composed program")

    compose.composed_cone_solve = refuse
    try:
        ex = dict(cone_ipm, extra_cstrs=stage_cone_extras(M, N, Nc, SOC_R3))
        X2, U2, data2, dt, launches = host_call(f_fn, Q, R, x0, max_it=3, res_tol=0.0,
                                                solver_settings=ex, **base)
    finally:
        compose.composed_cone_solve = real
    err = np.abs(U2 - U).max()
    structured = all(len(d["solver_state"]["ipm_warm"]) == 6 for d in data2["solver_data"])
    print(f"[23] (d) the same cones as extra_cstrs (+ a linear row): structured route "
          f"{structured}, {dt * 1e3:.1f} ms, |U - U_(d)|_inf = {err:.3e} (tol 1e-6)")
    require(structured and err <= 1e-6, f"[23] (d) extras route: structured {structured}, "
            f"|dU| {err:.3e}")
    # (e) the long-horizon configuration with no method: the auto-route to the
    # Riccati IPM (no kernel), f32
    NL = 280
    QL, RL, _, boxL = flagship_arrays(1, NL, np.float32)
    xl = np.full((1, NL, 4), X_BOX, np.float32)
    kwL = dict(u_l=-boxL, u_u=boxL, x_l=-xl, x_u=xl, reg_x=1.0, reg_u=0.1, slew_rate=0.1,
               res_tol=1e-9, device=dev, solver_settings=dict(dtype=np.float32))
    host_call(f_fn, QL, RL, np.ones((1, 4), np.float32), max_it=1, **kwL)  # warm-up
    X, U, data, dt, launches = host_call(f_fn, QL, RL, np.ones((1, 4), np.float32),
                                         max_it=4, **kwL)
    routed = all("riccati_warm" in d["solver_state"] for d in data["solver_data"])
    print(f"[23] (e) solve() at N={NL} (M=1, box +-1, state box +-{X_BOX}, slew 0.1, f32, "
          f"4 SCP iterations, no method): Riccati route {routed}, {dt * 1e3:.1f} ms, "
          f"{1e3 * dt / len(data['hist']):.1f} ms an SCP iteration "
          f"({1e3 * np.mean(data['t_aff_solve']):.1f} ms a subproblem), IPM iterations "
          f"{[d['ipm_iters'] for d in data['solver_data']]}; launches {launches}; {card}")
    require(routed, "[23] (e) the long horizon did not auto-route to the Riccati IPM")
    no_kernel(23, launches)
    require(np.abs(U).max() <= 1 + 1e-5 and np.abs(X).max() <= X_BOX + 1e-4,
            "[23] (e) a control or state box is violated")
    # then the flagship instance through method="riccati": linear extra rows
    # restating the first consensus stage's bounds at +-0.3 against the same
    # bounds as boxes
    nc, nf = Nc * 2, (N - Nc) * 2
    n_full = nc + M * nf + M * N * 4
    G = np.zeros((4, n_full))
    G[[0, 1], [0, 1]], G[[2, 3], [0, 1]] = 1.0, -1.0
    rows = [(4, [], 0, G, np.zeros((4, 0)), np.full(4, 0.3), np.zeros(n_full), np.zeros(0))]
    ric = dict(tight, ipm_tol_exp=-12, ipm_iters=80, method="riccati")
    tight_box = box.copy()
    tight_box[:, 0] = 0.3
    out = {}
    for name, kw in (("rows", dict(base, solver_settings=dict(ric, extra_cstrs=rows))),
                     ("boxes", dict(base, u_l=-tight_box, u_u=tight_box,
                                    solver_settings=ric))):
        out[name] = host_call(f_fn, Q, R, x0, max_it=3, res_tol=0.0, **kw)
    err = np.abs(out["rows"][1] - out["boxes"][1]).max()
    binds = np.abs(out["boxes"][1][0, 0]).max()
    print(f"[23] (e) method='riccati' on the flagship instance (f64, 3 SCP iterations): rows "
          f"{out['rows'][3] * 1e3:.1f} ms, boxes {out['boxes'][3] * 1e3:.1f} ms, "
          f"|U_rows - U_boxes|_inf = {err:.3e} (tol 1e-6), max |u_0| {binds:.6f}; "
          f"launches rows {out['rows'][4]}")
    require(err <= 1e-6, f"[23] (e) Riccati extra rows and boxes differ by {err:.3e} > 1e-6")
    require(abs(binds - 0.3) < 1e-6, "[23] (e) the restated bounds do not bind")


# ---- phase 24: batched serving -------------------------------------------------------

B_SERVE, N_SERVE, IT_SERVE = 1000, 20, 60  # (a); 25 SCP iterations converge 17 of 1000 in f64
SERVE_SAMPLES = (0, 499, 999)  # (a): the problems held against their serial solves
SERVE_TOL = 1e-4  # (a): |U_fused - U_serial|, two SCP stops at res_tol 1e-5
IT_CONE_SERVE = 50  # (b): at config 3's 25 (it has AA, this route none) ~3% stop short
B_AGREE_STRUCT = 8  # (b): the structured route against the composed one
B_FLAG_SERVE = 64  # (c): problems of the flagship's width


def served_problems(B, f_fn, dtype, max_it, res_tol, seed=24):
    """(a): B single-particle Dubins problems (N = 20, box +-1, Q = I, R =
    1e-2 I, the JAX API's default regularization) with x0 = ones + 0.2 N(0, 1)
    from ``seed``, as problem dicts of `solve_problems`."""
    N, xdim, udim = N_SERVE, 4, 2
    x0 = (np.ones(xdim) + 0.2 * np.random.default_rng(seed).normal(size=(B, xdim))).astype(dtype)
    Q = np.tile(np.eye(xdim, dtype=dtype), (N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(dtype), (N, 1, 1))
    box = np.ones((N, udim), dtype)
    return [dict(f_fx_fu_fn=f_fn, Q=Q, R=R, x0=x0[i], u_l=-box, u_u=box, max_it=max_it,
                 res_tol=res_tol, solver_settings=dict(dtype=dtype)) for i in range(B)]


def serve_call(problems, dev, **kw):
    """One `solve_problems` with the launch counts set to 0 before it:
    (out, seconds, launches, the launches by (name, batch, n, dtype))."""
    chol_inv.reset_launch_counts()
    before = chol_inv.SHAPES.copy()
    t0 = time.perf_counter()
    out = pmpc_tpu_torch.solve_problems(problems, device=dev, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, dict(chol_inv.LAUNCHES), chol_inv.SHAPES - before


def stack_out(out):
    """The per-problem (X, U, data) of a batch as stacked (U, converged, resid)."""
    U = np.stack([u for _, u, _ in out])
    conv = np.array([d["converged"] for _, _, d in out])
    return U, conv, np.array([d["resid"] for _, _, d in out])


def decades(resid):
    """How many residuals fall in each decade [1e-k, 1e-k+1), k = 12..1."""
    edges = list(range(-12, 1))
    counts = np.histogram(np.log10(np.maximum(resid, 1e-300)), bins=edges)[0]
    return {f"1e{a}": int(c) for a, c in zip(edges[:-1], counts) if c}


def phase_serving_fused(dev, card):
    """[24] (a) the reference's GPU demo batch: 1000 single-particle problems
    through the fused route, f64 and f32, then three of them against their
    serial solves, then the stacked host route. Returns the K1 launches at
    (1000, 40, 40) of the f64 and the f32 call."""
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        warmup.warm_fused(N_SERVE, B_SERVE, 0, 2, True, False, 0, device=dev, dtype=dtype)
    print(f"[24] (a) warmup.warm_fused at M={B_SERVE}, N={N_SERVE} (f64, f32): "
          f"{time.perf_counter() - t0:.1f} s")
    by = {}
    for dtype, res_tol in ((np.float64, 1e-5), (np.float32, 1e-3)):
        name = np.dtype(dtype).name
        probs = served_problems(B_SERVE, f_fn, dtype, IT_SERVE, res_tol)
        out, dt, launches, shapes = serve_call(probs, dev, fused=True)
        U, conv, resid = stack_out(out)
        its = out[0][2]["iters"]
        print(f"[24] (a) solve_problems(fused=True) B={B_SERVE} N={N_SERVE} box +-1 {name} "
              f"res_tol {res_tol:g} max_it {IT_SERVE}: {dt * 1e3:.1f} ms a call, converged "
              f"{conv.sum()} of {B_SERVE} ({conv.sum() / dt:.1f} converged solves/s), "
              f"{its} SCP iterations (one scenario: every problem runs to the slowest), "
              f"final residuals by decade {decades(resid)}; launches {launches} [{card}]")
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        require(np.isfinite(U).all() and U.shape == (B_SERVE, N_SERVE, 2)
                and np.abs(U).max() <= 1 + 1e-5,
                f"[24] (a) {name}: output not finite, of the wrong shape or off the box")
        require(only_launched(launches, ("inv_cholesky_diag",))
                and shapes[("inv_cholesky_diag", B_SERVE, 40, tdt)] > 0,
                f"[24] (a) {name}: expected K1 alone at ({B_SERVE}, 40, 40): {launches}")
        by[dtype] = (probs, U, conv, shapes[("inv_cholesky_diag", B_SERVE, 40, tdt)])
    probs64, U64, conv64, _ = by[np.float64]
    require(conv64.sum() >= 0.95 * B_SERVE,
            f"[24] (a) f64 converged {conv64.sum()} < 0.95 x {B_SERVE}")
    print(f"    |U32 - U64|_inf = {np.abs(by[np.float32][1] - U64).max():.3e}")
    for i in SERVE_SAMPLES:
        X_s, U_s, _ = pmpc_tpu_torch.solve(**dict(probs64[i], verbose=False, device=dev))
        err = np.abs(U_s - U64[i]).max()
        print(f"    problem {i}: |U_fused - U_serial solve|_inf = {err:.3e} (tol {SERVE_TOL:g})")
        require(err <= SERVE_TOL, f"[24] (a) problem {i}: fused and serial differ by {err:.3e}")
    # the stacked host route: the batch as the particle axis of one host solve
    stacked = [dict(p, max_it=5, res_tol=0.0) for p in probs64]
    out, dt, launches, _ = serve_call(stacked, dev)
    n_it = len(out[0][2]["hist"])
    print(f"[24] (a) solve_problems (stacked host route) B={B_SERVE} f64, {n_it} SCP "
          f"iterations: {dt * 1e3:.1f} ms a call, {1e3 * dt / n_it:.1f} ms an SCP iteration "
          f"({1e3 * np.mean(out[0][2]['t_aff_solve']):.1f} ms a subproblem); launches "
          f"{launches} [{card}]")
    require(n_it == 5 and np.isfinite(np.stack([u for _, u, _ in out])).all()
            and launches["inv_cholesky_diag"] > 0,
            f"[24] (a) the stacked route ran {n_it} iterations or launched no K1: {launches}")
    return {np.dtype(dt).name: by[dt][3] for dt in by}


def served_cone_problems(B, f_fn, dtype, max_it, res_tol, seed=1, **ss):
    """(b): config 3's instance as B problem dicts (one car, M = 1, N = 20,
    box +-1, x0 = ones + 0.02 N(0, 1) from ``seed``) with ||u_j|| <= 0.9 as
    per-stage SOC extra_cstrs plus one linear row."""
    M, N, xdim, udim = 1, N_SERVE, 4, 2
    x0 = np.ones((B, M, xdim)) + 0.02 * np.random.default_rng(seed).normal(size=(B, M, xdim))
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    box = np.ones((M, N, udim))
    ex = stage_cone_extras(M, N, 0, SOC_R3)
    return [dict(f_fx_fu_fn=f_fn, Q=Q, R=R, x0=x0[i], u_l=-box, u_u=box, reg_x=1.0,
                 reg_u=0.1, max_it=max_it, res_tol=res_tol,
                 solver_settings=dict(dtype=dtype, extra_cstrs=ex, **ss)) for i in range(B)]


def served_structured(problems, dev):
    """`solve_problems(fused=True)` of cone-featured problems that must take
    the structured route: any use of the composed cone program raises, and
    the cone batcher's stats are kept. `serve_call`'s results and the
    stats."""
    real_prog, real_batch, stats = compose.composed_solve_batch_device, \
        conebatch.solve_problems_cone, {}

    def refuse(*a, **k):
        raise AssertionError("a structured signature built the composed cone program")

    compose.composed_solve_batch_device = conebatch.composed_solve_batch_device = refuse
    conebatch.solve_problems_cone = lambda *a, **k: real_batch(*a, stats=stats, **k)
    try:
        res = serve_call(problems, dev, fused=True)
    finally:
        compose.composed_solve_batch_device = conebatch.composed_solve_batch_device = real_prog
        conebatch.solve_problems_cone = real_batch
    return res + (stats,)


def phase_serving_cones(dev, card):
    """[24] (b) config 3's width as a served batch on the structured route,
    f32 and f64, then the structured route against the composed one at
    B = 8. Returns the f64 call's K2 launches at (512, 40, 40)."""
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
    B = B_CONFIG3
    out_by = {}
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        probs = served_cone_problems(B, f_fn, dtype, IT_CONE_SERVE, 1e-3)
        served_structured([dict(p, max_it=2) for p in probs[:4]], dev)  # the warm-up
        out, dt, launches, shapes, stats = served_structured(probs, dev)
        ok = [o for o in out if o[1] is not None]
        U = np.stack([u for _, u, _ in ok])
        conv = np.array([d["converged"] for _, _, d in ok])
        hist = np.bincount(stats["scp_iters"])
        print(f"[24] (b) solve_problems(fused=True) (structured route {stats['structured']}) B={B} "
              f"M=1 N={N_SERVE} box +-1, ||u_j|| <= {SOC_R3} as SOC extras + a linear row, "
              f"{name}: {dt * 1e3:.1f} ms a call, converged {conv.sum()} of {B} "
              f"({conv.sum() / dt:.1f} converged solves/s), failed {B - len(ok)}, "
              f"{len(stats['t_step'])} SCP iterations; problems by SCP iterations run "
              f"{ {i: int(c) for i, c in enumerate(hist) if c} }; IPM iterations a call "
              f"(max over lanes) {stats['ipm_iters'].max(1).tolist()}; launches {launches} "
              f"[{card}]")
        norm, u_max = np.linalg.norm(U, axis=-1).max(), np.abs(U).max()
        row = U[:, 0, 0].sum(-1).max()
        print(f"    max |u| {u_max:.7f}, max ||u_j|| {norm:.7f}, max sum(u_0) {row:.4f} "
              f"(row <= 10)")
        require(stats["structured"] and len(ok) == B and np.isfinite(U).all(),
                f"[24] (b) {name}: not the structured route, or failed problems")
        require(u_max <= 1 + 1e-5 and norm <= SOC_R3 + 1e-4 and row <= 10 + 1e-5,
                f"[24] (b) {name}: box {u_max}, cone {norm} or row {row} violated")
        require(shapes[("inv_cholesky", B, 40, tdt)] > 0 and launches["inv_cholesky_diag"] == 0,
                f"[24] (b) {name}: K2 not at ({B}, 40, 40) or K1 launched: {launches}")
        out_by[dtype] = (U, conv, shapes[("inv_cholesky", B, 40, tdt)])
    U32, _, _ = out_by[np.float32]
    U64, conv64, launches64 = out_by[np.float64]
    require(conv64.sum() >= 0.95 * B, f"[24] (b) f64 converged {conv64.sum()} < 0.95 x {B}")
    print(f"    |U32 - U64|_inf = {np.abs(U32 - U64).max():.3e}")
    # the structured route against the composed cone program, f64, 25 SCP
    # iterations of tight subproblem solves each, the JAX API's default
    # regularization (reg_u 1e-2), at tau 0.95: the tau the JAX structured
    # route runs with cones. At the IPM's default 0.99 (F5) lane 1's
    # subproblem of SCP iteration 8 crawls to a cap of 100 and ends with mu
    # 1.065e-8, above the hard-fail line 1e-8, so the lane freezes and the
    # routes end 1.0e-1 apart on the H100; the same subproblem does so on
    # the CPU and with the plain factor, and at 0.95 the JAX IPM crawls on
    # it as the port's does (163 iterations): ROADMAP §3 F13,
    # `python3 -m pmpc_tpu_torch.ipm_crawl`, tests/test_torch_ipm_crawl.py.
    tight = dict(ipm_tol_exp=-10, ipm_iters=200, ipm_tau=0.95)
    probs = [{k: v for k, v in p.items() if k not in ("reg_x", "reg_u")}
             for p in served_cone_problems(B_AGREE_STRUCT, f_fn, np.float64, 25, 0.0,
                                           **tight)]
    out_s, t_s, _, _, _ = served_structured(probs, dev)
    composed = [dict(p, solver_settings=dict(p["solver_settings"], extras_structured=False))
                for p in probs]
    out_c, t_c, _, _ = serve_call(composed, dev, fused=True)
    err = max(np.abs(a[1] - b[1]).max() for a, b in zip(out_s, out_c))
    print(f"[24] (b) B={B_AGREE_STRUCT} f64, 25 SCP iterations, ipm_tol_exp -10, tau 0.95, reg_u 1e-2: structured "
          f"{t_s * 1e3:.1f} ms ({out_s[0][2]['iters']} SCP iterations), composed "
          f"{t_c * 1e3:.1f} ms ({out_c[0][2]['iters']}); |U_structured - U_composed|_inf = "
          f"{err:.3e} (tol 1e-6) [{card}]")
    require(err <= 1e-6, f"[24] (b) structured and composed routes differ by {err:.3e}")
    return launches64


def phase_serving_flagship(dev, card):
    """[24] (c) B = 64 problems of the flagship's width (M = 32, N = 30,
    Nc = 5, box +-1) with one linear row each, on the structured route."""
    M, N, Nc, xdim, udim = 32, 30, 5, 4, 2
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
    Q, R, x0, box = flagship_arrays(M, N)
    rng = np.random.default_rng(5)
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    g = np.zeros((1, n_full))
    g[0, :udim] = 1.0
    rhs = -1.0 - 0.2 * rng.random(B_FLAG_SERVE)  # sum(u_0) <= rhs: binds
    ss = dict(Nc=Nc, dtype=np.float64, ipm_tol_exp=-10, ipm_iters=60)
    probs = [dict(f_fx_fu_fn=f_fn, Q=Q, R=R, x0=x0 + 0.05 * rng.normal(size=x0.shape),
                  u_l=-box, u_u=box, reg_x=1.0, reg_u=0.1, max_it=40, res_tol=1e-3,
                  solver_settings=dict(ss, extra_cstrs=[(1, [], 0, g, np.zeros((1, 0)),
                                                         np.array([rhs[i]]), np.zeros(n_full),
                                                         np.zeros(0))]))
             for i in range(B_FLAG_SERVE)]
    out, dt, launches, shapes, stats = served_structured(probs, dev)
    ok = [o for o in out if o[1] is not None]
    U = np.stack([u for _, u, _ in ok])
    conv = np.array([d["converged"] for _, _, d in ok])
    cons = np.ptp(U[:, :, :Nc], axis=1).max()
    row = (U[:, 0, 0].sum(-1) - rhs[:len(ok)]).max()
    print(f"[24] (c) solve_problems(fused=True) B={B_FLAG_SERVE} M={M} N={N} Nc={Nc} box +-1 + one "
          f"binding row, f64 (structured route {stats['structured']}): {dt * 1e3:.1f} ms a "
          f"call, converged {conv.sum()} of {B_FLAG_SERVE}, {len(stats['t_step'])} SCP "
          f"iterations, consensus spread {cons:.3e}, max row excess {row:.3e}; launches "
          f"{launches} [{card}]")
    require(len(ok) == B_FLAG_SERVE and np.abs(U).max() <= 1 + 1e-6,
            "[24] (c) a problem failed or left the box")
    require(cons <= 1e-6 and row <= 1e-6, f"[24] (c) consensus {cons} or row {row} violated")
    require(shapes[("inv_cholesky_diag", B_FLAG_SERVE * M, 50, torch.float64)] > 0
            and shapes[("inv_cholesky", B_FLAG_SERVE, 10, torch.float64)] > 0,
            f"[24] (c) K1 not at (2048, 50, 50) or K2 not at (64, 10, 10): {launches}")
    i = B_FLAG_SERVE // 4
    _, U_s, _ = pmpc_tpu_torch.solve(**dict(probs[i], verbose=False, device=dev))
    err = np.abs(U_s - U[i]).max()
    print(f"    problem {i}: |U_batched - U_serial solve|_inf = {err:.3e} (tol 1e-6)")
    require(err <= 1e-6, f"[24] (c) problem {i}: batched and serial differ by {err:.3e}")
    return launches


def phase_serving_sensitivity(dev, card):
    """[24] (d) `sensitivity_L` at t = 0 on one flagship-instance particle
    (N = 30, box +-1 under logbarrier alpha 100, f64) at the smoothed
    problem's optimum: the card's gain against the CPU's."""
    N, xdim, udim, alpha = 30, 4, 2, 100.0
    Q, R, x0, box = flagship_arrays(1, N)
    # the smoothed problem's SCP fixed point through `solve` (the dispatcher's
    # logbarrier route) on the card, then Newton on the smoothed objective
    # there until its gradient is at rounding level
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
    t0 = time.perf_counter()
    _, U_np, data = pmpc_tpu_torch.solve(
        f_fn, Q[0], R[0], x0[0], u_l=-box[0], u_u=box[0], max_it=60, res_tol=1e-6,
        verbose=False, device=dev, solver_settings=dict(smooth_cstr="logbarrier",
                                                         smooth_alpha=alpha, dtype=np.float64))
    t_solve = time.perf_counter() - t0
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    prob = sensitivity.SensProblem(x0=t(x0[0]), Q=t(Q[0]), R=t(R[0]), X_ref=zeros(N, xdim),
                                   U_ref=zeros(N, udim), u_l=-t(box[0]), u_u=t(box[0]),
                                   smooth_alpha=alpha)
    obj = lambda U: sensitivity._smooth_objective(dubins, prob, U, prob.x0, zeros(N, xdim),
                                                  zeros(N))
    grad = torch.func.grad(obj)
    U, r0, steps = t(U_np), None, 0
    for steps in range(10):
        g = grad(U).reshape(-1)
        r0 = g.abs().max().item() if r0 is None else r0
        if g.abs().max().item() < 1e-11:
            break
        H = torch.func.jacrev(grad)(U).reshape(N * udim, N * udim)
        U = U - torch.linalg.solve(H, g).reshape(N, udim)
    r = sensitivity.optimality_residual(dubins, prob, U).abs().max().item()
    X = sensitivity.nonlinear_rollout(dubins, prob.x0, U)
    cpu = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    L_cpu = sensitivity.sensitivity_L(dubins, sensitivity.SensProblem(*map(cpu, prob)),
                                      U.cpu(), X.cpu())
    sensitivity.sensitivity_L(dubins, prob, U, X)  # the warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L = sensitivity.sensitivity_L(dubins, prob, U, X)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = (L.cpu() - L_cpu).abs().max().item()
    print(f"[24] (d) solve() with logbarrier alpha {alpha:g} on one flagship particle (N={N}, "
          f"box +-1, f64): {len(data['hist'])} SCP iterations, {t_solve * 1e3:.1f} ms, "
          f"|grad|_inf {r0:.2e}; {steps} Newton steps on the card to {r:.2e}; "
          f"sensitivity_L t=0: {dt * 1e3:.1f} ms on the card, |L_card - L_cpu|_inf = "
          f"{err:.3e} (tol 1e-8), |L|_inf {L_cpu.abs().max().item():.3f} [{card}]")
    require(r < 1e-10, f"[24] (d) the smoothed problem's optimum was not reached: {r:.2e}")
    require(L.shape == (N, udim, xdim) and L.device.type == "cuda" and err <= 1e-8,
            f"[24] (d) the card's gain differs from the CPU's by {err:.3e}")


S_STREAM, B_STREAM, N_STREAM, CHUNK_STREAM = 512, 64, 20, 4  # phase 25 (a)
IT_STREAM, TOL_STREAM = 200, 1e-5  # (a): a problem's budget and res_tol
STREAM_SPREAD = (0.05, 0.1, 0.2, 0.4)  # (a): x0 noise scales, cycled: mixed difficulty
N_PRIC = 280  # (c): the long horizon, M = 1
B_SHARD = 8  # (d): the flagship's batch on the meshes


def stream_x0(S, seed=25):
    """(a): S single-car x0 = ones + s N(0, 1), s cycling over STREAM_SPREAD."""
    scale = np.array(STREAM_SPREAD)[np.arange(S) % len(STREAM_SPREAD)]
    return np.ones((S, 4)) + scale[:, None] * np.random.default_rng(seed).normal(size=(S, 4))


def phase_stream(dev, card):
    """[25] (a) lane refill: S_STREAM single-particle Dubins problems at
    config 3's width (N=20, box +-1) through `stream.solve_stream` on
    B_STREAM lanes, f64, against the same solver run to the batch maximum:
    all of them as one S_STREAM-lane batch (every problem held to 1e-7 with
    its own count: a lane freezes at its count, so it computes what its
    problem computes alone), and as S_STREAM / B_STREAM batches of B_STREAM
    lanes, each timed (and held the same way); then all of them as one fused
    scenario (`solve_problems(fused=True)`, every problem runs to the
    slowest; reported). Returns the stream call's K1 launches at
    (B_STREAM, 40, 40)."""
    from pmpc_tpu_torch.flagship import _instance
    from pmpc_tpu_torch.stream import _stack, solve_stream
    from pmpc_tpu_torch.tracing import COUNTS

    f64 = torch.float64
    solver = pmpc_tpu_torch.build_scp_solver(
        dubins, N=N_STREAM, xdim=4, udim=2, M=1, Nc=0, max_it=IT_STREAM, res_tol=TOL_STREAM,
        has_u_bounds=True)
    x0 = stream_x0(S_STREAM)
    stream = [_instance(x0[i:i + 1], N_STREAM, 2, f64, dev) for i in range(S_STREAM)]
    pool = _stack(stream)
    batches = [_stack(stream[i:i + B_STREAM]) for i in range(0, S_STREAM, B_STREAM)]
    # short calls of the same shapes first
    for d in (batches[0], pool):
        solver.rebuild(max_it=2)(d)
    torch.cuda.synchronize()

    def run_to_max(d):
        r0, t0 = COUNTS["host_read"], time.perf_counter()
        _, U, info = solver(d)
        torch.cuda.synchronize()
        return (U[:, 0].cpu().numpy(), info["iters"].cpu().numpy(),
                time.perf_counter() - t0, COUNTS["host_read"] - r0 + 1)

    st = {}
    chol_inv.reset_launch_counts()
    before = chol_inv.SHAPES.copy()
    t0 = time.perf_counter()
    out = solve_stream(solver, stream, B=B_STREAM, chunk_it=CHUNK_STREAM, max_it=IT_STREAM,
                       stats=st)
    torch.cuda.synchronize()
    t_stream, launches = time.perf_counter() - t0, dict(chol_inv.LAUNCHES)
    k1 = (chol_inv.SHAPES - before)[("inv_cholesky_diag", B_STREAM, 2 * N_STREAM, f64)]
    its = np.array([o[2]["iters"] for o in out])
    conv = np.array([o[2]["converged"] for o in out])
    U_s = np.stack([o[1][0] for o in out])
    U_w, it_w, t_wide, reads_wide = run_to_max(pool)
    per = [run_to_max(d) for d in batches]
    U_b, it_b = np.concatenate([r[0] for r in per]), np.concatenate([r[1] for r in per])
    t_batches, reads_batches = sum(r[2] for r in per), sum(r[3] for r in per)
    err_w, same_w = float(np.abs(U_w - U_s).max()), bool((it_w == its).all())
    err_b, same_b = float(np.abs(U_b - U_s).max()), bool((it_b == its).all())
    # the lanes' idle share: lane-iterations that advance no unfinished problem
    idle_stream = 1.0 - its.sum() / st["lane_slots"]
    per_batch = its.reshape(-1, B_STREAM).max(-1)
    idle_batches = 1.0 - its.sum() / (B_STREAM * per_batch.sum())
    idle_wide = 1.0 - its.sum() / (S_STREAM * its.max())
    print(f"[25] (a) solve_stream S={S_STREAM} B={B_STREAM} chunk_it={CHUNK_STREAM} N={N_STREAM} "
          f"box +-1 f64 res_tol {TOL_STREAM:g}: {t_stream * 1e3:.1f} ms a call, converged "
          f"{conv.sum()} of {S_STREAM}, SCP iterations per problem min {its.min()} median "
          f"{float(np.median(its))} max {its.max()} (sum {its.sum()}), {st['rounds']} chunks, "
          f"lanes idle {idle_stream:.4f}, host reads {st['host_reads']}; launches {launches} "
          f"[{card}]")
    print(f"    run to the batch maximum, one batch of {S_STREAM}: {t_wide * 1e3:.1f} ms, "
          f"lanes idle {idle_wide:.4f}, {reads_wide} host reads, |U_batch - U_stream|_inf = "
          f"{err_w:.3e} (tol 1e-7), counts equal {same_w}")
    print(f"    run to the batch maximum, {S_STREAM // B_STREAM} batches of {B_STREAM} "
          f"(batch maxima {per_batch.tolist()}): {t_batches * 1e3:.1f} ms in all (each "
          f"{[round(r[2] * 1e3, 1) for r in per]}), lanes idle {idle_batches:.4f}, "
          f"{reads_batches} host reads, |U_batch - U_stream|_inf = {err_b:.3e} (tol 1e-7), "
          f"counts equal {same_b}")
    require(conv.mean() >= 0.95 and np.isfinite(U_s).all() and np.abs(U_s).max() <= 1 + 1e-6,
            f"[25] (a) the stream converged {conv.sum()} of {S_STREAM} or left the box")
    require(err_w <= 1e-7 and same_w,
            f"[25] (a) a stream problem differs from its lane of the {S_STREAM}-lane batch: "
            f"{err_w:.3e}, counts equal {same_w}")
    require(err_b <= 1e-7 and same_b,
            f"[25] (a) a stream problem differs from its lane of the {B_STREAM}-lane batches: "
            f"{err_b:.3e}, counts equal {same_b}")
    require(only_launched(launches, ("inv_cholesky_diag",)) and k1 > 0,
            f"[25] (a) expected K1 alone at ({B_STREAM}, 40, 40): {launches}")
    # the same problems as one fused scenario, each running to the slowest
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device=dev)
    Q, R = np.tile(np.eye(4), (N_STREAM, 1, 1)), np.tile(1e-2 * np.eye(2), (N_STREAM, 1, 1))
    box = np.ones((N_STREAM, 2))
    probs = [dict(f_fx_fu_fn=f_fn, Q=Q, R=R, x0=x0[i], u_l=-box, u_u=box, reg_x=1.0,
                  reg_u=0.1, max_it=IT_STREAM, res_tol=TOL_STREAM,
                  solver_settings=dict(dtype=np.float64)) for i in range(S_STREAM)]
    pmpc_tpu_torch.solve_problems([dict(p, max_it=1) for p in probs], fused=True, device=dev)
    r0 = COUNTS["host_read"]
    out_f, t_fused, launches_f, _ = serve_call(probs, dev, fused=True)
    reads_fused = COUNTS["host_read"] - r0 + 1
    U_f, conv_f, _ = stack_out(out_f)
    it_f = out_f[0][2]["iters"]
    idle_fused = 1.0 - its.sum() / (S_STREAM * it_f)
    diff = np.abs(U_f - U_s).max(axis=(1, 2))
    print(f"    solve_problems(fused=True), the {S_STREAM} problems as one scenario: "
          f"{t_fused * 1e3:.1f} ms a call, {it_f} SCP iterations, converged {conv_f.sum()}, "
          f"lanes idle {idle_fused:.4f} (against each problem's own count), host reads "
          f"{reads_fused}; |U_fused - U_stream|_inf = {diff.max():.3e} (problems within 1e-7: "
          f"{int((diff <= 1e-7).sum())}, within 1e-4: {int((diff <= 1e-4).sum())}: the fused "
          f"IPM's steps and stop are the scenario's, so a slowly converging problem stops "
          f"elsewhere within the SCP tolerance); launches {launches_f} [{card}]")
    print(f"    lane refill against run-to-max: stream {t_stream * 1e3:.1f} ms, one batch of "
          f"{S_STREAM} {t_wide * 1e3:.1f} ms, batches of {B_STREAM} {t_batches * 1e3:.1f} ms, "
          f"fused {t_fused * 1e3:.1f} ms")
    require(conv_f.mean() >= 0.95 and np.isfinite(U_f).all(),
            f"[25] (a) the fused call converged {conv_f.sum()} of {S_STREAM}")
    return k1


def phase_relin_stale(dev, card):
    """[25] (b) relin_stale 0 against 1 on the headline program (f32, B=64),
    relin_stale=1 at the headline's 25 sub-steps and at the 27 that
    benchmarks/ab_stale.py gives it."""
    for rs, max_it in ((0, 25), (1, 25), (1, 27)):
        kw = dict(HEADLINE_KW, max_it=max_it)
        solver, data = flagship(dtype=torch.float32, device=dev, relin_stale=rs, **kw)
        X, U, info, dt, launches = timed_call(solver, stack_varied(data, B_FLAGSHIP))
        report("25", f"(b) flagship B={B_FLAGSHIP} f32 AA relin_stale={rs} max_it={max_it}",
               info, dt, launches, card)
        require(torch.isfinite(U).all() and U.abs().max() <= 1 + 1e-4
                and launches["inv_cholesky_diag"] > 0,
                f"[25] (b) relin_stale={rs}: output not finite or off the box, or no K1")


def device_kernels(fn):
    """The kernels one call of ``fn`` runs on the card (torch.profiler, the
    device's activity only)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_priccati(dev, card):
    """[25] (c) the associative-scan Riccati route against the sequential one,
    unbounded, f64: the long horizon (M=1, N=N_PRIC) and the headline width
    (B=64, M=32, N=30, Nc=5). Each runs exactly 1 and 3 SCP iterations (the
    tolerance is out of reach): ms and kernels per SCP iteration from their
    difference."""
    from pmpc_tpu_torch.flagship import _instance

    f64 = torch.float64
    for what, M, N, Nc, B in ((f"M=1 N={N_PRIC}", 1, N_PRIC, 0, 1),
                              ("flagship width M=32 N=30 Nc=5", 32, 30, 5, B_FLAGSHIP)):
        data = stack_varied(_instance(_x0_seed0(M, 4, f64), N, 2, f64, dev, bounded=False), B)
        res, U = {}, {}
        for method in ("riccati", "priccati"):
            per = {}
            for it in (1, 3):
                solver = pmpc_tpu_torch.build_scp_solver(
                    dubins, N=N, xdim=4, udim=2, M=M, Nc=Nc, max_it=it, res_tol=0.0,
                    method=method)
                _, U[method], _, dt, launches = timed_call(solver, data)
                per[it] = (dt, device_kernels(lambda: solver(data)))
                no_kernel("25", launches)
            ms = (per[3][0] - per[1][0]) / 2 * 1e3
            kern = (per[3][1] - per[1][1]) / 2
            res[method] = (ms, kern)
        err = float((U["priccati"] - U["riccati"]).abs().max())
        print(f"[25] (c) unbounded {what} B={B} f64, 3 SCP iterations: |U_priccati - "
              f"U_riccati|_inf = {err:.3e} (tol 1e-8); a SCP iteration: riccati "
              f"{res['riccati'][0]:.2f} ms, {res['riccati'][1]:.0f} kernels; priccati "
              f"{res['priccati'][0]:.2f} ms, {res['priccati'][1]:.0f} kernels [{card}]")
        require(err <= 1e-8 and torch.isfinite(U["priccati"]).all(),
                f"[25] (c) {what}: priccati and riccati differ by {err:.3e}")


def phase_sharded(dev, card):
    """[25] (d) `parallel.make_sharded_solver`: the headline program at B=8 on
    an NCCL group of world size 1 against the plain solver (f32), then two
    ranks spawned on this card over gloo, meshes 1 x 2 and 2 x 1 built from
    default arguments (each rank checks that its shard lies on the card),
    f64, against the unsharded solver (`parallel.check`). Returns the ranks'
    launches by shape."""
    import torch.distributed as dist

    from pmpc_tpu_torch.parallel import check, make_mesh, make_sharded_solver, \
        shard_batched_data
    from pmpc_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"tcp://localhost:{check._free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(1, 1)
        solver, data = flagship(dtype=torch.float32, device=dev, **HEADLINE_KW)
        batch = stack_varied(data, B_SHARD)
        fn = make_sharded_solver(solver, mesh)
        _, U_p, info_p = solver(batch)
        _, U, info, dt, launches = timed_call(fn, shard_batched_data(batch, mesh))
        err = float((U - U_p).abs().max())
        print(f"[25] (d) make_sharded_solver on NCCL, world size 1, mesh 1 x 1: flagship "
              f"B={B_SHARD} f32 {dt * 1e3:.1f} ms a call, |U - U_plain|_inf = {err:.3e}, "
              f"counts equal {bool((info['iters'] == info_p['iters']).all())}; launches "
              f"{launches} [{card}]")
        require(err <= 1e-7 and bool((info["iters"] == info_p["iters"]).all())
                and launches["inv_cholesky_diag"] > 0,
                f"[25] (d) NCCL world 1: the sharded solver differs by {err:.3e}")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    rep, logs = check.run(2, "gloo", "1x2,2x1", "cuda", B=B_SHARD, tol=1e-7, timeout=400)
    if rep is None:
        print("\n".join(f"--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs)))
    meshes = {name: m["flagship"] for name, m in (rep or {}).get("meshes", {}).items()}
    require(rep is not None and all(m["ok"] for m in meshes.values()),
            "[25] (d) two gloo ranks on one card: a mesh disagrees with the unsharded solver")
    if rep is not None:
        print(f"[25] (d) each rank's launched shapes against the plain versions: "
              f"{rep['kernels_vs_plain']}")
        require(rep["kernels_ok"], "[25] (d) a rank's kernel disagrees with its plain version")
    shapes = {}
    for name, m in meshes.items():
        print(f"[25] (d) 2 ranks on cuda:0 over gloo, mesh {name}: flagship B={B_SHARD} f64, "
              f"M_local {m['M_local']}, |(U, X) - unsharded|_inf = {m['max_abs_err']:.3e} "
              f"(tol 1e-7), counts equal {m['iters_equal']}, converged {m['converged']} of "
              f"{B_SHARD}, ms a call per rank {[round(v, 1) for v in m['ms_per_rank']]}, "
              f"launches per rank {m['launches_per_rank']} [{card}]")
        shapes[name] = m["launches_per_rank"][0]
    print(f"    [25] (d) the spawned ranks took {time.perf_counter() - t0:.1f} s")
    r0 = shapes.get("1x2", {})
    require(r0.get(shape_key("inv_cholesky_diag", K1_SHARD), 0) > 0
            and r0.get(shape_key("inv_cholesky", K2_SHARD), 0) > 0,
            f"[25] (d) rank 0 of the 1 x 2 mesh did not launch K1 at {K1_SHARD} and K2 at "
            f"{K2_SHARD}: {r0}")
    return shapes


B_CPU_LANES = 8  # phase 26: the first lanes of each config held against the CPU
TIMED = set()  # (kernel name, batch, n, dtype) timed in phase 3 or after 27


def shapes_since(before):
    """The launches by (kernel name, batch, n, dtype) since ``before``, a copy
    of `chol_inv.SHAPES`."""
    return dict(chol_inv.SHAPES - before)


def fmt_shapes(by_shape):
    return ", ".join(f"{k[0]} ({k[1]}, {k[2]}, {k[2]}) {str(k[3])[6:]}: {v}"
                     for k, v in sorted(by_shape.items(), key=str)) or "none"


def first_lanes(data, n):
    return pmpc_tpu_torch.SCPData(*(None if a is None else a[:n] for a in data))


def phase_baseline_configs(dev, card, shapes):
    """[26] BASELINE configs 1, 2 and 4 (`flagship.baseline_config`: the
    Dubins car at N=20, unbounded, `solve_eq`) at their batches, f32 then f64,
    each warmed; the launches by shape go into ``shapes``."""
    what = {1: "single car M=1", 2: "consensus M=10 Nc=1", 4: "obstacle lin_cost_fn M=1"}
    for k in (1, 2, 4):
        out = {}
        for dtype in (torch.float32, torch.float64):
            name = str(dtype)[6:]
            solver, data, B = baseline_config(k, dtype, device=dev)
            stack = stack_varied(data, B, scale=0.02)
            solver(stack)  # the warm-up
            torch.cuda.synchronize()
            before = chol_inv.SHAPES.copy()
            X, U, info, dt, launches = timed_call(solver, stack, warm_solver=lambda _: None)
            by_shape = shapes_since(before)
            frac, _, _ = report(26, f"config {k} ({what[k]}) B={B} N=20 {name} AA", info, dt,
                                launches, card)
            spread = float((U[:, :, :1].amax(1) - U[:, :, :1].amin(1)).max())
            print(f"    launches by shape: {fmt_shapes(by_shape)}"
                  + (f"; consensus spread of u_0 over the particles {spread:.3e}"
                     if k == 2 else ""))
            for key, v in by_shape.items():
                shapes.setdefault(key, []).append((f"26 config {k} {name}", v))
            M = data.x0.shape[0]
            require(torch.isfinite(X).all() and torch.isfinite(U).all()
                    and U.shape == (B, M, 20, 2),
                    f"[26] config {k} {name} output is not finite or has the wrong shape")
            # unbounded: the arrow factor of `solve_eq`, no diagonal: K2 alone
            require(only_launched(launches, ("inv_cholesky",)),
                    f"[26] config {k} {name} launches {launches}: expected K2 only")
            out[dtype] = (U, frac, spread, stack)
        (U32, _, spread32, _), (U64, frac64, spread64, stack64) = \
            out[torch.float32], out[torch.float64]
        print(f"    config {k}: |U32 - U64|_inf = {(U32.double() - U64).abs().max().item():.3e}"
              + (f"; spread f32 {spread32:.3e}, f64 {spread64:.3e} (gate 1e-6)" if k == 2
                 else ""))
        require(frac64 >= 0.95, f"[26] config {k} f64 converged_frac {frac64} < 0.95")
        if k == 2:
            require(spread64 <= 1e-6, f"[26] config 2 f64 consensus spread {spread64:.3e}")
        # the first lanes on the card and on the CPU (the plain factors), f64
        solver_c, data_c, _ = baseline_config(k, torch.float64, device="cpu")
        _, U_c, info_c = solver_c(first_lanes(stack_varied(data_c, B, scale=0.02),
                                              B_CPU_LANES))
        _, U_g, info_g = baseline_config(k, torch.float64, device=dev)[0](
            first_lanes(stack64, B_CPU_LANES))
        err = float((U_g.cpu() - U_c).abs().max())
        same = bool((info_g["iters"].cpu() == info_c["iters"]).all())
        print(f"    config {k}, first {B_CPU_LANES} lanes f64, card against CPU: "
              f"|dU|_inf = {err:.3e} (tol 1e-7), SCP counts equal {same}")
        require(err <= 1e-7, f"[26] config {k}: card and CPU differ by {err:.3e}")


def scalars(res, prefix=""):
    """The numbers of an example's returned dict (arrays left out), flat."""
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update(scalars(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = v
        elif isinstance(v, (list, tuple)) and all(isinstance(x, (int, float)) for x in v):
            out[prefix + k] = list(v)
    return out


def phase_examples(dev, card, shapes):
    """[27] the five example twins (`pmpc_tpu_torch.examples`) at their full
    sizes on the card: each timed, its returned numbers printed, its own
    checks gated (an AssertionError in its main), the launches by shape into
    ``shapes``."""
    import os

    from pmpc_tpu_torch.examples import (arbitrary_constraints, batch_solver, custom_cost,
                                         receding_horizon, simple_demo)

    os.environ.pop("PMPC_EXAMPLES_FAST", None)
    os.environ.pop("PMPC_RH_HOST", None)
    for name, mod, kw in (("simple_demo", simple_demo, {}), ("batch_solver", batch_solver, {}),
                          ("custom_cost", custom_cost, {}),
                          ("receding_horizon", receding_horizon, dict(run_host=True)),
                          ("arbitrary_constraints", arbitrary_constraints, {})):
        print(f"[27] {name}:")
        before = chol_inv.SHAPES.copy()
        chol_inv.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = mod.main(device=dev, **kw)
        except AssertionError as e:
            require(False, f"[27] {name}: its own check failed: {e}")
            continue
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_shape, nums = shapes_since(before), scalars(res)
        for key, v in by_shape.items():
            shapes.setdefault(key, []).append((f"27 {name}", v))
        print(f"[27] {name} on the card: {dt:.1f} s; returned {json.dumps(nums)}; launches "
              f"{dict(chol_inv.LAUNCHES)}, by shape {fmt_shapes(by_shape)} [{card}]")
        require(all(np.isfinite(v).all() for v in nums.values()),
                f"[27] {name}: a returned number is not finite")
        require(sum(chol_inv.LAUNCHES.values()) > 0, f"[27] {name} launched no hand kernel")
        if name == "batch_solver":
            key = ("inv_cholesky_diag",) + K1_SERVE + (torch.float32,)
            require(by_shape.get(key, 0) > 0,
                    f"[27] batch_solver: no K1 at {K1_SERVE} f32 on the fused batch")
        if name == "receding_horizon":
            require(res["fused"]["err_final"] < res["fused"]["err_start"]
                    and res["host"]["err_final"] < res["host"]["err_start"],
                    "[27] receding_horizon: a closed loop did not reduce its tracking error")


def phase_new_shapes(dev, card, shapes):
    """Time every (kernel, batch, n, dtype) that phases 26 and 27 launched and
    phase 3 did not time, beside its launches per call."""
    new = sorted((k for k in shapes if k not in TIMED), key=str)
    print(f"[26-27] {len(new)} launched shapes not timed in phase 3")
    for key in new:
        name, B, n, dtype = key
        calls = "; ".join(f"{tag}: {v}" for tag, v in shapes[key])
        time_shape(name, "_diag" in name, B, n, dtype, dev, card, {},
                   note=f"; launches a call: {calls}")


def shape_key(name, shape, dtype="float64"):
    """`parallel.check`'s key of a launch shape."""
    B, n = shape
    return f"{name} ({B}, {n}, {n}) {dtype}"


def main():
    card = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with matmul_precision_scope():
        phase_build()
        kern = phase_kernels(dev, card)
        k5 = phase_hessian_apply(dev, card)
        chol_inv.SHAPES.clear()
        phase_probe(dev)
        flagship_launches, U_flagship = phase_flagship(dev, card)
        launches = {"flagship": flagship_launches,
                    "podscale": phase_podscale(dev, card),
                    "unbounded": phase_unbounded(dev, card),
                    "state_box": phase_state_box(dev, card)}
        phase_launched_shapes(dev)
        phase_riccati_agrees(dev, card)
        phase_riccati_flagship(dev, card, U_flagship)
        phase_long_horizon(dev, card)
        phase_riccati_podscale(dev, card)
        config3 = phase_config3(dev, card)
        phase_soc_agrees(dev, card)
        phase_extra_rows(dev, card)
        cvar = phase_cvar(dev, card)
        extras = phase_extras(dev, card)
        phase_launched_shapes(dev)
        t0 = time.perf_counter()
        phase_logbarrier(dev, card)
        print(f"    [19] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        exp_extras = phase_exp_extras(dev, card)
        print(f"    [20] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        smooth = phase_smooth_newton(dev, card)
        print(f"    [21] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_riccati_smooth(dev, card)
        print(f"    [22] took {time.perf_counter() - t0:.1f} s")
        phase_launched_shapes(dev)
        t0 = time.perf_counter()
        phase_host_frontend(dev, card)
        print(f"    [23] took {time.perf_counter() - t0:.1f} s")
        phase_launched_shapes(dev)
        t0, serving = time.perf_counter(), {}
        for part, phase in (("fused", phase_serving_fused), ("cones", phase_serving_cones),
                            ("flagship", phase_serving_flagship),
                            ("sensitivity", phase_serving_sensitivity)):
            t1 = time.perf_counter()
            serving[part] = phase(dev, card)
            print(f"    [24] {part} took {time.perf_counter() - t1:.1f} s")
        print(f"    [24] took {time.perf_counter() - t0:.1f} s")
        phase_launched_shapes(dev)
        t0 = time.perf_counter()
        for part, phase in (("stream", phase_stream), ("relin_stale", phase_relin_stale),
                            ("priccati", phase_priccati), ("sharded", phase_sharded)):
            t1 = time.perf_counter()
            serving[part] = phase(dev, card)
            print(f"    [25] {part} took {time.perf_counter() - t1:.1f} s")
        print(f"    [25] took {time.perf_counter() - t0:.1f} s")
        phase_launched_shapes(dev)
        t0, new_shapes = time.perf_counter(), {}
        phase_baseline_configs(dev, card, new_shapes)
        print(f"    [26] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_examples(dev, card, new_shapes)
        print(f"    [27] took {time.perf_counter() - t0:.1f} s")
        phase_new_shapes(dev, card, new_shapes)
        phase_launched_shapes(dev)
    # the state-box phase launches K2 twice per IPM iteration, once at each shape
    wide, cone, cvar_shape, smooth_shape, served_cone, shard_k2 = \
        kern["inv_cholesky"]["other_shapes"]
    wide["launches"] = launches["state_box"]["inv_cholesky"] // 2
    cone["launches"] = config3["inv_cholesky"]
    cvar_shape["launches"] = cvar["inv_cholesky"]
    # barrier_core's Newton step: one K2 at (32, 50, 50), one at (1, 10, 10)
    smooth_shape["launches"] = smooth["inv_cholesky"] // 2
    # phase 24: K2 at (512, 40, 40) f64 on the structured route, K1 at
    # (1000, 40, 40) on the fused route, per call, counted by shape
    served_cone["launches"] = serving["cones"]
    serve64, serve32, stream_k1, shard_k1 = kern["inv_cholesky_diag"]["other_shapes"]
    serve64["launches"], serve32["launches"] = serving["fused"]["float64"], \
        serving["fused"]["float32"]
    # phase 25: K1 at (64, 40, 40) f64 in the stream call; one rank's K1 at
    # (128, 50, 50) and K2 at (8, 10, 10) f64 on the 1 x 2 mesh
    stream_k1["launches"] = serving["stream"]
    rank0 = serving["sharded"].get("1x2", {})
    shard_k1["launches"] = rank0.get(shape_key("inv_cholesky_diag", K1_SHARD), 0)
    shard_k2["launches"] = rank0.get(shape_key("inv_cholesky", K2_SHARD), 0)
    extras_shape, exp_shape = kern["inv_cholesky_big"]["other_shapes"]
    extras_shape["launches"] = extras["inv_cholesky_big"]
    exp_shape["launches"] = exp_extras["inv_cholesky_big"]
    for name, (_, _, _, path) in KERNELS.items():
        require(launches[path][name] > 0, f"the {path} path never launched {name}")
    if FAILED:
        print(f"{len(FAILED)} check(s) failed:\n  " + "\n  ".join(FAILED), file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[path][name], **kern[name]}
        for name, (replaces, _, _, path) in KERNELS.items()] + [
        {"name": "hessian_apply", "route": "cuda", "source": "pmpc_tpu_torch/csrc/hessian_apply.cu",
         "replaces": None, "launches": launches["flagship"]["inv_cholesky_diag"], "shapes": k5}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
