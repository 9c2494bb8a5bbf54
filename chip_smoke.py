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
   that does nothing;
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
   forms its 40 x 40 Newton blocks, so K2 alone at (512, 40, 40);
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
then phase 9 once more for the shapes phases 10-18 launched, one JSON line
for the kernels and, last, one JSON line for the run. Every solver phase sets
the launch counts to 0 before its timed call and reads them after it.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pmpc_tpu_torch.conebatch import _canon_problem, solve_problems_cone
from pmpc_tpu_torch.dynamics import dynamics_violation, linearize
from pmpc_tpu_torch.flagship import (HEADLINE_KW, KEEP_IN_C, KEEP_IN_R, SOC_R3,
                                     baseline_config, cvar_batch, dubins, extras_batch,
                                     flagship, long_horizon, podscale, probe, stack_varied)
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.solvers import ipm
from pmpc_tpu_torch.solvers.compose import COST_ANCHOR_EPS, composed_solve_batch_device
from pmpc_tpu_torch.solvers.reduced import assemble_condensed
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
                (False, 64, 71))
K2_WIDE = (2048, 50)  # K2's second timed shape, from the state-box phase
K2_CONE = (512, 40)  # K2's third timed shape: config 3's cone Newton blocks
K2_CVAR = (64, 45)  # K2 in f64: the CVaR program's Newton matrix (phase 17)
K4_EXTRAS = (64, 71)  # K4 in f64: the extras program's (phase 18)
B_CONFIG3 = 512
B_CONE, M_CVAR, K_CVAR, B_CHECK = 64, 4, 3, 4  # phases 17-18
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
            if (B, n) in (K2_WIDE, K2_CONE, K2_CVAR, K4_EXTRAS):
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
                                               other[K2_CVAR + (f64,)]]
    results["inv_cholesky_big"]["other_shapes"] = [other[K4_EXTRAS + (f64,)]]
    timed = [(name, diag, B, n, f32, results[name])
             for name, (_, diag, (B, n), _) in KERNELS.items()]
    timed[2:2] = [("inv_cholesky", False, *K2_WIDE, f32, other[K2_WIDE + (f32,)]),
                  ("inv_cholesky", False, *K2_CONE, f32, other[K2_CONE + (f32,)]),
                  ("inv_cholesky", False, *K2_CONE, f64, other[K2_CONE + (f64,)]),
                  ("inv_cholesky", False, *K2_CVAR, f64, other[K2_CVAR + (f64,)])]
    timed.append(("inv_cholesky_big", False, *K4_EXTRAS, f64, other[K4_EXTRAS + (f64,)]))
    for name, diag, B, n, dtype, r in timed:
        A, w = spd_inputs(B, n, dtype, dev)
        fns = {"plain": lambda: run(diag, A, w, plain=True),
               "library": lambda: library(diag, A, w),
               "kernel": lambda: run(diag, A, w)}
        order = ("plain", "library", "kernel", "kernel", "library", "plain")
        t = {}
        for k in order:
            t.setdefault(k, []).append(time_ms(fns[k]))
        r["ms"], r["plain_ms"], r["library_ms"] = (
            sum(t[k]) / 2 for k in ("kernel", "plain", "library"))
        r["bound_ms"], r["bound_by"] = bound(diag, A, w)
        print(f"  {name} ({B}, {n}, {n}) {str(dtype)[6:]}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (cholesky_ex + solve_triangular) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of it) [{card}]")
    # K2's main shape is launch-bound: its floor is a kernel that does nothing
    k2 = results["inv_cholesky"]
    k2["launch_floor_ms"] = time_ms(chol_inv.empty_launch)
    print(f"  inv_cholesky (64, 10, 10) f32: kernel {k2['ms']:.4f} ms beside "
          f"{k2['launch_floor_ms']:.4f} ms for the launch of an empty kernel [{card}]")
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
    """One warm-up call, then one timed call with the launch counts reset
    before it and read after it: (X, U, info, seconds, launches). The long
    Riccati calls launch the same small kernels hundreds of thousands of
    times: they are warmed by ``warm_solver``, a solver of the same shapes
    with fewer SCP iterations (a no-op where the caller has warmed)."""
    (warm_solver or solver)(stack)
    torch.cuda.synchronize()
    chol_inv.reset_launch_counts()
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
        X, U, info, dt, launches = timed_call(solver, stack, warm_solver=lambda _: None)
        frac, _, _ = report(14, f"config 3 (box +-1, cone ||u_j|| <= {SOC_R3}) B={B} M=1 N=20 "
                            f"{name} AA", info, dt, launches, card)
        u_max, u_norm_max = U.abs().max().item(), U.norm(dim=-1).max().item()
        print(f"    lanes whose IPM gave up in some SCP iteration: {failed}; max |u| "
              f"{u_max:.7f}, max ||u_j|| {u_norm_max:.7f}; K2 (inv_cholesky) launches at "
              f"({B}, 40, 40): {launches['inv_cholesky']}")
        require(torch.isfinite(X).all() and torch.isfinite(U).all()
                and U.shape == (B, 1, 20, 2), f"[14] config 3 {name} output is not finite "
                "or has the wrong shape")
        require(u_max <= 1 + 1e-5, f"[14] config 3 {name}: the control box is violated")
        require(u_norm_max <= SOC_R3 + 1e-4, f"[14] config 3 {name}: the cone is violated")
        # nc = 0 and formed Newton blocks: K2 at (512, 40, 40) alone
        require(only_launched(launches, ("inv_cholesky",))
                and ("inv_cholesky", B, 40, dtype) in chol_inv.SHAPES,
                f"[14] config 3 {name} launches {launches}: expected K2 at ({B}, 40, 40) only")
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


def main():
    card = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with matmul_precision_scope():
        phase_build()
        kern = phase_kernels(dev, card)
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
    # the state-box phase launches K2 twice per IPM iteration, once at each shape
    wide, cone, cvar_shape = kern["inv_cholesky"]["other_shapes"]
    wide["launches"] = launches["state_box"]["inv_cholesky"] // 2
    cone["launches"] = config3["inv_cholesky"]
    cvar_shape["launches"] = cvar["inv_cholesky"]
    kern["inv_cholesky_big"]["other_shapes"][0]["launches"] = extras["inv_cholesky_big"]
    for name, (_, _, _, path) in KERNELS.items():
        require(launches[path][name] > 0, f"the {path} path never launched {name}")
    if FAILED:
        print(f"{len(FAILED)} check(s) failed:\n  " + "\n  ".join(FAILED), file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[path][name], **kern[name]}
        for name, (replaces, _, _, path) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
