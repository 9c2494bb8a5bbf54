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
   at n in {1, 7, 33, 64, 65, 72, 95, 96}, the NaN contract at n = 50 and
   90, n = 97 refused; then each kernel timed with CUDA events at its main
   shape (K2 also at (2048, 50, 50)) beside its plain version, the library
   calls and its bound, and 128 against 256 threads at n = 50 and 90;
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
then one JSON line for the kernels and, last, one JSON line for the run. Every
solver phase sets the launch counts to 0 before its timed call and reads them
after it.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pmpc_tpu_torch.flagship import (HEADLINE_KW, flagship, podscale, probe,
                                     stack_varied)
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.utils import matmul_precision_scope

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # relative, cond(A) <~ 1e2
PROBE_TOL = 1e-3  # the repo's f32 accuracy envelope (BASELINE.md)
B_FLAGSHIP, B_POD = 64, 32
V_BOX = 1.2
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
# published peaks of one H100 SXM: HBM bytes/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# further shapes the phases launch: (adds a diagonal, batch, n)
OTHER_SHAPES = ((True, 8, 50), (False, 1, 10), (False, 32, 10), (False, 2048, 50))
K2_WIDE = (2048, 50)  # K2's second timed shape, from the state-box phase
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
    larger of every input read once and the output written once over the
    memory rate, and n^3/3 (factor) + n^3/3 (triangular inverse) flops per
    block over the f32 rate."""
    B, n = A.shape[0], A.shape[-1]
    nbytes = (2 * A.numel() + (w.numel() if diag else 0)) * A.element_size()
    t_bytes, t_ops = nbytes / PEAK_BYTES, B * (2.0 / 3.0) * n ** 3 / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    for diag, B, n in OTHER_SHAPES:
        for dtype in (torch.float32, torch.float64):
            err = check(diag, *spd_inputs(B, n, dtype, dev))
            if (B, n) == K2_WIDE and dtype == torch.float32:
                wide = {"shape": [B, n, n], "max_abs_err": err}
    for n in (1, 7, 33, 64, 65, 72, 95, 96):
        for dtype in (torch.float32, torch.float64):
            A, w = spd_inputs(37, n, dtype, dev, seed=n)
            for diag in (True, False):
                check(diag, A, w)
    # NaN contract: a non-SPD block is all NaN, its neighbours are untouched
    for n in (50, 90):
        A, w = spd_inputs(5, n, torch.float32, dev, seed=9)
        A[3] = -2.5 * torch.eye(n, device=dev)
        for diag in (True, False):
            out, ref = run(diag, A, w), run(diag, A, w, plain=True)
            ok = [0, 1, 2, 4]
            require(torch.isnan(out[3]).all() and torch.isfinite(out[ok]).all()
                    and (out[ok] - ref[ok]).abs().max() <= TOL[A.dtype] * ref[ok].abs().max(),
                    f"NaN contract broken at n={n}, diag={diag}")
    print("  NaN contract (n = 50, 90): the non-SPD block is all NaN, its neighbours match")
    try:
        chol_inv.inv_cholesky(torch.eye(97, device=dev).expand(2, 97, 97).contiguous())
        require(False, "n = 97 was not refused")
    except NotImplementedError as e:
        print(f"  n = 97 refused: {e}")
    # time at the main-path shapes, f32: plain, library, kernel, kernel, library, plain
    results["inv_cholesky"]["other_shapes"] = [wide]
    timed = [(name, diag, B, n, results[name])
             for name, (_, diag, (B, n), _) in KERNELS.items()]
    timed.insert(2, ("inv_cholesky", False, *K2_WIDE, wide))
    for name, diag, B, n, r in timed:
        A, w = spd_inputs(B, n, torch.float32, dev)
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
        print(f"  {name} ({B}, {n}, {n}) f32: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (cholesky_ex + solve_triangular) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of it) [{card}]")
    # the CTA size behind each route's choice: 128, 256, 256, 128 threads
    for n, dtype in ((50, torch.float32), (90, torch.float32), (90, torch.float64)):
        A, w = spd_inputs(2048, n, dtype, dev)
        for diag in (True, False):
            t = [time_ms(lambda: chol_inv._launch(A, w if diag else None, JITTER, threads=th))
                 for th in (128, 256, 256, 128)]
            print(f"  (2048, {n}, {n}) {str(dtype)[6:]} {'diag' if diag else 'plain-A'}: "
                  f"128 threads {(t[0] + t[3]) / 2:.4f} ms, 256 threads "
                  f"{(t[1] + t[2]) / 2:.4f} ms (the route uses "
                  f"{chol_inv.THREADS[chol_inv._route(n)]}) [{card}]")
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


def timed_call(solver, stack):
    """One warm-up call, then one timed call with the launch counts reset
    before it and read after it: (X, U, info, seconds, launches)."""
    solver(stack)
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
    return launches


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


def main():
    card = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with matmul_precision_scope():
        phase_build()
        kern = phase_kernels(dev, card)
        chol_inv.SHAPES.clear()
        phase_probe(dev)
        launches = {"flagship": phase_flagship(dev, card),
                    "podscale": phase_podscale(dev, card),
                    "unbounded": phase_unbounded(dev, card),
                    "state_box": phase_state_box(dev, card)}
        phase_launched_shapes(dev)
    # the state-box phase launches K2 twice per IPM iteration, once at each shape
    kern["inv_cholesky"]["other_shapes"][0]["launches"] = \
        launches["state_box"]["inv_cholesky"] // 2
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
