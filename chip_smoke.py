"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:
1. the card (nvidia-smi name and power limit); no CUDA -> exit 1;
2. build the inverse-Cholesky kernel from pmpc_tpu_torch/csrc/ (nvcc);
3. kernel against its plain PyTorch version on the card: the flagship shapes
   K1 (2048, 50, 50) and K2 (64, 10, 10), odd sizes and a ragged batch, the
   NaN contract, f32 and f64, and both timed with CUDA events;
4. the accuracy-probe config in f32 against the JAX package's f64 answer
   (benchmarks/accuracy_ref_u64.npy), to 1e-3;
5. the headline program: B=64 scenarios, M=32, N=30, Nc=5, f32, Anderson
   acceleration, timed after one warm-up;
then one JSON line for the kernels and, last, one JSON line for the run.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pmpc_tpu_torch.flagship import HEADLINE_KW, flagship, probe, stack_varied
from pmpc_tpu_torch.ops import chol_inv
from pmpc_tpu_torch.utils import matmul_precision_scope

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # relative, cond(A) <~ 1e2
PROBE_TOL = 1e-3  # the repo's f32 accuracy envelope (BASELINE.md)
B_FLAGSHIP, REPS = 64, 3
KERNELS = {  # entry -> (TPU kernel it replaces, flagship shape)
    "inv_cholesky_diag": ("pmpc_tpu/ops/pallas_chol.py:136", (2048, 50)),
    "inv_cholesky": ("pmpc_tpu/ops/pallas_chol.py:161", (64, 10)),
}


def spd_inputs(B, n, dtype, dev, seed=0):
    """SPD blocks G G'/n + I (condition number ~10) and weights in [0.1, 2]."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n)) / np.sqrt(n)
    A = G @ np.swapaxes(G, -1, -2) + np.eye(n)
    w = rng.uniform(0.1, 2.0, size=(B, n))
    return (torch.from_numpy(A).to(dev, dtype).contiguous(),
            torch.from_numpy(w).to(dev, dtype).contiguous())


def run(name, A, w, plain=False):
    if name == "inv_cholesky_diag":
        f = chol_inv.inv_cholesky_diag_plain if plain else chol_inv.inv_cholesky_diag
        return f(A, w, 1e-7)
    f = chol_inv.inv_cholesky_plain if plain else chol_inv.inv_cholesky
    return f(A, 1e-7)


def check(name, A, w):
    """Kernel vs plain on the card: (max abs error, relative error)."""
    out, ref = run(name, A, w), run(name, A, w, plain=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    tol = TOL[A.dtype]
    shape = tuple(A.shape)
    print(f"  {name} {shape} {str(A.dtype)[6:]}: max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {tol:g})")
    if not (rel <= tol and (torch.triu(out, 1) == 0).all()):
        raise AssertionError(f"{name} {shape} disagrees with its plain version")
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
    print("[3] kernel vs plain on the card")
    results = {}
    for name, (_, (B, n)) in KERNELS.items():
        for dtype in (torch.float32, torch.float64):
            A, w = spd_inputs(B, n, dtype, dev)
            err = check(name, A, w)
            if dtype == torch.float32:
                results[name] = {"max_abs_err": err}
    for n in (1, 7, 33, 64):
        for dtype in (torch.float32, torch.float64):
            A, w = spd_inputs(37, n, dtype, dev, seed=n)
            for name in KERNELS:
                check(name, A, w)
    # NaN contract: a non-SPD block is all NaN, its neighbours are untouched
    A, w = spd_inputs(5, 50, torch.float32, dev, seed=9)
    A[3] = -torch.eye(50, device=dev)
    for name in KERNELS:
        out, ref = run(name, A, w), run(name, A, w, plain=True)
        ok = [0, 1, 2, 4]
        if not (torch.isnan(out[3]).all() and torch.isfinite(out[ok]).all()
                and (out[ok] - ref[ok]).abs().max() <= TOL[A.dtype] * ref[ok].abs().max()):
            raise AssertionError(f"{name}: NaN contract broken")
    print("  NaN contract: the non-SPD block is all NaN, its neighbours match")
    # time at the flagship shapes, f32: plain, kernel, kernel, plain
    for name, (_, (B, n)) in KERNELS.items():
        A, w = spd_inputs(B, n, torch.float32, dev)
        t = [time_ms(lambda: run(name, A, w, plain=p)) for p in (True, False, False, True)]
        results[name]["ms"] = (t[1] + t[2]) / 2
        results[name]["plain_ms"] = (t[0] + t[3]) / 2
        print(f"  {name} ({B}, {n}, {n}) f32: kernel {results[name]['ms']:.4f} ms, "
              f"plain {results[name]['plain_ms']:.4f} ms [{card}]")
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
    if not (torch.isfinite(X).all() and U.shape == (1,) + ref.shape):
        raise AssertionError("probe output is not finite or has the wrong shape")
    if err > PROBE_TOL:
        raise AssertionError(f"probe error {err:.3e} > {PROBE_TOL:g}")
    k1, k2 = launches["inv_cholesky_diag"], launches["inv_cholesky"]
    # one K1 and one K2 launch per batched IPM iteration (warm start: no
    # cold-start factor)
    if not (k1 > 0 and k1 == k2):
        raise AssertionError(f"kernel launches on the probe path: {launches}")


def phase_flagship(dev, card):
    solver, data = flagship(dtype=torch.float32, device=dev, **HEADLINE_KW)
    stack = stack_varied(data, B_FLAGSHIP)
    X, U, info = solver(stack)  # warm-up
    torch.cuda.synchronize()
    chol_inv.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(REPS):
        X, U, info = solver(stack)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(chol_inv.LAUNCHES)
    conv = info["converged"].cpu().numpy()
    resid = info["resid"].double().cpu().numpy()
    frac = float(conv.mean())
    print(f"[5] flagship B={B_FLAGSHIP} M=32 N=30 Nc=5 f32 AA: "
          f"{B_FLAGSHIP * REPS / dt:.2f} solves/s, "
          f"{conv.sum() * REPS / dt:.2f} converged solves/s, "
          f"{dt / REPS * 1e3:.1f} ms/call, converged_frac {frac:.4f}, "
          f"resid_max {resid.max():.3e}, "
          f"iters_median {float(np.median(info['iters'].cpu().numpy()))} "
          f"[{card}]; launches {launches}")
    if not (torch.isfinite(X).all() and torch.isfinite(U).all()
            and U.shape == (B_FLAGSHIP, 32, 30, 2)):
        raise AssertionError("flagship output is not finite or has the wrong shape")
    if frac < 0.95:
        raise AssertionError(f"flagship converged_frac {frac} < 0.95")
    return launches


def main():
    card = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with matmul_precision_scope():
        phase_build()
        kern = phase_kernels(dev, card)
        phase_probe(dev)
        launches = phase_flagship(dev, card)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "pmpc_tpu_torch/csrc/chol_inv.cu",
         "replaces": KERNELS[name][0], "launches": launches[name], **kern[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
