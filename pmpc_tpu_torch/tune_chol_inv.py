"""Time ``csrc/chol_inv.cu`` beside copies of it with other CTA sizes and
panel widths.

    python3 -m pmpc_tpu_torch.tune_chol_inv [--ptxas]

The source fixes its sizes as three constants (threads of a CTA up to n = 64
and above it, the panel width NB): the fastest found by this script on an
H100 (PERF.md has the readings). Each variant is a copy of the source with
those three lines rewritten, built into ``_build/``, checked against the
plain version and timed with CUDA events at the kernels' main shapes, the
variants taking turns twice (forward, then backward) so that none has the
warm card to itself. ``--ptxas`` prints registers, spills and shared memory
of every instantiation of the source as it stands.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pmpc_tpu_torch.ops import chol_inv

# (threads up to n = 64, threads above, NB); the first is the source's own
VARIANTS = ((32, 64, 8), (64, 128, 8), (128, 256, 8), (32, 64, 4), (64, 128, 4))
# (batch, n, dtype, adds a diagonal)
SHAPES = ((2048, 50, torch.float32, True), (2048, 50, torch.float32, False),
          (2048, 90, torch.float32, True), (2048, 90, torch.float32, False),
          (2048, 50, torch.float64, True), (2048, 90, torch.float64, True),
          (64, 10, torch.float32, False))
JITTER = 1e-7


def inputs(B, n, dtype, dev):
    """SPD blocks G G'/n + I and weights in [0.1, 2]."""
    g = torch.Generator().manual_seed(0)
    G = torch.randn(B, n, n, generator=g, dtype=torch.float64) / n ** 0.5
    A = G @ G.mT + torch.eye(n, dtype=torch.float64)
    w = 0.1 + 1.9 * torch.rand(B, n, generator=g, dtype=torch.float64)
    return A.to(dev, dtype).contiguous(), w.to(dev, dtype).contiguous()


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


def build(small, big, nb):
    """A launcher launch(A, w) -> out for a copy of the source with these
    sizes, built in a directory of its own under ``_build/``."""
    src = chol_inv._SRC.read_text()
    for name, value in (("kThreadsSmall", small), ("kThreadsBig", big), ("kNB", nb)):
        src, hits = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", src)
        if hits != 1:
            raise SystemExit(f"{chol_inv._SRC} does not define {name} as expected")
    root = chol_inv._PKG / "_build"
    root.mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(dir=root))
    (out_dir / "chol_inv.cu").write_text(src)
    res = subprocess.run(
        [chol_inv._nvcc(), *chol_inv._NVCC_FLAGS, "-o", str(out_dir / "libchol_inv.so"),
         str(out_dir / "chol_inv.cu")], capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {(small, big, nb)}:\n{res.stderr}")
    lib = ctypes.CDLL(str(out_dir / "libchol_inv.so"))
    for name in ("pmpc_chol_inv_f32", "pmpc_chol_inv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def launch(A, w):
        out = torch.empty_like(A)
        fn = lib.pmpc_chol_inv_f32 if A.dtype == torch.float32 else lib.pmpc_chol_inv_f64
        err = fn(A.data_ptr(), None if w is None else w.data_ptr(), JITTER,
                 out.data_ptr(), A.shape[0], A.shape[-1],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {err}")
        return out
    return launch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    if args.ptxas:
        with tempfile.TemporaryDirectory(dir=chol_inv._PKG) as tmp:
            res = subprocess.run(
                [chol_inv._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o",
                 str(Path(tmp) / "chol_inv.cubin"), str(chol_inv._SRC)],
                capture_output=True, text=True, timeout=600)
        print(res.stderr)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda v: build(*v), VARIANTS))
    launchers = {f"threads {s}/{b} NB {nb}": fn for (s, b, nb), fn in zip(VARIANTS, built)}
    for B, n, dtype, diag in SHAPES:
        A, w = inputs(B, n, dtype, dev)
        if not diag:
            w = None
        ref = (chol_inv.inv_cholesky_diag_plain(A, w, JITTER) if diag
               else chol_inv.inv_cholesky_plain(A, JITTER))
        t = {k: [] for k in launchers}
        for name in (*launchers, *reversed(launchers)):
            fn = launchers[name]
            rel = ((fn(A, w) - ref).abs().max() / ref.abs().max()).item()
            if not rel <= (1e-4 if dtype == torch.float32 else 1e-10):
                raise SystemExit(f"{name} disagrees with plain at {(B, n)}: rel {rel:.3e}")
            t[name].append(time_ms(lambda: fn(A, w)))
        what = f"({B}, {n}, {n}) {str(dtype)[6:]} {'diag' if diag else 'plain-A'}"
        for name, (t0, t1) in t.items():
            print(f"{what}: {name}: {(t0 + t1) / 2:.4f} ms ({t0:.4f}, {t1:.4f}) [{card}]")


if __name__ == "__main__":
    main()
