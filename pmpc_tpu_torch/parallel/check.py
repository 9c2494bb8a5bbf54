"""The sharded solver against the unsharded one, on spawned ranks.

    python3 -m pmpc_tpu_torch.parallel.check --nproc 2 --backend gloo --meshes 1x2,2x1
    python3 -m pmpc_tpu_torch.parallel.check --nproc 4 --backend nccl --meshes 4x1,2x2,1x4
    python3 -m pmpc_tpu_torch.parallel.check --nproc 4 --device cpu --meshes 4x1,2x2 \\
        --cases unbounded,bounded,soc,riccati,distributed

Spawns ``--nproc`` ranks (one process each, `torch.distributed` over
``tcp://localhost``). On each mesh ("batch x particle") the ranks run every
case of ``--cases`` (`CASES`, f64) through `make_sharded_solver`, time one
call (after a warm-up on the card), count the hand kernels each rank
launched by shape, and gather the result (`distributed.process_allgather`).
On the card each rank then holds every (kernel, batch, n, dtype) it
launched against the kernel's plain version on seeded SPD blocks (to
``KERNEL_TOL`` of the plain result's largest entry). Rank 0 holds the
results against the unsharded solver on the full batch (U and X to
``--tol``, equal SCP iteration counts), prints one line
``PARALLEL_CHECK {json}`` and, with ``--out``, writes the gathered arrays to
an ``.npz`` (keys ``"<mesh>/<case>/<U|X|iters>"``); the command exits 1 when
a rank fails or a mesh disagrees. Each rank also checks that its shard lies
on its own device: the card, with the mesh built from default arguments,
under either backend, or the CPU with ``--device cpu``. Under NCCL rank r
takes card r; under gloo every rank takes card 0 (NCCL refuses two ranks on
one card).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

# "flagship": the headline program (`flagship.flagship` with HEADLINE_KW:
# M=32, N=30, Nc=5, box controls, Anderson acceleration) stacked to --B
# scenarios; the others, the twins of the JAX package's sharding tests, at
# SMALL: B=4, M=4, N=8 (the unbounded solve with and without particle
# sharding, control boxes, control cones, the Riccati method, and each
# rank's local batch through `host_local_batch_to_global` on `global_mesh`)
CASES = ("flagship", "unbounded_batch", "unbounded", "bounded", "soc", "riccati",
         "distributed")
SMALL = dict(B=4, M=4, N=8)
# a kernel against its plain version: the largest error relative to the
# plain result's largest entry (chip_smoke.py's bounds)
KERNEL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def case_setup(case: str, device, B: int = 8, dtype=torch.float64):
    """(build kwargs, solver, full (B, M, ...) batch, shard_particles) of a
    case, made from seeded numpy arrays: the same in every process. The
    small cases ignore ``B``; the build kwargs of "flagship" are None."""
    from ..flagship import HEADLINE_KW, dubins, flagship, stack_varied
    from ..torch_scp import build_scp_solver, make_scp_data

    if case == "flagship":
        solver, one = flagship(dtype=dtype, device=device, **HEADLINE_KW)
        return None, solver, stack_varied(one, B), True
    B, M, N = SMALL["B"], SMALL["M"], SMALL["N"]
    rng = np.random.default_rng(CASES.index(case) - 1)
    x0 = rng.normal(size=(B, M, 4))
    box = dict(u_l=-np.ones((B, M, N, 2)), u_u=np.ones((B, M, N, 2)))
    extra, kw = {}, dict(N=N, xdim=4, udim=2, M=M, Nc=2, max_it=6, res_tol=1e-6)
    if case.startswith("unbounded"):
        kw.update(Nc=3, max_it=10)
    elif case == "soc":
        extra = dict(box, u_soc_r=np.full((B, M, N), 0.9))
        kw.update(has_u_bounds=True, has_u_soc=True)
    else:
        extra = box
        kw.update(has_u_bounds=True, accel="AA" if case == "distributed" else "",
                  method="riccati" if case == "riccati" else "condensed")
    data = make_scp_data(x0, np.tile(np.eye(4), (B, M, N, 1, 1)),
                         np.tile(1e-2 * np.eye(2), (B, M, N, 1, 1)),
                         reg_x=1.0, reg_u=0.1, dtype=dtype, device=device, **extra)
    return kw, build_scp_solver(dubins, **kw), data, case != "unbounded_batch"


def hold_kernels(shapes, dev) -> dict:
    """Each launched (kernel name, batch, n, dtype) of ``shapes`` against its
    plain version on seeded SPD blocks G G'/n + I (weights in [0.1, 1.1)
    where the kernel adds a diagonal) on ``dev``: {"<name> (batch, n, n)
    <dtype>": [relative error, within KERNEL_TOL]}."""
    from ..ops import chol_inv

    out = {}
    for name, B, n, dtype in sorted(shapes, key=str):
        g = torch.Generator().manual_seed(n)
        G = torch.randn(B, n, n, generator=g, dtype=torch.float64) / n ** 0.5
        A = (G @ G.mT + torch.eye(n, dtype=torch.float64)).to(dev, dtype)
        w = (torch.rand(B, n, generator=g, dtype=torch.float64) + 0.1).to(dev, dtype)
        if "_diag" in name:
            got = chol_inv.inv_cholesky_diag(A, w, 1e-7)
            ref = chol_inv.inv_cholesky_diag_plain(A, w, 1e-7)
        else:
            got, ref = chol_inv.inv_cholesky(A, 1e-7), chol_inv.inv_cholesky_plain(A, 1e-7)
        err = float((got - ref).abs().max() / ref.abs().max())
        out[f"{name} ({B}, {n}, {n}) {str(dtype)[6:]}"] = [err, err <= KERNEL_TOL[dtype]]
    return out


def _rank_main(a) -> None:
    import torch.distributed as dist

    from ..ops import chol_inv
    from ..torch_scp import SCPData
    from ..utils import matmul_precision_scope
    from . import make_mesh, make_sharded_solver, shard_batched_data
    from .distributed import global_mesh, host_local_batch_to_global, init_distributed, \
        process_allgather
    from .mesh import coords

    if a.device == "cuda":
        torch.cuda.set_device(a.rank % torch.cuda.device_count() if a.backend == "nccl" else 0)
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh_dev = None  # the default: the card, whatever the backend
    else:
        dev, mesh_dev = torch.device("cpu"), "cpu"
        torch.set_num_threads(1)
    init_distributed(f"tcp://localhost:{a.port}", a.nproc, a.rank, backend=a.backend)
    cases = a.cases.split(",")
    setups = {c: case_setup(c, dev, a.B) for c in cases}
    out, arrays, refs, launched = {}, {}, {}, set()
    with matmul_precision_scope():
        for name in a.meshes.split(","):
            nb, npart = (int(v) for v in name.split("x"))
            out[name] = {}
            for case in cases:
                _, solver, batch, shard_p = setups[case]
                if case == "distributed":
                    # each rank holds its batch row's problems only (all particles)
                    m = global_mesh(n_particle=npart, device_type=mesh_dev)
                    rows = batch.x0.shape[0] // nb
                    b = coords(m)[0]
                    local = host_local_batch_to_global(m, SCPData(*(
                        None if getattr(batch, f) is None
                        else getattr(batch, f)[b * rows:(b + 1) * rows]
                        for f in SCPData._fields)))
                    shard_p = npart > 1
                else:
                    m = make_mesh(nb, npart, device_type=mesh_dev)
                    local = shard_batched_data(batch, m, shard_particles=shard_p)
                fn = make_sharded_solver(solver, m, shard_particles=shard_p)
                places = {getattr(local, f).device.type for f in SCPData._fields
                          if getattr(local, f) is not None}
                if places != {dev.type}:
                    raise RuntimeError(f"mesh {name}, {case}: the shard lies on {places}, "
                                       f"not on {dev.type}")
                if dev.type == "cuda":
                    fn(local)  # warm-up
                    torch.cuda.synchronize()
                before = chol_inv.SHAPES.copy()
                dist.barrier()
                t0 = time.perf_counter()
                X, U, info = fn(local)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                new_shapes = chol_inv.SHAPES - before
                launched |= set(new_shapes)
                shapes = {f"{k[0]} ({k[1]}, {k[2]}, {k[2]}) {str(k[3])[6:]}": v
                          for k, v in new_shapes.items()}
                sp = shard_p and npart > 1
                got = dict(U=process_allgather(m, U, particle_axis=sp),
                           X=process_allgather(m, X, particle_axis=sp),
                           iters=process_allgather(m, info["iters"], particle_axis=False))
                every = [None] * a.nproc
                dist.all_gather_object(every, dict(ms=ms, launches=shapes))
                if a.rank != 0:
                    continue
                if case not in refs:
                    X_r, U_r, info_r = solver(batch)
                    refs[case] = dict(U=U_r, X=X_r, iters=info_r["iters"],
                                      converged=int(info_r["converged"].sum()))
                ref = refs[case]
                err = max(float((got[k] - ref[k]).abs().max()) for k in ("U", "X"))
                same = bool((got["iters"] == ref["iters"]).all())
                out[name][case] = dict(
                    max_abs_err=err, iters_equal=same, iters_max=int(got["iters"].max()),
                    converged=ref["converged"], M_local=fn.solver.build_args["M"],
                    ms_per_rank=[e["ms"] for e in every],
                    launches_per_rank=[e["launches"] for e in every],
                    ok=bool(err <= a.tol and same and np.isfinite(err)))
                arrays.update({f"{name}/{case}/{k}": v.cpu().numpy() for k, v in got.items()})
        held = hold_kernels(launched, dev) if dev.type == "cuda" else {}
    every = [None] * a.nproc
    dist.all_gather_object(every, held)
    if a.rank == 0:
        if a.out:
            np.savez(a.out, **arrays)
        print("PARALLEL_CHECK " + json.dumps(dict(
            nproc=a.nproc, backend=a.backend, device=str(dev), B=a.B, tol=a.tol,
            meshes=out, kernels_vs_plain=every,
            kernels_ok=all(ok for r in every for _, ok in r.values()))), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def run(nproc: int, backend: str, meshes: str, device: str = "cuda",
        cases: Sequence[str] = ("flagship",), B: int = 8, tol: float = 1e-7,
        timeout: float = 600.0, out: Optional[str] = None):
    """Spawn the ranks and wait: (the rank 0 report as a dict or None, every
    rank's output). With ``out`` the report's ``"arrays"`` holds the
    gathered results (`_rank_main`). Every process started here has ended
    on return."""
    port = _free_port()
    args = [sys.executable, "-m", "pmpc_tpu_torch.parallel.check", "--nproc", str(nproc),
            "--backend", backend, "--meshes", meshes, "--device", device,
            "--cases", ",".join(cases), "--B", str(B), "--tol", str(tol),
            "--port", str(port)] + (["--out", out] if out else [])
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(args + ["--rank", str(r)], cwd=root, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(nproc)]
    logs, t_end = [], time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, t_end - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        logs.append(f"timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    report = None
    for line in logs[0].splitlines() if logs else []:
        if line.startswith("PARALLEL_CHECK "):
            report = json.loads(line[len("PARALLEL_CHECK "):])
    if report is None or any(p.returncode != 0 for p in procs):
        return None, logs
    if out:
        report["arrays"] = dict(np.load(out))
    return report, logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--meshes", default="1x2,2x1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cases", default="flagship")
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--out", default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None)
    a = ap.parse_args(argv)
    if a.rank is not None:
        _rank_main(a)
        return 0
    report, logs = run(a.nproc, a.backend, a.meshes, a.device, a.cases.split(","), a.B,
                       a.tol, out=a.out)
    if report is None:
        for r, log in enumerate(logs):
            print(f"--- rank {r} ---\n{log[-4000:]}", file=sys.stderr)
        return 1
    report.pop("arrays", None)
    print("PARALLEL_CHECK " + json.dumps(report))
    return 0 if report["kernels_ok"] and all(
        c["ok"] for m in report["meshes"].values() for c in m.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
