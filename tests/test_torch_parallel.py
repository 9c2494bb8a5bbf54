"""Batch and particle sharding in the port (`pmpc_tpu_torch.parallel`) on
gloo ranks spawned on the CPU, f64.

The ranks are spawned by `parallel.check.run` once for each world size (the
meshes 4 x 1 and 2 x 2 on four ranks, 1 x 2 on two); on each mesh they run
every small case of `check.CASES`, gather the sharded results
(`distributed.process_allgather`) and rank 0 writes them out. The cases are
the twins of tests/test_sharding.py (the unbounded solve with and without
particle sharding, control boxes, control cones, the Riccati method) and of
tests/test_distributed.py (each rank's local batch through
`host_local_batch_to_global` on `global_mesh`). Each is held against the
port's unsharded solver on the full batch in this process, to 1e-7 with
equal SCP iteration counts, and the boxed case also against `jax.vmap` of
the JAX package's single-problem solver.
"""

import numpy as np
import pytest
import torch

from pmpc_tpu_torch.parallel import check

TOL = 1e-7
M = check.SMALL["M"]
MESHES = {"4x1": (4, 1), "2x2": (2, 2), "1x2": (1, 2)}
CASES = check.CASES[1:]  # the small cases

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Spawn the ranks once for each world size (4 x 1 and 2 x 2 on four, 1 x
    2 on two): the gathered results by mesh name."""
    out = {}
    for world, names in ((4, ("4x1", "2x2")), (2, ("1x2",))):
        path = str(tmp_path_factory.mktemp(f"w{world}") / "res.npz")
        rep, logs = check.run(world, "gloo", ",".join(names), device="cpu", cases=CASES,
                              tol=TOL, timeout=300, out=path)
        assert rep is not None, "\n".join(f"--- rank {r} ---\n{log[-3000:]}"
                                          for r, log in enumerate(logs))
        for name in names:
            out[name] = {k.split("/", 1)[1]: v for k, v in rep["arrays"].items()
                         if k.startswith(name + "/")}
            for case, r in rep["meshes"][name].items():
                out[name][f"{case}/M_local"] = r["M_local"]
    return out


_REF = {}


def unsharded(case):
    """The port's solver on the full batch in this process."""
    if case not in _REF:
        _, solver, data, _ = check.case_setup(case, "cpu")
        X, U, info = solver(data)
        _REF[case] = (X.numpy(), U.numpy(), info["iters"].numpy())
    return _REF[case]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_solve_matches_unsharded(spawned, mesh, case):
    res = spawned[mesh]
    X, U, iters = unsharded(case)
    np.testing.assert_allclose(res[f"{case}/U"], U, rtol=0, atol=TOL)
    np.testing.assert_allclose(res[f"{case}/X"], X, rtol=0, atol=TOL)
    np.testing.assert_array_equal(res[f"{case}/iters"], iters)
    nb, npart = MESHES[mesh]
    sharded_p = case != "unbounded_batch" and npart > 1
    assert int(res[f"{case}/M_local"]) == (M // npart if sharded_p else M)
    if case != "unbounded" and case != "unbounded_batch":
        assert np.abs(res[f"{case}/U"]).max() <= 1.0 + 1e-6
    if case == "soc":
        assert np.linalg.norm(res[f"{case}/U"], axis=-1).max() <= 0.9 + 1e-6
    # the consensus controls are the same on every particle, sharded or not
    Nc = 3 if case.startswith("unbounded") else 2
    assert np.ptp(res[f"{case}/U"][:, :, :Nc], axis=1).max() < 1e-10


def test_sharded_bounded_matches_vmapped_jax(spawned):
    """The 2 x 2 mesh's boxed case against `jax.vmap` of the JAX solver."""
    import jax
    import jax.numpy as jnp

    from fixtures import unicycle_step
    from pmpc_tpu.jax_scp import SCPData as JData, build_scp_solver as j_build

    kw, _, data, _ = check.case_setup("bounded", "cpu")
    j_data = JData(*(None if getattr(data, f) is None else jnp.asarray(getattr(data, f).numpy())
                     for f in JData._fields))
    Xj, Uj, ij = jax.jit(jax.vmap(j_build(unicycle_step, jit=False, **kw)))(j_data)
    res = spawned["2x2"]
    np.testing.assert_allclose(res["bounded/U"], np.asarray(Uj), rtol=0, atol=TOL)
    np.testing.assert_array_equal(res["bounded/iters"], np.asarray(ij["iters"]))


def test_make_mesh_defaults_to_the_card():
    """A mesh built from default arguments puts the shards on the card under
    gloo too; without a card it raises, and the CPU takes device_type="cpu"."""
    import torch.distributed as dist

    from pmpc_tpu_torch.parallel import make_mesh, shard_batched_data
    from pmpc_tpu_torch.parallel.distributed import init_distributed

    _, _, data, _ = check.case_setup("bounded", "cpu")
    init_distributed(f"tcp://localhost:{check._free_port()}", 1, 0, backend="gloo")
    try:
        if torch.cuda.is_available():
            assert shard_batched_data(data, make_mesh(1, 1)).x0.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh(1, 1)
        shard = shard_batched_data(data, make_mesh(1, 1, device_type="cpu"))
        assert shard.x0.device.type == "cpu"
        np.testing.assert_array_equal(shard.x0.numpy(), data.x0.numpy())
    finally:
        dist.destroy_process_group()


class _RankMesh:
    """The parts of a `DeviceMesh` that the placement reads, for one rank of
    an nb x npart mesh on the CPU: no process group needed."""

    mesh_dim_names = ("batch", "particle")
    device_type = "cpu"

    def __init__(self, nb, npart, b, p):
        self._size, self._rank = (nb, npart), {"batch": b, "particle": p}

    def size(self, dim):
        return self._size[dim]

    def get_local_rank(self, name):
        return self._rank[name]


@pytest.mark.parametrize("shard_particles", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_data_sharding_names_what_shard_batched_data_cuts(mesh, shard_particles):
    """`data_sharding` names the JAX function's partition (its spec's axes),
    and on every rank of the mesh `shard_batched_data` cuts each (B, M, ...)
    leaf to the block those axes give, computed here with numpy; leaves
    with fewer than 2 dims stay whole."""
    import jax
    from jax.sharding import Mesh

    from pmpc_tpu.parallel import mesh as jmesh
    from pmpc_tpu_torch.parallel.mesh import data_sharding
    from pmpc_tpu_torch.parallel import shard_batched_data

    j1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("batch", "particle"))
    j_axes = tuple(jmesh.data_sharding(j1, shard_particles).spec)
    _, _, data, _ = check.case_setup("bounded", "cpu")
    data = data._replace(params=torch.arange(3.0))  # a 1-D leaf: replicated
    nb, npart = MESHES[mesh]
    B, Mp = data.x0.shape[:2]
    for b in range(nb):
        for p in range(npart):
            m = _RankMesh(nb, npart, b, p)
            spec = data_sharding(m, shard_particles)
            assert spec.axes == j_axes and spec.mesh is m
            shard = shard_batched_data(data, m, shard_particles=shard_particles)
            rows = slice(b * B // nb, (b + 1) * B // nb)
            cols = slice(p * Mp // npart, (p + 1) * Mp // npart) if shard_particles \
                else slice(None)
            for f in data._fields:
                full, got = getattr(data, f), getattr(shard, f)
                if full is None:
                    assert got is None
                    continue
                want = full.numpy() if full.ndim < 2 else full.numpy()[rows][:, cols]
                np.testing.assert_array_equal(got.numpy(), want)


def test_hold_kernels_reports_each_launched_shape():
    """`check.hold_kernels`, which each rank runs on the card after its
    meshes: one entry per launched (kernel, batch, n, dtype), its error
    against the plain version and whether that is within `KERNEL_TOL`. On
    the CPU both sides are the plain version: error 0."""
    shapes = {("inv_cholesky_diag", 64, 50, torch.float64), ("inv_cholesky", 2, 10, torch.float64),
              ("inv_cholesky_big", 3, 70, torch.float32)}
    held = check.hold_kernels(shapes, "cpu")
    assert sorted(held) == ["inv_cholesky (2, 10, 10) float64",
                            "inv_cholesky_big (3, 70, 70) float32",
                            "inv_cholesky_diag (64, 50, 50) float64"]
    assert all(err == 0.0 and ok for err, ok in held.values())
