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
