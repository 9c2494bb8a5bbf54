"""The port's solve farm (`pmpc_tpu_torch.remote`) on the CPU, over
localhost ZMQ: a server started as ``python -m pmpc_tpu_torch.remote
--device cpu --no-warmup`` answers the port's client and the JAX package's
(`pmpc_tpu.remote.call`, the same wire format): ``solve`` against the
local `solve`, ``solve_batch`` against the local `solve_problems`, an
unsupported method returns its exception, the non-blocking poll, the greedy
scheduler, a result's tensors (the Riccati warm tuple) arrive as numpy and
warm-start the next request. A server whose warm-up fails (here: on a
device string that names no device) dies and its farm exits 1. The card path of the farm is
not run here."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")
pytest.importorskip("zstandard")
pytest.importorskip("cloudpickle")

import pmpc_tpu_torch  # noqa: E402
from pmpc_tpu_torch import remote  # noqa: E402

# apart from tests/test_remote.py's 23000 + pid % 1000, unique per run, and
# outside the Linux ephemeral range 32768-60999
PORT = 25000 + (os.getpid() % 1000)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(dtype=np.float64)


def _farm(port, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "pmpc_tpu_torch.remote", "--port", str(port),
         "--worker-num", "1", *args],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def farm():
    proc = _farm(PORT, "--no-warmup", "--device", "cpu")
    yield proc
    proc.terminate()
    proc.wait(timeout=10)


def _double_integrator():
    """A numpy callback defined in a closure: cloudpickle ships it by value,
    so the server imports nothing of the tests (nor JAX)."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])

    def f_fx_fu_fn(X, U):
        return (X @ A.T + U @ B.T, np.broadcast_to(A, X.shape[:-1] + A.shape),
                np.broadcast_to(B, X.shape[:-1] + B.shape))

    return f_fx_fu_fn


def _problem(seed=0, N=8, **kw):
    rng = np.random.default_rng(seed)
    return dict(dict(f_fx_fu_fn=_double_integrator(), Q=np.tile(np.eye(2), (N, 1, 1)),
                     R=np.tile(0.1 * np.eye(1), (N, 1, 1)), x0=rng.normal(size=2),
                     max_it=5, verbose=False, solver_settings=dict(F64)), **kw)


def _wait(poll, timeout=120.0):
    """Poll a non-blocking call until its reply arrives."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        ret = poll()
        if not (isinstance(ret, str) and ret == "NOT_ARRIVED_YET"):
            return ret
        time.sleep(0.05)
    poll.close()
    raise AssertionError("no reply from the farm")


def _call(method, *args, client=remote, **kw):
    return _wait(client.call(method, "localhost", PORT, False, *args, **kw))


def test_solve_round_trip_port_and_jax_clients(farm):
    from pmpc_tpu import remote as jremote

    p = _problem()
    X_l, U_l, _ = pmpc_tpu_torch.solve(**dict(p, device="cpu"))
    for client in (remote, jremote):
        ret = _call("solve", client=client, **p)
        assert not isinstance(ret, Exception), ret
        X, U, data = ret
        assert X.shape == (9, 2) and U.shape == (8, 1)
        np.testing.assert_allclose(U, U_l, atol=1e-12, rtol=0)
    # the JAX client's blocking form
    X, U, _ = jremote.call("solve", "localhost", PORT, True, **p)
    np.testing.assert_allclose(U, U_l, atol=1e-12, rtol=0)


def test_solve_batch_and_the_scheduler(farm):
    base = _problem()
    # one shared callback: homogeneity compares callbacks by identity
    # (cloudpickle memoizes, so identity survives the wire)
    problems = [dict(base, x0=base["x0"] + 0.1 * i) for i in range(3)]
    ret = _call("solve_batch", problems)
    assert not isinstance(ret, Exception), ret
    local = pmpc_tpu_torch.solve_problems(problems, device="cpu")
    assert len(ret) == 3
    for (X, U, d), (Xl, Ul, _) in zip(ret, local):
        np.testing.assert_allclose(U, Ul, atol=1e-12, rtol=0)
    rets = remote.solve_problems([_problem(seed=s) for s in range(3)],
                                 workers=[("localhost", PORT)], max_solve_time=60.0)
    assert [r[0].shape for r in rets] == [(9, 2)] * 3


def test_unsupported_method_and_tensor_results(farm):
    ret = _call("rm_rf")
    assert isinstance(ret, ValueError) and "not supported" in str(ret)
    # the Riccati route keeps its warm tuple as tensors: they cross as numpy
    p = _problem(u_l=-np.ones((8, 1)), u_u=np.ones((8, 1)),
                 solver_settings=dict(F64, method="riccati"))
    ret = _call("solve", **p)
    assert not isinstance(ret, Exception), ret
    X, U, data = ret
    warm = data["solver_data"][-1]["solver_state"]["riccati_warm"]
    assert all(isinstance(a, np.ndarray) for a in warm)
    ret2 = _call("solve", **dict(p, solver_state=data["solver_data"][-1]["solver_state"]))
    assert not isinstance(ret2, Exception), ret2
    assert np.isfinite(ret2[1]).all()
    # NamedTuples (an SCPData, say) keep their type, their tensors go to numpy
    import torch
    from pmpc_tpu_torch.torch_scp import make_scp_data

    host = remote._to_host({"data": make_scp_data(np.ones((1, 2)), np.tile(np.eye(2), (1, 3, 1, 1)),
                                                  np.tile(np.eye(1), (1, 3, 1, 1)), device="cpu")})
    assert type(host["data"]).__name__ == "SCPData" and isinstance(host["data"].Q, np.ndarray)
    assert not any(isinstance(a, torch.Tensor) for a in host["data"])


def test_failed_warmup_ends_the_farm():
    """The JAX farm swallows a failed warm-up; the port's worker dies of it
    (here: ``--device nodevice``, which names no device on any machine)
    and the farm, left without workers, exits 1."""
    proc = _farm(PORT + 500, "--device", "nodevice")
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 1, out
    assert b"every worker died" in out
