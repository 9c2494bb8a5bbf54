"""The scenario-batched composed-cone SCP of the port
(`pmpc_tpu_torch.conebatch.solve_problems_cone`) against the JAX package's
`pmpc_tpu.conebatch.solve_problems_cone`, f64, on the CPU.

The problem dicts are the JAX ones with the torch step function under
``dynamics`` in place of ``f_fx_fu_fn``. Held: U and X to 1e-7 and the
per-problem iters, resid, converged and ipm_failed equal, on a B = 4 CVaR
batch with control-norm cones (tests/test_conebatch_soc.py::
test_batched_cvar_respects_cones_and_consensus, an R1 instance; ROADMAP §3
F5) and a B = 4 extras batch (`flagship.extras_batch` cut in depth: a
keep-in cone on the states, an auxiliary slack with a cost, the terminal
cross cost). Also the failure contract (a hard-failed problem gives
``(None, None, None)`` alone), the signature mismatch, the signatures that
are not ported (exponential cones, the structured route), the F5 instance
seed 904 of tests/test_conebatch_soc.py through the composed route, and the
problem converter."""

import numpy as np
import pytest
import torch

import pmpc_tpu
from pmpc_tpu.conebatch import solve_problems_cone as jsolve
from pmpc_tpu_torch.conebatch import solve_problems_cone as tsolve
from pmpc_tpu_torch.convert import problem_from_numpy
from pmpc_tpu_torch.flagship import dubins, extras_batch
from fixtures import unicycle_step
from test_conebatch import _extras_row, _mk_problem

torch.set_num_threads(1)

TOL = 1e-7


def _port(problems):
    return [dict({k: v for k, v in p.items() if k != "f_fx_fu_fn"}, dynamics=dubins)
            for p in problems]


def _jax(problems):
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle_step)
    return [dict({k: v for k, v in p.items() if k != "dynamics"}, f_fx_fu_fn=f_fn)
            for p in problems]


def _hold(out_t, out_j):
    assert len(out_t) == len(out_j)
    for (X, U, d), (Xj, Uj, dj) in zip(out_t, out_j):
        if dj is None:
            assert (X, U, d) == (None, None, None)
            continue
        np.testing.assert_allclose(U, Uj, atol=TOL, rtol=0)
        np.testing.assert_allclose(X, Xj, atol=TOL, rtol=0)
        assert set(d) == set(dj)
        for key in ("iters", "converged", "ipm_failed", "batch_index"):
            assert d[key] == dj[key], (key, d[key], dj[key])
        assert abs(d["resid"] - dj["resid"]) <= 1e-9 * max(1.0, dj["resid"])


def test_cvar_batch_with_cones_matches_jax():
    """F5: an R1 instance through the composed route; both converge."""
    M, N, B = 4, 8, 4
    probs = [_mk_problem(10 + i, M=M, N=N, k=2, u_soc_r=np.full((M, N), 0.7))
             for i in range(B)]
    stats = {}
    out_t = tsolve(_port(probs), device="cpu", stats=stats)
    _hold(out_t, jsolve(probs))
    for X, U, d in out_t:
        assert np.linalg.norm(U, axis=-1).max() <= 0.7 + 1e-6
        assert np.ptp(U[:, :3], axis=0).max() < 1e-7  # Nc = 3 consensus
    assert stats["ipm_iters"].shape == (out_t[0][2]["iters"], B)
    print("F5 test_batched_cvar_respects_cones_and_consensus instance: converged",
          [d["converged"] for _, _, d in out_t], "resid", [d["resid"] for _, _, d in out_t])


def test_extras_batch_matches_jax():
    probs = extras_batch(B=4, M=2, N=10, Nc=3)
    out_t = tsolve(probs, device="cpu")
    _hold(out_t, jsolve(_jax(probs)))
    assert all(d["converged"] for _, _, d in out_t)
    for X, U, d in out_t:
        assert np.abs(U).max() <= 1 + 1e-6


def test_failure_is_isolated_per_problem():
    """The twin of tests/test_conebatch.py::
    test_batched_failure_isolated_per_problem on the composed route: problem
    2's row sum u_0 <= -50 is infeasible under the box."""
    M, N, xdim, udim, Nc = 2, 6, 4, 2, 2
    probs = [dict(_mk_problem(20 + i, M=M, N=N), solver_settings=dict(
        Nc=Nc, extras_structured=False,
        extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.3 if i != 2 else -50.0)]))
        for i in range(4)]
    out_t = tsolve(_port(probs), device="cpu")
    _hold(out_t, jsolve(probs))
    assert out_t[2] == (None, None, None)
    for i in (0, 1, 3):
        X, U, d = out_t[i]
        assert d["converged"] and U[0, 0].sum() <= 0.3 + 1e-5


def test_refusals():
    M, N, xdim, udim, Nc = 2, 6, 4, 2, 2
    p1 = dict(_mk_problem(1, M=M, N=N), solver_settings=dict(
        Nc=Nc, extras_structured=False, extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.3)]))
    ec2 = _extras_row(M, N, xdim, udim, Nc, 0.3)
    ec2 = (2, [], 0, np.vstack([ec2[3], ec2[3]]), np.zeros((2, 0)), np.array([0.3, 0.4]),
           ec2[6], ec2[7])
    p2 = dict(p1, solver_settings=dict(p1["solver_settings"], extra_cstrs=[ec2]))
    with pytest.raises(ValueError, match="signature"):
        tsolve(_port([p1, p2]), device="cpu")
    with pytest.raises(ValueError, match="dynamics"):
        tsolve([p1], device="cpu")
    exp = "ROADMAP §1.8, exponential cones"
    with pytest.raises(NotImplementedError, match=exp):
        tsolve(_port([dict(p1, solver_settings=dict(Nc=Nc, smooth_cstr="logbarrier"))]),
               device="cpu")
    with pytest.raises(NotImplementedError, match=exp):
        tsolve(_port([dict(p1, solver_settings=dict(Nc=Nc, smooth_alpha=10.0))]), device="cpu")
    n_full = Nc * udim + M * (N - Nc) * udim + M * N * xdim
    e_row = (0, [], 1, np.zeros((3, n_full)), np.zeros((3, 0)), np.array([0.0, 1.0, 1.0]),
             np.zeros(n_full), np.zeros(0))
    with pytest.raises(NotImplementedError, match=exp):
        tsolve(_port([dict(p1, solver_settings=dict(Nc=Nc, extra_cstrs=[e_row]))]),
               device="cpu")
    # boxes + linear extras + per-stage cones: the JAX structured route
    st = dict(p1, solver_settings=dict(Nc=Nc, u_soc_r=np.full((M, N), 0.8),
                                       extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.3)]))
    with pytest.raises(NotImplementedError, match="ROADMAP §1.10"):
        tsolve(_port([st, st]), device="cpu")
    # without a device the batch goes to the card, which is not here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsolve(_port([p1]))


def test_f5_conebatch_soc_seed_904_on_the_composed_route():
    """tests/test_conebatch_soc.py::test_fuzz_batched_struct_matches_serial
    seed 904's draw (control cones, weights, a linear extras row), which
    HEAD's structured route fails (R1), sent to the composed route on both
    packages (``extras_structured=False``)."""
    rng = np.random.default_rng(904)
    M, N, xdim, udim, B = 3, 8, 4, 2, 3
    use_soc = bool(rng.integers(2))
    use_lin = bool(rng.integers(2)) or not use_soc
    use_w = bool(rng.integers(2))
    probs = []
    for _ in range(B):
        ss = dict(Nc=3, extras_structured=False)
        if use_soc:
            ss["u_soc_r"] = np.full((M, N), 0.6 + 0.3 * rng.random())
        if use_w:
            ss["weights"] = 1.0 + rng.uniform(0, 2, size=M)
        p = dict(_mk_problem(int(rng.integers(1e6)), M=M, N=N), solver_settings=ss)
        if use_lin:
            n_full = 3 * udim + M * (N - 3) * udim + M * N * xdim
            g = np.zeros((1, n_full))
            g[0, :udim] = 1.0
            ss["extra_cstrs"] = [(1, [], 0, g, np.zeros((1, 0)),
                                  np.array([0.1 + 0.2 * rng.random()]), np.zeros(n_full),
                                  np.zeros(0))]
        probs.append(p)
    out_t = tsolve(_port(probs), device="cpu")
    _hold(out_t, jsolve(probs))
    print(f"F5 seed 904 (cones {use_soc}, rows {use_lin}, weights {use_w}): converged",
          [d["converged"] for _, _, d in out_t])


def test_problem_converter():
    """A problem of tensors (the converter's output) solves as its numpy
    original does."""
    probs = extras_batch(B=2, M=2, N=6, Nc=2, squareplus=True)
    conv = [problem_from_numpy(dict(p, f_fx_fu_fn=None), dubins, "cpu") for p in probs]
    assert isinstance(conv[0]["x0"], torch.Tensor) and conv[0]["dynamics"] is dubins
    assert "f_fx_fu_fn" not in conv[0]
    assert isinstance(conv[0]["solver_settings"]["u_soc_r"], torch.Tensor)
    a, b = tsolve(probs, device="cpu"), tsolve(conv, device="cpu")
    for (X, U, d), (X2, U2, d2) in zip(a, b):
        np.testing.assert_array_equal(U, U2)
        assert d["iters"] == d2["iters"]
