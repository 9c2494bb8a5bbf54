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
``(None, None, None)`` alone), the signature mismatch, the F5 instance seed
904 of tests/test_conebatch_soc.py through the composed route, and the
problem converter. The structured route (boxes, per-stage control cones
and linear-only extras on the arrow IPM, no cone program built): linear
rows against the JAX structured route (U to 1e-6, the failure contract
too), stage cones given as SOC extras plus a linear row against the JAX
composed route and the port's (1e-6; the JAX structured route raises on
that signature, ROADMAP §3 R4), with a JAX-style ``f_fx_fu_fn`` in place of
``dynamics``. The exponential-cone signatures run the central-path barrier
method over the batch: tests/test_conebatch_exp.py's logbarrier batch (B = 3)
against the JAX function and one problem solved alone, and a B = 2 batch of
`flagship.extras_batch` with user ``e`` rows against the JAX function."""

import numpy as np
import pytest
import torch

import pmpc_tpu
import pmpc_tpu_torch
from pmpc_tpu.conebatch import solve_problems_cone as jsolve
from pmpc_tpu_torch.conebatch import solve_problems_cone as tsolve
from pmpc_tpu_torch.convert import problem_from_numpy
from pmpc_tpu_torch.flagship import EXP_KAPPA, EXP_VMAX, dubins, extras_batch
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
    # the JAX callback carries a JAX step, which the port cannot run; a
    # problem with neither the wrapped dynamics nor the key
    with pytest.raises(ValueError, match="dynamics"):
        tsolve([p1], device="cpu")
    with pytest.raises(ValueError, match="dynamics"):
        tsolve([dict(p1, f_fx_fu_fn=lambda X, U: None)], device="cpu")
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
    # user e rows and the logbarrier settings carry over as they are
    p = extras_batch(B=1, M=2, N=6, Nc=2, exp_speed=True, smooth_cstr="logbarrier",
                     smooth_alpha=50.0)[0]
    c = problem_from_numpy(dict(p, f_fx_fu_fn=None), dubins, "cpu")
    ss, ss0 = c["solver_settings"], p["solver_settings"]
    assert (ss["smooth_cstr"], ss["smooth_alpha"]) == ("logbarrier", 50.0)
    for ec, ec0 in zip(ss["extra_cstrs"], ss0["extra_cstrs"]):
        assert ec[:3] == ec0[:3]  # l, the SOC sizes, the exp-cone count
        for t, a0 in zip(ec[3:], ec0[3:]):
            np.testing.assert_array_equal(t.numpy(), a0)


# ---- exponential cones: the central-path barrier method over the batch -----------

def _logbarrier_batch():
    """tests/test_conebatch_exp.py::test_batched_logbarrier_matches_serial's
    batch: logbarrier smoothing of the box rows and of one extras row."""
    M, N, xdim, udim, Nc = 2, 6, 4, 2, 2
    return [dict(_mk_problem(i, M=M, N=N), solver_settings=dict(
        Nc=Nc, smooth_cstr="logbarrier", smooth_alpha=50.0,
        extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.2 + 0.05 * i)])) for i in range(3)]


@pytest.fixture(scope="module")
def logbarrier_out():
    probs = _logbarrier_batch()
    return probs, tsolve(_port(probs), device="cpu")


def test_batched_logbarrier_matches_serial(logbarrier_out):
    """The twin of tests/test_conebatch_exp.py: every problem converges, and
    problem 2 solved alone matches its lane of the batch (the lanes are
    independent: 1e-9)."""
    probs, out_t = logbarrier_out
    assert all(d["converged"] for _, _, d in out_t)
    X, U, d = tsolve(_port(probs[2:]), device="cpu")[0]
    np.testing.assert_allclose(U, out_t[2][1], atol=1e-9, rtol=0)
    np.testing.assert_allclose(X, out_t[2][0], atol=1e-9, rtol=0)
    assert d["iters"] <= out_t[2][2]["iters"]
    for X, U, d in out_t:  # the smoothed boxes keep the controls strictly inside
        assert np.abs(U).max() < 1


def test_logbarrier_batch_matches_jax(logbarrier_out):
    probs, out_t = logbarrier_out
    _hold(out_t, jsolve(probs))


def test_exp_rows_batch_matches_jax():
    """User ``e`` rows: `flagship.extras_batch` (cut in depth to B = 2, N = 6)
    with the soft exponential terminal-speed limit on every particle; every
    exp slack inside its cone at the answer."""
    probs = extras_batch(B=2, M=2, N=6, Nc=2, exp_speed=True)
    out_t = tsolve(probs, device="cpu")
    _hold(out_t, jsolve(_jax(probs)))
    assert all(d["converged"] for _, _, d in out_t)


# ---- the structured route: the arrow IPM over the batch ------------------------------

def _no_cone_program(monkeypatch):
    """Make any use of the composed cone program fail the test."""
    from pmpc_tpu_torch import conebatch
    from pmpc_tpu_torch.solvers import compose

    def boom(*a, **k):
        raise AssertionError("the structured signature built the composed cone program")

    monkeypatch.setattr(compose, "composed_solve_batch_device", boom)
    monkeypatch.setattr(conebatch, "composed_solve_batch_device", boom)


def _wrapped(problems):
    """The JAX-API dicts with the port's `make_f_fx_fu_fn` callback (the
    dynamics comes from its ``__wrapped_dynamics__``)."""
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")
    return [dict(p, f_fx_fu_fn=f_fn, solver_settings=dict(p["solver_settings"],
                                                          dtype=np.float64))
            for p in problems]


def _struct_hold(out_t, out_j, tol):
    for (X, U, d), (Xj, Uj, dj) in zip(out_t, out_j):
        if dj is None:
            assert (X, U, d) == (None, None, None)
            continue
        np.testing.assert_allclose(U, Uj, atol=tol, rtol=0)
        np.testing.assert_allclose(X, Xj, atol=tol, rtol=0)
        for key in ("iters", "converged", "ipm_failed", "batch_index"):
            assert d[key] == dj[key], (key, d[key], dj[key])


def test_structured_linear_rows_match_jax(monkeypatch):
    """tests/test_conebatch.py::test_batched_extras_matches_serial's batch
    (B = 5, per-problem rows) on the structured route of both packages
    (green in JAX): U and X to 1e-6, equal counts; no cone program."""
    M, N, xdim, udim, Nc = 3, 8, 4, 2, 3
    probs = [dict(_mk_problem(i, M=M, N=N), solver_settings=dict(
        Nc=Nc, extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.1 + 0.03 * i)]))
        for i in range(5)]
    _no_cone_program(monkeypatch)
    stats = {}
    out_t = tsolve(_wrapped(probs), device="cpu", stats=stats)
    _struct_hold(out_t, jsolve(probs), 1e-6)
    assert stats["structured"] and stats["scp_iters"].max() == out_t[0][2]["iters"]
    for i, (X, U, d) in enumerate(out_t):
        assert d["converged"] and U[0, 0].sum() <= 0.1 + 0.03 * i + 1e-5
        assert np.ptp(U[:, :Nc], axis=0).max() < 1e-9  # consensus
    # ipm_tau reaches the port's IPM (the JAX route drops it)
    tau = {}
    short = [dict(p, max_it=2) for p in _wrapped(probs)]
    tsolve([dict(p, solver_settings=dict(p["solver_settings"], ipm_tau=0.5)) for p in short],
           device="cpu", stats=tau)
    assert (tau["ipm_iters"] > stats["ipm_iters"][:2]).all()


def test_structured_failure_is_isolated_per_problem(monkeypatch):
    """The structured twin of test_failure_is_isolated_per_problem (the JAX
    test's own route): problem 2's row is infeasible under the box."""
    M, N, xdim, udim, Nc = 2, 6, 4, 2, 2
    probs = [dict(_mk_problem(20 + i, M=M, N=N), solver_settings=dict(
        Nc=Nc, extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.3 if i != 2 else -50.0)]))
        for i in range(4)]
    _no_cone_program(monkeypatch)
    out_t = tsolve(_wrapped(probs), device="cpu")
    _struct_hold(out_t, jsolve(probs), 1e-6)
    assert out_t[2] == (None, None, None)
    assert all(out_t[i][2]["converged"] for i in (0, 1, 3))


def _stage_cones(M, N, Nc, r, rhs, xdim=4, udim=2):
    """||u_j|| <= r on every stage as SOC extras over the full consensus
    layout (rows [0; -u_j] against [r; 0], what `extras.split_stage_u_cones`
    recognizes) plus the row sum(u_0) <= rhs."""
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    starts = [j * udim for j in range(Nc)] + [nc + i * nf + k * udim
                                               for i in range(M) for k in range(N - Nc)]
    G = np.zeros((len(starts), udim + 1, n_full))
    for c, s0 in enumerate(starts):
        G[c, 1:, s0:s0 + udim] = -np.eye(udim)
    h = np.zeros((len(starts), udim + 1))
    h[:, 0] = r
    soc = (0, [udim + 1] * len(starts), 0, G.reshape(-1, n_full),
           np.zeros((G.size // n_full, 0)), h.reshape(-1), np.zeros(n_full), np.zeros(0))
    return [soc, _extras_row(M, N, xdim, udim, Nc, rhs)]


def test_structured_stage_cones_match_both_composed_routes(monkeypatch):
    """Per-stage control cones given as SOC extras plus a linear row, B = 3,
    tight solves: the port's structured route against the JAX composed
    route and the port's composed route (``extras_structured=False``), U to
    1e-6 (the two programs differ in their IPMs' regularization: ~2e-7
    here); cones and rows held; no cone program on the structured route."""
    M, N, Nc, r = 2, 6, 2, 0.8
    probs = [dict(_mk_problem(40 + i, M=M, N=N), res_tol=1e-8, max_it=40,
                  solver_settings=dict(Nc=Nc, ipm_tol_exp=-10, ipm_iters=100,
                                       extra_cstrs=_stage_cones(M, N, Nc, r, 0.1 + 0.05 * i)))
             for i in range(3)]
    composed = [dict(p, solver_settings=dict(p["solver_settings"], extras_structured=False))
                for p in probs]
    out_j = jsolve(composed)
    out_c = tsolve(_port(composed), device="cpu")
    _hold(out_c, out_j)
    with monkeypatch.context() as m:
        _no_cone_program(m)
        stats = {}
        out_s = tsolve(_wrapped(probs), device="cpu", stats=stats)
    assert stats["structured"]
    for i, ((X, U, d), (_, Uc, dc), (_, Uj, _)) in enumerate(zip(out_s, out_c, out_j)):
        assert d["converged"] and dc["converged"]
        np.testing.assert_allclose(U, Uj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(U, Uc, atol=1e-6, rtol=0)
        assert np.linalg.norm(U, axis=-1).max() <= r + 1e-6
        assert U[0, 0].sum() <= 0.1 + 0.05 * i + 1e-6
        assert len(stats["ipm_iters"]) == d["iters"]


def test_step_is_checked_on_the_route_device_and_dtype(monkeypatch):
    """The dynamics check calls the step once where the route runs it: on
    the batch's device and in its working dtype. A step that closes over
    float32 tensors serves an f32 structured batch (a check in float64 on
    the CPU refused it, as it refused a step closing over CUDA tensors)."""
    M, N, xdim, udim, Nc = 2, 6, 4, 2, 2
    A = torch.eye(xdim) + 0.1 * torch.diag(torch.ones(xdim - 1), 1)
    Bm = 0.1 * torch.ones(xdim, udim)
    step = lambda x, u: A @ x + Bm @ u  # noqa: E731 (float32 constants)
    probs = [dict({k: v for k, v in _mk_problem(60 + i, M=M, N=N).items() if k != "f_fx_fu_fn"},
                  dynamics=step, solver_settings=dict(
                      Nc=Nc, dtype=np.float32,
                      extra_cstrs=[_extras_row(M, N, xdim, udim, Nc, 0.3)]))
             for i in range(2)]
    _no_cone_program(monkeypatch)
    stats = {}
    out = tsolve(probs, device="cpu", stats=stats)
    assert stats["structured"]
    for X, U, d in out:
        assert U.dtype == np.float32 and np.isfinite(U).all()
        assert np.abs(U).max() <= 1 + 1e-5 and U[0, 0].sum() <= 0.3 + 1e-4
