"""The central-path barrier method of the port (`solvers.expbarrier`)
against the JAX package's, f64, on the CPU.

(a) the closed-form SOC and exponential-cone barrier gradients and Hessians
against ``jax.grad`` / ``jax.hessian`` of the JAX barrier functions, to
1e-10 relative, inside the cones and where a 1e-300 clamp is active
(gradient 0, Hessian NaN in both);
(b) `exp_barrier_solve` on dense programs with nonnegative rows, SOCs and
exponential cones, lane by lane against the JAX solver at B = 3: v to 1e-8,
equal ``converged`` and ``mu``;
(c) a program whose phase I cannot find a feasible point (two nonnegative
rows that contradict each other): ``converged`` false in both packages;
(d) exponential cones alone, in f64 and in f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmpc_tpu.solvers import expbarrier as jeb
from pmpc_tpu_torch.solvers import expbarrier as teb

torch.set_num_threads(1)

NV, ML, NQ, P, NE = 6, 4, 2, 3, 2


def _program(rng, infeasible=False):
    """A strictly feasible dense cone QP around a random point (slack 0.5 on
    the rows, (2, 0, 0) in the SOCs, (-1, 1, 1) in the exp cones)."""
    A = rng.normal(size=(NV, NV))
    Pm = A @ A.T / NV + 0.1 * np.eye(NV)
    q = 3.0 * rng.normal(size=NV)
    vf = 0.3 * rng.normal(size=NV)
    Gl = rng.normal(size=(ML, NV))
    hl = Gl @ vf + 0.5
    if infeasible:  # g'v <= -1 and -g'v <= -1
        Gl[1] = -Gl[0]
        hl[0] = hl[1] = -1.0
    Gq = rng.normal(size=(NQ, P, NV))
    hq = Gq @ vf + np.array([2.0, 0.0, 0.0])
    Ge = rng.normal(size=(NE, 3, NV))
    he = Ge @ vf + np.array([-1.0, 1.0, 1.0])
    return Pm, q, Gl, hl, Gq, hq, Ge, he


def _hold_lanes(progs):
    t = [torch.from_numpy(np.stack([pr[i] for pr in progs])) for i in range(8)]
    v, st = teb.exp_barrier_solve(*t)
    for b, pr in enumerate(progs):
        vj, sj = jeb.exp_barrier_solve(*(jnp.asarray(a) for a in pr))
        assert bool(st["converged"][b]) == bool(sj["converged"])
        assert float(st["mu"][b]) == float(sj["mu"])
        assert int(st["iters"][b]) == int(sj["iters"])
        if bool(sj["converged"]):
            np.testing.assert_allclose(v[b].numpy(), np.asarray(vj), atol=1e-8, rtol=0)
    return v, st


def _rel(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def test_closed_form_barrier_derivatives_match_autodiff():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(8, 3))
    s[:, 1:] = np.abs(s[:, 1:]) + 0.3
    s[:, 0] = -np.abs(s[:, 0])  # z log(y/z) - x > 0 needs room in x
    s[6] = (1.0, 0.5, 2.0)  # outside: z log(y/z) - x < 0, the u clamp is active
    s[7] = (0.1, -1.0, 1.0)  # y <= 0: the y clamp is active
    q = rng.normal(size=(6, 4))
    q[:, 0] = np.linalg.norm(q[:, 1:], axis=-1) + 0.2
    q[5, 0] = 0.0  # outside the SOC
    for points, fn, ours in ((s, jeb._exp_barrier, teb._exp_grad_hess),
                             (q, jeb._soc_barrier, teb._soc_grad_hess)):
        g, H = ours(torch.from_numpy(points))
        for i, pt in enumerate(points):
            gj = np.asarray(jax.grad(fn)(jnp.asarray(pt)))
            Hj = np.asarray(jax.hessian(fn)(jnp.asarray(pt)))
            assert _rel(g[i].numpy(), gj) < 1e-10, (i, g[i], gj)
            if np.isnan(Hj).any():
                assert np.isnan(H[i].numpy()).all() and np.isnan(Hj).all(), (i, H[i], Hj)
            else:
                assert _rel(H[i].numpy(), Hj) < 1e-10, (i, H[i], Hj)
        # the barrier values and the margins too
        t = torch.from_numpy(points)
        if fn is jeb._exp_barrier:
            np.testing.assert_allclose(teb._exp_barrier(t).numpy(),
                                       [float(fn(jnp.asarray(p))) for p in points], rtol=1e-14)
            np.testing.assert_allclose(teb._exp_margin(t).numpy(),
                                       [float(jeb._exp_margin(jnp.asarray(p))) for p in points],
                                       rtol=1e-14)
        else:
            np.testing.assert_allclose(teb._soc_barrier(t).numpy(),
                                       [float(fn(jnp.asarray(p))) for p in points], rtol=1e-14)


def test_exp_barrier_solve_matches_jax_lane_by_lane():
    rng = np.random.default_rng(1)
    v, st = _hold_lanes([_program(rng) for _ in range(3)])
    assert st["converged"].all()
    assert st["mu"].dtype == torch.float64 and st["iters"].dtype == torch.int32


def test_phase_one_failure_is_not_converged_in_both():
    rng = np.random.default_rng(2)
    progs = [_program(rng), _program(rng, infeasible=True), _program(rng)]
    v, st = _hold_lanes(progs)
    assert st["converged"].tolist() == [True, False, True]


def test_empty_families_and_float32():
    """No nonnegative rows and no SOC (exp cones alone), then the same
    program in f32 against the JAX solver in f32 (v to 1e-4, the same
    ``converged``) and the f64 answer (1e-3)."""
    rng = np.random.default_rng(3)
    pr = _program(rng)
    one = [torch.from_numpy(a)[None] for a in pr]
    one[2], one[3] = one[2][:, :0], one[3][:, :0]
    one[4], one[5] = one[4][:, :0], one[5][:, :0]
    v, st = teb.exp_barrier_solve(*one)
    vj, sj = jeb.exp_barrier_solve(*(jnp.asarray(a[0].numpy()) for a in one))
    assert bool(st["converged"][0]) and bool(sj["converged"])
    np.testing.assert_allclose(v[0].numpy(), np.asarray(vj), atol=1e-8, rtol=0)
    # f32 at 10^-4: at 10^-5 the final centering test (decrement^2 < 1e-2)
    # sits at f32's rounding and its outcome follows each package's last bit
    v32, st32 = teb.exp_barrier_solve(*(a.float() for a in one), tol_exp=-4)
    vj32, sj32 = jeb.exp_barrier_solve(*(jnp.asarray(a[0].numpy(), jnp.float32)
                                         for a in one), tol_exp=-4)
    assert v32.dtype == torch.float32
    assert bool(st32["converged"][0]) and bool(sj32["converged"])
    assert np.abs(v32[0].numpy() - np.asarray(vj32)).max() < 1e-4
    assert np.abs(v32[0].double().numpy() - v[0].numpy()).max() < 1e-3
