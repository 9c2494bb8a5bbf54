"""The crawl behind `chip_smoke.py` phase 24 (b)'s settings (ROADMAP §3
F13). The B = 8 agreement instance (Dubins, M = 1, N = 20, box +-1,
||u_j|| <= 0.9 as SOC extras plus a linear row, f64, ``ipm_tol_exp`` -10,
cap 100) on the port's structured route at the IPM's default tau, 0.99.

- On the CPU, lane 1's IPM of SCP iteration 7 runs to the cap inside the
  batch. Its subproblem, from the recorded inputs, converges alone in 24
  iterations and as four identical lanes of one batch in 202: the same
  numbers, placed differently, part at rounding level and the tail
  decides. At tau 0.95 it takes 8 wherever it sits, as in the JAX IPM.
- `tests/data/f13_card_lane.pt` is lane 1's subproblem of SCP iteration 8
  on the H100 (written by ``python3 -m pmpc_tpu_torch.ipm_crawl``), where
  the lane reached the cap with mu 1.065e-8, above the hard-fail line
  1e2 * 1e-10, and froze. On the CPU it does the same. At tau 0.95 the
  port and the JAX IPM at HEAD (`pmpc_tpu.solvers.ipm.ipm_core`, the tau
  its structured route runs with cones) crawl alike: unconverged at 100
  with the same mu, converged at 163. At 0.99 the JAX IPM, which also has
  HEAD's `stalled` rule (not copied, F5), converges in 14."""

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pmpc_tpu_torch
from pmpc_tpu.solvers import ipm as jipm
from pmpc_tpu.solvers import reduced as jred
from pmpc_tpu_torch import conebatch, ipm_crawl
from pmpc_tpu_torch.flagship import dubins
from pmpc_tpu_torch.solvers import ipm as tipm
from pmpc_tpu_torch.solvers import reduced as tred

LANE, SCP_IT, CAP = 1, 7, 100
CARD_LANE = Path(__file__).parent / "data" / "f13_card_lane.pt"


@pytest.fixture(scope="module")
def crawl_call():
    """The recorded structured IPM call of SCP iteration 7 on the CPU."""
    f_fn = pmpc_tpu_torch.make_f_fx_fu_fn(dubins, device="cpu")
    probs = [{k: v for k, v in p.items() if k not in ("reg_x", "reg_u")}
             for p in chip_smoke.served_cone_problems(
                 chip_smoke.B_AGREE_STRUCT, f_fn, np.float64, SCP_IT + 1, 0.0,
                 ipm_tol_exp=-10, ipm_iters=CAP)]
    _, calls, stats = ipm_crawl._recorded_run(probs, "cpu")
    assert stats["structured"] and len(calls) == SCP_IT + 1
    return calls[SCP_IT]


def _port(sub, tau, iters):
    """The port's IPM on a lane subproblem: (iters, converged, mu, uf)."""
    _, uf, st = conebatch.ipm_core(
        tred.CondensedQP(**sub["cqp"]), tipm.BoxBounds(**sub["bounds"]), has_u=True,
        has_x=False, iters=iters, tol_exp=sub["tol_exp"], kappa=sub["kappa"], tau=tau,
        warm=sub["warm"], socs=tipm.SocSpec(**sub["socs"]), has_soc=True,
        ex=tipm.ExtraRows(**sub["ex"]), has_ex=True)
    return int(st["iters"][0]), bool(st["converged"][0]), float(st["mu"][0]), uf[0].numpy()


@partial(jax.jit, static_argnames="kappa")
def _jax_run(cqp, bounds, warm, socs, ex, kappa):
    return {(tau, iters): jipm.ipm_core(cqp, bounds, has_u=True, has_x=False, iters=iters,
                                        tol_exp=-10, kappa=kappa, tau=tau, warm=warm,
                                        socs=socs, has_soc=True, ex=ex, has_ex=True)
            for tau, iters in ((0.95, CAP), (0.95, 4 * CAP), (0.99, CAP))}


def _jax(sub):
    """The JAX IPM on a lane subproblem, unbatched: {(tau, cap): (iters,
    converged, mu, uf)}."""
    j = lambda t: jnp.asarray(t[0].numpy())
    cqp = jred.CondensedQP(**{k: j(v) for k, v in sub["cqp"].items()})
    inf_x = jnp.full(cqp.g.shape, jnp.inf)
    bounds = jipm.BoxBounds(*(j(sub["bounds"][k]) for k in ("lo_c", "hi_c", "lo_f", "hi_f")),
                            lo_x=-inf_x, hi_x=inf_x)
    assert sub["tol_exp"] == -10
    out = _jax_run(cqp, bounds, tuple(map(j, sub["warm"])),
                   jipm.SocSpec(**{k: j(v) for k, v in sub["socs"].items()}),
                   jipm.ExtraRows(**{k: j(v) for k, v in sub["ex"].items()}), kappa=sub["kappa"])
    return {key: (int(st["iters"]), bool(st["converged"]), float(st["mu"]), np.asarray(uf))
            for key, (_, uf, st) in out.items()}


def test_lane_crawls_in_the_batch_and_its_outcome_follows_the_last_bits(crawl_call):
    it = crawl_call[4].tolist()
    assert it[LANE] == CAP and not bool(crawl_call[5][LANE])
    assert max(it[:LANE] + it[LANE + 1:]) < 30  # the other lanes converge
    alone = ipm_crawl._alone(crawl_call, LANE, "cpu", CAP, 0.99)
    four = ipm_crawl._alone(crawl_call, LANE, "cpu", 4 * CAP, 0.99, copies=4)
    assert alone[0][:2] == (24, True)
    assert all(r[:2] == (202, True) for r in four)
    for copies in (1, 4):
        assert all(r[:2] == (8, True)
                   for r in ipm_crawl._alone(crawl_call, LANE, "cpu", CAP, 0.95, copies=copies))
    # the JAX IPM at 0.95: the port's iterations, mu and controls
    sub = ipm_crawl.lane_subproblem(crawl_call, LANE)
    it_t, conv_t, mu_t, uf_t = _port(sub, 0.95, CAP)
    it_j, conv_j, mu_j, uf_j = _jax(sub)[(0.95, CAP)]
    assert conv_t and conv_j and it_t == it_j == 8
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-3)
    np.testing.assert_allclose(uf_t, uf_j, atol=1e-8, rtol=0)


def test_the_card_lane_freezes_on_the_cpu_too_and_crawls_alike_in_jax():
    sub = torch.load(CARD_LANE)
    assert (sub["lane"], sub["scp_iteration"], sub["run"]) == (LANE, 8, "card")
    # the card's freeze: at the cap, mu above the hard-fail line 1e2 * 1e-10
    it, conv, mu, _ = _port(sub, 0.99, CAP)
    assert (it, conv) == (CAP, False) and mu > 1e-8
    jx = _jax(sub)
    for cap, (it_t, conv_t, mu_t, uf_t) in ((CAP, _port(sub, 0.95, CAP)),
                                            (4 * CAP, _port(sub, 0.95, 4 * CAP))):
        it_j, conv_j, mu_j, uf_j = jx[(0.95, cap)]
        print(f"tau 0.95 cap {cap}: port {it_t} {conv_t} {mu_t:.4e}, JAX {it_j} {conv_j} "
              f"{mu_j:.4e}, |uf_port - uf_jax| {np.abs(uf_t - uf_j).max():.2e}")
        assert conv_t == conv_j and abs(it_t - it_j) <= 1
        np.testing.assert_allclose(mu_t, mu_j, rtol=1e-2)
    assert jx[(0.95, CAP)][1] is False and jx[(0.95, 4 * CAP)][:2] == (163, True)
    assert jx[(0.99, CAP)][:2] == (14, True)
