"""The check catches a broken program: the harness runs on the CPU at a
tiny size (past its look for a card) with the solver broken underneath, and
``correct`` has to come out false; with the solver whole, true."""

import math

import pytest
import torch

from portbench import check, program
from portbench.tests._tiny import run_tiny


def unchanged(cfg):
    """Returns its starting state: the initial guess, claimed converged."""
    solver = program.build(cfg)

    def broken(data):
        X, U, info = solver(data)
        X0 = torch.cat([data.x0[:, :, None], data.X_prev], 2)
        return X0, data.U_prev.clone(), info
    return broken


def half_batch(cfg):
    """Solves the first half of the batch and hands its answers to the rest."""
    solver = program.build(cfg)

    def broken(data):
        B = data.x0.shape[0]
        h = (B + 1) // 2
        X, U, info = solver(data._replace(**{k: getattr(data, k)[:h] for k in data._fields
                                              if getattr(data, k) is not None}))
        rep = lambda t: torch.cat([t, t[: B - h]])
        return rep(X), rep(U), {k: rep(v) if torch.is_tensor(v) and v.shape[:1] == (h,) else v
                                for k, v in info.items()}
    return broken


def altered(cfg):
    """One answer altered where it is produced: lane 0's first control."""
    solver = program.build(cfg)

    def broken(data):
        X, U, info = solver(data)
        U = U.clone()
        U[0, :, 0, 0] = (U[0, :, 0, 0] + 0.3).clamp(-1, 1) if U[0, 0, 0, 0] < 0.7 \
            else U[0, :, 0, 0] - 0.3
        return X, U, info
    return broken


def nudged(cfg):
    """Every answer moved by 1e-3 off its KKT point: far inside the limit of
    ``u_err``, so only a reference that reaches the KKT point can see it."""
    solver = program.build(cfg)

    def broken(data):
        X, U, info = solver(data)
        return X, (U * (1.0 - 1e-3)).clamp(-1, 1), info
    return broken


CELLS = ["m32n30.b64", "m32n30.b1024"]
CASES = [(c, f) for c in CELLS for f in (unchanged, half_batch, altered)]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_broken_solver_is_not_correct(cell, fault):
    res, numbers, _ = run_tiny(cell, build=fault)
    assert res["correct"] is False, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_the_whole_solver_is_correct(cell):
    res, numbers, _ = run_tiny(cell)
    assert res["correct"] is True, numbers


def test_a_reference_short_of_its_kkt_point_gives_no_reading(monkeypatch):
    """One Newton step from a nudged answer lands within 1e-3 of it, but not
    on a KKT point: that reading is inf, not the small gap it would show."""
    monkeypatch.setattr(check, "REF_MAX_IT", 1)
    res, numbers, notes = run_tiny("m32n30.b64", build=nudged)
    assert notes["reference_converged"] < notes["sampled"]
    assert numbers["u_err"][0] == math.inf and res["correct"] is False
