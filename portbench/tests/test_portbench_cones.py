"""Per-stage control cones ||u_{m,j}|| <= r in the check and the plain
reference: the step's cone QP against an independent oracle, the reference
against the program's cone solver, the box-only path bit for bit against
its recording, planted faults on a tiny cone configuration through the
harness, and the inputs and the control that carry the radius.

The cone configuration (``data/dubins_cone_test.json``) is config 3's cone
on ``dubins_m32_n30``'s problem; the tests hand it to ``find.cell`` in a
spec of their own, under the name and check of ``m32n30.b64`` (limits
``failed`` 0, ``u_err`` 0.03)."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, find, program
from portbench.reference import scp as reference
from portbench.tests._tiny import run_tiny, tiny_cell

DATA = Path(__file__).parent / "data"
CONE_FILE = "portbench/tests/data/dubins_cone_test.json"
CELL = "m32n30.b64"  # the cell whose name, traffic and check the cone spec borrows
RECORDING = DATA / "box_only_recording.pt"


def cone_spec():
    """BENCHMARK.json with ``CELL`` on the cone configuration."""
    spec = copy.deepcopy(find.bench())
    spec["configs"].append(dict(name="dubins_cone_test", source="tests", file=CONE_FILE,
                                reduced=[], why="tests"))
    for w in spec["workloads"]:
        if w["name"] == CELL:
            w["config"] = "dubins_cone_test"
    return spec


# (a) the step's QP -------------------------------------------------------


def project_2d(v, lo, hi, rho):
    """The nearest point of {lo <= u <= hi, ||u|| <= rho} to each v (..., 2),
    numpy: the nearest feasible one of v, its projections onto the box and
    onto the ball, and the points where the circle meets the box's edges
    (the projection lies on both boundaries where neither projection alone
    is feasible)."""
    cands = [v, np.clip(v, lo, hi), rho * v / np.linalg.norm(v, axis=-1, keepdims=True)]
    for axis in (0, 1):
        for b in (lo, hi):
            other = np.sqrt(max(rho ** 2 - b ** 2, 0.0))
            for sign in (-1.0, 1.0):
                c = np.empty_like(v)
                c[..., axis], c[..., 1 - axis] = b, sign * other
                cands.append(c)
    cands = np.stack(cands)  # (k, ..., 2)
    ok = ((cands >= lo - 1e-12) & (cands <= hi + 1e-12)).all(-1) \
        & (np.linalg.norm(cands, axis=-1) <= rho + 1e-12)
    dist = np.where(ok, np.linalg.norm(cands - v, axis=-1), np.inf)
    return np.take_along_axis(cands, dist.argmin(0)[None, ..., None], 0)[0]


QP_CASES = {"cones_only": (-10.0, 10.0, 0.9), "box_and_cones": (-1.0, 1.0, 1.2),
            "r_below_box": (-1.0, 1.0, 0.5)}


@pytest.mark.parametrize("case", list(QP_CASES))
def test_cone_qp_meets_a_projected_gradient_oracle(case):
    """M = 2, Nc = 1, N = 2: the shared stage and each particle's free one;
    the oracle runs projected gradient over each stage's box and ball for
    20,000 steps in float64."""
    lo_u, hi_u, rho = QP_CASES[case]
    L, M, d = 8, 2, 2
    nc = nf = d
    g = torch.Generator().manual_seed(7)
    A = torch.randn(L, M, nc + nf, nc + nf, generator=g, dtype=torch.float64)
    H = reference.Arrow.of_particles(0.3 * A @ A.mT + torch.eye(nc + nf, dtype=torch.float64),
                                     nc)
    n, S = nc + M * nf, (nc + M * nf) // d
    q = 4.0 * torch.randn(L, n, generator=g, dtype=torch.float64)
    u0 = torch.from_numpy(project_2d(0.4 * torch.randn(L, S, d, generator=g,
                                                        dtype=torch.float64).numpy(),
                                     lo_u, hi_u, rho))
    w, _ = reference.cone_qp(H, q, lo_u - u0.flatten(1), hi_u - u0.flatten(1), u0, rho,
                             1e-14)
    Hd = torch.zeros(L, n, n, dtype=torch.float64)
    for i in range(n):
        Hd[:, :, i] = H.mv(torch.eye(n, dtype=torch.float64)[i].expand(L, n))
    Hd, qd, u0d = Hd.numpy(), q.numpy(), u0.numpy()
    step = 1.0 / np.linalg.eigvalsh(Hd)[:, -1:]
    x = np.zeros((L, n))
    for _ in range(20000):
        y = x - step * (np.einsum("lij,lj->li", Hd, x) + qd)
        x = (project_2d(u0d + y.reshape(L, S, d), lo_u, hi_u, rho) - u0d).reshape(L, n)
    assert np.abs(w.numpy() - x).max() < 1e-9
    u = u0d + x.reshape(L, S, d)
    on_ball = np.abs(np.linalg.norm(u, axis=-1) - rho) < 1e-9
    on_box = (np.abs(u - lo_u) < 1e-9).any(-1) | (np.abs(u - hi_u) < 1e-9).any(-1)
    assert on_ball.any()
    assert (on_ball & on_box).any() == (case == "box_and_cones")
    assert not on_box.any() or case == "box_and_cones"


def test_project_meets_the_oracles_projection():
    v = 2.0 * torch.randn(500, 2, generator=torch.Generator().manual_seed(3),
                          dtype=torch.float64)
    for lo, hi, rho in [(-1.0, 1.0, 0.9), (-1.0, 1.0, 1.2), (-0.5, 1.0, 0.8)]:
        assert np.abs(reference.project(v, lo, hi, rho).numpy()
                      - project_2d(v.numpy(), lo, hi, rho)).max() < 1e-12


# (b) the reference against the program -----------------------------------


@pytest.mark.parametrize("M,Nc", [(1, 0), (3, 2)], ids=["one_car", "consensus"])
def test_reference_meets_the_programs_cone_solver(M, Nc):
    cfg = find.cell(CELL, cone_spec())["config"]
    cfg = dict(cfg, M=M, N=8, Nc=Nc, dtype="float64",
               solver=dict(cfg["solver"], res_tol=1e-8, max_it=200, ipm_iters=40,
                           ipm_tol_exp=-12))
    rng = np.random.default_rng(0)
    B, r = 3, cfg["u_soc_r"]
    x0 = torch.from_numpy(np.ones((B, M, 4)) + 0.05 * rng.normal(size=(B, M, 4))
                          + 0.05 * rng.normal(size=(B, 1, 4)))
    data = program.inputs(cfg, B, torch.device("cpu"))._replace(x0=x0)
    X, U, info = program.build(cfg)(data)
    assert info["converged"].all()
    U_star, X_star, conv, _ = reference.solve(
        program.dynamics(cfg), x0, data.X_ref, data.U_ref, cfg["q"], cfg["r"], cfg["u_lo"],
        cfg["u_hi"], cfg["Nc"], 1e-10, 40, 1e-12, soc_r=r)
    assert conv.all()
    assert (U - U_star).abs().max() < 1e-6
    assert (X - X_star).abs().max() < 1e-6
    for V in (U, U_star):  # the cone binds: some stage on it, none past it
        assert ((V.norm(dim=-1) - r).abs() < 1e-8).any()
        assert V.norm(dim=-1).max() < r + 1e-8


def test_reference_holds_box_and_cone_where_both_bind():
    """r = 1.2 over the box +-1: stages at a corner of the box and the
    sphere, the reference converged and at a point the program shares."""
    cfg = find.cell(CELL, cone_spec())["config"]
    cfg = dict(cfg, M=1, N=8, Nc=0, dtype="float64", u_soc_r=1.2,
               solver=dict(cfg["solver"], res_tol=1e-8, max_it=200, ipm_iters=40,
                           ipm_tol_exp=-12))
    x0 = torch.from_numpy(np.ones((2, 1, 4)) + 0.05 * np.random.default_rng(1)
                          .normal(size=(2, 1, 4)))
    data = program.inputs(cfg, 2, torch.device("cpu"))._replace(x0=x0)
    X, U, info = program.build(cfg)(data)
    U_star, _, conv, _ = reference.solve(
        program.dynamics(cfg), x0, data.X_ref, data.U_ref, cfg["q"], cfg["r"], -1.0, 1.0, 0,
        1e-10, 40, 1e-12, soc_r=1.2)
    assert conv.all() and info["converged"].all()
    assert (U - U_star).abs().max() < 1e-6
    both = ((U_star.norm(dim=-1) - 1.2).abs() < 1e-10) & (U_star.abs() > 1 - 1e-10).any(-1)
    assert both.any()


# (c) the box-only path, bit for bit ---------------------------------------


def box_only_outputs():
    """What ``program.inputs``, ``reference.solve``, ``check.judge`` and
    ``control.build`` compute at a tiny size of ``m32n30.b64`` (box only):
    the inputs and answers judged are in the recording itself."""
    torch.set_num_threads(2)
    rec = torch.load(RECORDING)
    cell = tiny_cell(CELL, M=3, N=6, Nc=2, B=3, sample=2)
    cfg = cell["config"]
    data = program.inputs(cfg, 3, torch.device("cpu"))
    out = dict(inputs={k: v for k, v in data._asdict().items() if v is not None})
    ans = rec["ans"]
    out["solve"] = reference.solve(program.dynamics(cfg), ans["x0"], ans["X_ref"],
                                   ans["U_ref"], cfg["q"], cfg["r"], cfg["u_lo"], cfg["u_hi"],
                                   cfg["Nc"], check.REF_TOL, check.REF_MAX_IT,
                                   check.REF_QP_TOL)
    numbers, correct, failed, notes = check.judge(cfg, cell["check"], ans, 2**31 + 5)
    out["judge"] = dict(numbers=numbers, correct=correct, failed=failed, notes=notes)
    X, U, info = control.build(cfg)(data._replace(x0=ans["x0"].float()))
    out["control"] = (X, U, info["converged"], info["iters"])
    return out


def same(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_box_only_path_repeats_its_recording_bit_for_bit():
    """The recording was made by the box-only benchmark's code, before the
    cones: a configuration without ``u_soc_r`` computes what it computed."""
    rec = torch.load(RECORDING)
    out = box_only_outputs()
    for key in ("inputs", "solve", "judge", "control"):
        assert same(out[key], rec[key]), key


# (d) planted faults through the harness ----------------------------------


def box_only(cfg):
    """The program's box-only solver: the answer that ignores the cone."""
    return program.build(dict(cfg, solver=dict(cfg["solver"], has_u_soc=False)))


def off_cone(cfg):
    """Lane 0's stage of largest norm pushed out to r + 2 soc_tol."""
    solver = program.build(cfg)

    def broken(data):
        X, U, info = solver(data)
        U = U.clone()
        norm = U[0].norm(dim=-1)
        m, j = divmod(int(norm.argmax()), norm.shape[1])
        U[0, m, j] *= (cfg["u_soc_r"] + 2 * cfg["soc_tol"]) / norm[m, j]
        return X, U, info
    return broken


def shrunk(cfg):
    """Every control shrunk radially by 10%: inside the cone, not optimal."""
    solver = program.build(cfg)

    def broken(data):
        X, U, info = solver(data)
        return X, 0.9 * U, info
    return broken


def swapped(cfg):
    """Lane 0's answer swapped with lane 1's."""
    solver = program.build(cfg)

    def broken(data):
        X, U, info = solver(data)
        order = torch.arange(U.shape[0])
        order[:2] = torch.tensor([1, 0])
        return X[order], U[order], info
    return broken


@pytest.mark.parametrize("fault", [box_only, off_cone, shrunk, swapped],
                         ids=lambda f: f.__name__)
def test_a_cone_fault_is_not_correct(fault):
    res, numbers, _ = run_tiny(CELL, build=fault, spec=cone_spec())
    assert res["correct"] is False, numbers


def test_a_cone_fault_is_caught_by_its_own_number():
    """The push off the cone by 2 soc_tol moves U by far less than u_err's
    limit: only the cone's rule in ``failed`` sees it."""
    res, numbers, notes = run_tiny(CELL, build=off_cone, spec=cone_spec())
    assert numbers["failed"][0] >= 1 and numbers["u_err"][0] < numbers["u_err"][1], numbers
    assert notes["cone_excess_max"] == pytest.approx(2e-5, rel=1e-2)


def test_the_cone_solver_is_correct():
    res, numbers, notes = run_tiny(CELL, spec=cone_spec())
    assert res["correct"] is True and res["failed"] == 0, numbers
    assert notes["reference_converged"] == notes["sampled"]
    assert notes["cone_excess_max"] <= 1e-5


# (e) the inputs and the control carry the radius --------------------------


@pytest.mark.parametrize("cone", [False, True], ids=["box_only", "cone"])
def test_inputs_carry_the_radius_only_where_stated(cone):
    cfg = find.cell(CELL, cone_spec() if cone else None)["config"]
    data = program.inputs(dict(cfg, M=3, N=4), 2, torch.device("cpu"))
    if not cone:
        assert data.u_soc_r is None
        return
    assert data.u_soc_r.shape == (2, 3, 4) and data.u_soc_r.dtype == torch.float32
    assert (data.u_soc_r == cfg["u_soc_r"]).all()


def test_control_holds_the_cone():
    """The control (the reference in the configuration's precision, here on
    the CPU without TF32) gets the radius: its answers keep to the cone."""
    cell = tiny_cell(CELL, M=3, N=6, Nc=2, B=2, spec=cone_spec())
    cfg = cell["config"]
    x0 = torch.ones(2, 3, 4) + 0.05 * torch.randn(2, 3, 4, generator=torch.Generator()
                                                  .manual_seed(5))
    data = program.inputs(cfg, 2, torch.device("cpu"))._replace(x0=x0)
    _, U, _ = control.build(cfg)(data)
    assert U.norm(dim=-1).max() <= cfg["u_soc_r"] + 1e-5
