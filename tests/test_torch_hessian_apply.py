"""The box IPM's factored Hessian apply, kernel K5 (`pmpc_tpu_torch.ops.hessian_apply`).

On the CPU: the plain route is today's formula bit for bit, CPU calls are not
launches, the graph tally counts K5 as it counts K1-K4, `dynamics.condense`
builds Ft's upper blocks as exact zeros (the kernel's precondition), and the
kernel's one-pass walk, written out in torch (`_one_pass`), matches the plain
version. On the card (the ``cuda`` marker): the kernel against the plain
version at the benchmark's shapes and at odd ones, the NaN contract, what the
wrapper refuses, a graph's replay, and one launch a box-IPM iteration. No
JAX is imported, so the card's cases run where it is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_hessian_apply.py
"""

import re

import pytest
import torch

from pmpc_tpu_torch import graphs
from pmpc_tpu_torch.dynamics import condense
from pmpc_tpu_torch.ops import chol_inv, hessian_apply
from pmpc_tpu_torch.solvers.reduced import H_apply_factored, assemble_condensed, z_to_w
from torch_graph_standins import cuda, headline  # noqa: F401

torch.set_num_threads(2)

# the benchmark's pattern (``hessian_apply_us.batch``)
K5 = re.compile(r"\bhessian_apply_kernel<")


def _formula(cqp, uc, uf):
    """`H_apply_factored` as it was written before K5: the reference of the
    plain route, bit for bit."""
    N, xdim = cqp.Qt.shape[-3], cqp.Qt.shape[-1]
    udim = cqp.Rt.shape[-1]
    nc = cqp.nc
    w = z_to_w(uc, uf)
    lead = w.shape[:-1]
    Ftw = (cqp.Ft @ w[..., None])[..., 0]
    QFtw = (cqp.Qt @ Ftw.reshape(lead + (N, xdim, 1))).reshape(lead + (-1,))
    Hw = (QFtw[..., None, :] @ cqp.Ft)[..., 0, :]
    U = w.reshape(lead + (N, udim))
    Hw = Hw + (cqp.Rt @ U[..., None]).reshape(lead + (-1,))
    d = U[..., 1:, :] - U[..., :-1, :]
    Sw = torch.zeros_like(U)
    Sw[..., :-1, :] -= d
    Sw[..., 1:, :] += d
    Hw = Hw + cqp.sl_reg[..., None] * Sw.reshape(lead + (-1,))
    Hw[..., :udim] += cqp.sl_reg0[..., None] * U[..., 0, :]
    return Hw[..., :nc].sum(dim=-2), Hw[..., nc:]


def _qp(B, M, N, xdim, udim, Nc, dtype, device="cpu", seed=0):
    """A condensed QP from random dynamics, with slew terms and particle
    weights (so sl_reg, sl_reg0 and the costs differ by particle), and a
    random iterate: (cqp, uc, uf)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    lead = (B, M)
    x0, f = r(*lead, xdim), r(*lead, N, xdim)
    fx = torch.eye(xdim, dtype=torch.float64) + 0.1 / xdim ** 0.5 * r(*lead, N, xdim, xdim)
    fu = r(*lead, N, xdim, udim)
    X_prev, U_prev = r(*lead, N, xdim), r(*lead, N, udim)
    G = r(*lead, N, xdim, xdim)
    Q = G @ G.mT / xdim + torch.eye(xdim, dtype=torch.float64)
    R = torch.eye(udim, dtype=torch.float64).expand(lead + (N, udim, udim)) * 0.1
    u = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64) + 0.5
    args = [x0, f, fx, fu, X_prev, U_prev, Q, R, r(*lead, N, xdim), r(*lead, N, udim),
            u(*lead), 0.01 * u(*lead), u(*lead), u(*lead), r(*lead, udim)]
    cqp = assemble_condensed(*(a.to(device, dtype) for a in args), Nc=Nc,
                             weights=u(*lead).to(device, dtype))
    nc = Nc * udim
    return cqp, r(B, nc).to(device, dtype), r(B, M, N * udim - nc).to(device, dtype)


def _ins(cqp, uc, uf):
    return cqp.Ft, cqp.Qt, cqp.Rt, cqp.sl_reg, cqp.sl_reg0, uc, uf


def _one_pass(Ft, Qt, Rt, sl_reg, sl_reg0, uc, uf):
    """The kernel's walk in torch: row block j reads only its lower columns
    (< (j + 1) udim), y_j, v_j = Qt_j y_j and the column sums z from the
    same block, then the epilogue's Rt w and slew terms column by column."""
    N, xdim = Qt.shape[-3], Qt.shape[-1]
    udim = Rt.shape[-1]
    NU = N * udim
    w = z_to_w(uc, uf)
    z = torch.zeros_like(w)
    for j in range(N):
        L = (j + 1) * udim
        Fj = Ft[..., j * xdim:(j + 1) * xdim, :L]
        y = (Fj @ w[..., :L, None])[..., 0]
        v = (Qt[..., j, :, :] @ y[..., None])[..., 0]
        z[..., :L] += (Fj.mT @ v[..., None])[..., 0]
    out = torch.empty_like(z)
    for c in range(NU):
        l, b = divmod(c, udim)
        rw = (Rt[..., l, b, :] * w[..., l * udim:(l + 1) * udim]).sum(-1)
        s = torch.zeros_like(rw)
        if l < N - 1:
            s = s - (w[..., c + udim] - w[..., c])
        if l > 0:
            s = s + (w[..., c] - w[..., c - udim])
        h = z[..., c] + rw + sl_reg * s
        out[..., c] = h + sl_reg0 * w[..., c] if l == 0 else h
    return out


# -- on the CPU -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,M,N,xdim,udim,Nc", [(2, 3, 6, 4, 2, 2), (1, 2, 5, 3, 1, 0),
                                                (2, 1, 4, 2, 2, 4), (3, 2, 1, 3, 1, 1)])
def test_cpu_route_is_the_formula_bit_for_bit(dtype, B, M, N, xdim, udim, Nc):
    """The CPU route computes what `H_apply_factored` computed before K5, in
    the same operations: equal bits (nc = 0 and nf = 0 among the shapes)."""
    cqp, uc, uf = _qp(B, M, N, xdim, udim, Nc, dtype)
    Hc, Hf = H_apply_factored(cqp, uc, uf)
    Hc0, Hf0 = _formula(cqp, uc, uf)
    assert torch.equal(Hc, Hc0) and torch.equal(Hf, Hf0)


def test_cpu_calls_are_not_launches():
    cqp, uc, uf = _qp(2, 3, 6, 4, 2, 2, torch.float64)
    before = dict(hessian_apply.LAUNCHES)
    hessian_apply.hessian_apply(*_ins(cqp, uc, uf))
    H_apply_factored(cqp, uc, uf)
    assert hessian_apply.LAUNCHES == before


def test_tally_counts_a_capture_once_a_replay():
    """Launches inside `tally` (a capture) are held apart, and each
    `count_replay` adds them once, as `chol_inv` does for K1-K4."""
    before = hessian_apply.LAUNCHES["hessian_apply"]
    with hessian_apply.tally() as launches:
        for _ in range(3):
            hessian_apply._count()
    assert launches == [3] and hessian_apply.LAUNCHES["hessian_apply"] == before
    for _ in range(2):
        hessian_apply.count_replay(launches)
    assert hessian_apply.LAUNCHES["hessian_apply"] == before + 6


@pytest.mark.parametrize("N,xdim,udim", [(1, 3, 1), (7, 4, 2), (12, 3, 2), (9, 6, 3)])
def test_condense_upper_blocks_are_exact_zeros(N, xdim, udim):
    """For finite inputs `condense` builds Ft[j, l] = 0 for l > j exactly:
    the kernel reads only the lower blocks."""
    g = torch.Generator().manual_seed(N)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        Ft, _ = condense(*(a.to(dtype) for a in (r(2, 3, xdim), r(2, 3, N, xdim),
                                                  r(2, 3, N, xdim, xdim), r(2, 3, N, xdim, udim),
                                                  r(2, 3, N, xdim), r(2, 3, N, udim))))
        blocks = Ft.reshape(2, 3, N, xdim, N, udim)
        upper = torch.triu(torch.ones(N, N, dtype=torch.bool), 1)
        assert torch.isfinite(Ft).all()
        assert (blocks.permute(0, 1, 3, 5, 2, 4)[..., upper] == 0).all()
        assert (blocks.permute(0, 1, 3, 5, 2, 4)[..., ~upper] != 0).any()


@pytest.mark.parametrize("B,M,N,xdim,udim,Nc", [(2, 3, 6, 4, 2, 2), (1, 2, 5, 3, 1, 0),
                                                (2, 1, 4, 2, 2, 4), (3, 2, 1, 3, 1, 1),
                                                (1, 2, 9, 6, 3, 3)])
def test_one_pass_walk_matches_plain(B, M, N, xdim, udim, Nc):
    """The kernel's arithmetic (lower blocks only, the epilogue's slew terms
    built column by column) against the plain formula in f64: equal to
    rounding, 1e-12 relative."""
    cqp, uc, uf = _qp(B, M, N, xdim, udim, Nc, torch.float64)
    ins = _ins(cqp, uc, uf)
    ref = hessian_apply.hessian_apply_plain(*ins)
    assert (_one_pass(*ins) - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_the_benchmarks_reader_divides_k5_time_by_box_ipm_iterations():
    """``hessian_apply_us.batch``: K5's traced device time (ns in the trace)
    over the K1 and K3 launches, in us; nothing where K5 has no event (a
    program without it), no trace or no IPM iteration."""
    from portbench import find

    read = find.module("metrics", "hessian_apply_us.batch").read
    events = [("void (anonymous namespace)::hessian_apply_kernel<float, 4, true>(...)", 0, 3000),
              ("void (anonymous namespace)::hessian_apply_kernel<double, 2, true>(...)", 9, 5000),
              ("void gemvx<float, true>(...)", 20, 7000)]
    rec = dict(trace=dict(events=events), launches=dict(inv_cholesky_diag=3,
                                                        inv_cholesky_diag_big=1))
    assert read(rec) == pytest.approx(2.0)
    assert read(dict(rec, trace=dict(events=events[2:]))) is None
    assert read(dict(rec, trace=None)) is None
    assert read(dict(rec, launches={})) is None


# -- on the card ------------------------------------------------------------------

def _check(ins, tol):
    """Kernel against the plain version on the card, both against the plain
    version in f64 from the same inputs: the kernel's error within ``tol`` of
    the answer's size (f32 sums over ~N udim + N xdim terms of size ~1 round at
    ~1e-7 each, so 1e-5 of the largest entry; f64 1e-12)."""
    out = hessian_apply.hessian_apply(*ins)
    ref = hessian_apply.hessian_apply_plain(*(a.double() for a in ins))
    torch.cuda.synchronize()
    assert out.dtype == ins[0].dtype and out.shape == ref.shape
    scale = ref.abs().max().item()
    err = (out.double() - ref).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N,dtype", [(64, 32, 30, torch.float32),
                                         (1024, 32, 30, torch.float32),
                                         (256, 64, 50, torch.float64)])
def test_kernel_matches_plain_at_the_cells_shapes(cuda, B, M, N, dtype):
    """B M = 2,048 and 32,768 at N = 30 in f32, 16,384 at N = 50 in f64
    (xdim 4, udim 2, Nc 5): the benchmark's three cells, with slew terms and
    particle weights."""
    cqp, uc, uf = _qp(B, M, N, 4, 2, 5, dtype, device=cuda)
    before = hessian_apply.LAUNCHES["hessian_apply"]
    _check(_ins(cqp, uc, uf), {torch.float32: 1e-5, torch.float64: 1e-12}[dtype])
    assert hessian_apply.LAUNCHES["hessian_apply"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,M,N,xdim,udim,Nc", [
    (3, 5, 1, 4, 2, 1),  # N = 1
    (3, 5, 12, 3, 1, 3),  # udim = 1, xdim = 3, NU = 12
    (2, 4, 31, 4, 1, 5),  # NU = 31: no 16-byte loads
    (4, 3, 10, 4, 2, 0),  # nc = 0
    (4, 3, 10, 4, 2, 10),  # nf = 0
    (2, 3, 9, 6, 3, 3),  # xdim 6: the tiled path
    (2, 2, 140, 4, 2, 5)])  # N = 140: the tiled path, rows of several tiles
def test_kernel_matches_plain_at_odd_shapes(cuda, dtype, B, M, N, xdim, udim, Nc):
    cqp, uc, uf = _qp(B, M, N, xdim, udim, Nc, dtype, device=cuda, seed=N)
    _check(_ins(cqp, uc, uf), {torch.float32: 1e-5, torch.float64: 1e-12}[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["Ft", "uf"])
def test_kernel_nan_contract(cuda, where):
    """A NaN in a lower entry of particle (1, 2)'s Ft (what a non-finite fx
    makes) or in its free controls makes its Hw non-finite, as the formula's
    is; every other particle's Hw keeps its bits."""
    cqp, uc, uf = _qp(3, 4, 8, 4, 2, 2, torch.float32, device=cuda)
    clean = hessian_apply.hessian_apply(*_ins(cqp, uc, uf))
    if where == "Ft":
        Ft = cqp.Ft.clone()
        Ft[1, 2, 4 * 5 + 1, 2 * 3] = torch.nan  # row block 5, column block 3
        cqp = cqp._replace(Ft=Ft)
    else:
        uf = uf.clone()
        uf[1, 2, 7] = torch.nan
    ins = _ins(cqp, uc, uf)
    out, ref = hessian_apply.hessian_apply(*ins), hessian_apply.hessian_apply_plain(*ins)
    assert not torch.isfinite(out[1, 2]).all() and not torch.isfinite(ref[1, 2]).all()
    keep = torch.ones(3, 4, dtype=torch.bool)
    keep[1, 2] = False
    assert torch.equal(out[keep], clean[keep])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    cqp, uc, uf = _qp(2, 3, 6, 4, 2, 2, torch.float32, device=cuda)
    ins = list(_ins(cqp, uc, uf))
    bad = {"Ft": cqp.Ft.mT.contiguous().mT,  # the right shape, not contiguous
           "Qt": cqp.Qt.double(),  # another dtype than Ft's
           "Rt": cqp.Rt[..., :1, :1].contiguous()}  # another udim than uf's
    for i, name in enumerate(("Ft", "Qt", "Rt")):
        args = list(ins)
        args[i] = bad[name]
        with pytest.raises(ValueError, match=name):
            hessian_apply.hessian_apply(*args)
    with pytest.raises(NotImplementedError):
        hessian_apply.hessian_apply(*(a.half() for a in ins))


@pytest.mark.cuda
def test_graph_replay_is_the_eager_launch(cuda):
    """`graphs.Captured` over the kernel: each replay gives the eager
    launch's bits on new inputs and counts one launch."""
    cqp, uc, uf = _qp(8, 32, 30, 4, 2, 5, torch.float32, device=cuda)
    ins = _ins(cqp, uc, uf)
    hessian_apply.hessian_apply(*ins)  # the kernel loaded before the capture
    graph = graphs.Captured(hessian_apply.hessian_apply, ins)
    assert graph.k5_launches == [1]
    for seed in (1, 2, 3):
        new = _ins(*_qp(8, 32, 30, 4, 2, 5, torch.float32, device=cuda, seed=seed))
        eager = hessian_apply.hessian_apply(*new)
        graph.copy_in(new)
        before = hessian_apply.LAUNCHES["hessian_apply"]
        out = graph.replay()
        torch.cuda.synchronize()
        assert hessian_apply.LAUNCHES["hessian_apply"] == before + 1
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_one_launch_a_box_ipm_iteration(cuda):
    """Over one call of the headline solver (B = 64, on the IPM's and the
    linearization's graph paths after a warm-up call): K5 launches equal K1
    launches, and the profiler's K5 events equal the counter's increase."""
    solver, data = headline(cuda)
    solver(data)
    torch.cuda.synchronize()
    k1, k5 = chol_inv.LAUNCHES["inv_cholesky_diag"], hessian_apply.LAUNCHES["hessian_apply"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solver(data)
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and K5.search(e.name())]
    n = hessian_apply.LAUNCHES["hessian_apply"] - k5
    assert n == chol_inv.LAUNCHES["inv_cholesky_diag"] - k1 > 0
    assert len(events) == n
