"""User extra cone constraints: canonicalization, stage-cone detection and
the cross-particle terminal cost.

Twin of ``pmpc_tpu/solvers/extras.py`` (the reference's ``extra_cstrs``,
``PMPC.jl/src/cone_utils.jl:99-170``): each constraint is a tuple

    (l, q, e, G_left, G_right, h, c_left, c_right)

with ``G_left`` over the canonical consensus variable ``z_full = [u_cons;
u_free_1..M; x_1..M]``, ``G_right`` over fresh auxiliary variables, ``l``
leading nonnegative rows, ``q`` a list of SOC sizes and ``e`` a count of
3-dim exponential cones. The program assembly and solve live in
`solvers.compose`; this module keeps the host pieces: tuple validation,
stage-cone detection, the terminal cross cost and the scipy solve of programs
with exponential cones (`_solve_exp_host`), the serial exp branch's fallback.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .compose import x_map
from .reduced import CondensedQP


def terminal_cross_cost(cqp: CondensedQP, N: int, xdim: int, Hf, hf=None):
    """Dense (H, q) updates (B, nz, nz), (B, nz) from a cross-particle
    terminal cost 0.5 xN' Hf xN + hf' xN over the stacked final states xN
    (M*xdim,) of each lane; Hf (B, M*xdim, M*xdim) or one matrix for all
    lanes, hf (B, M*xdim) or None (``lqp_utils.jl:105-163,192-204``)."""
    B, M, nc, nf = cqp.Hcc.shape[0], cqp.M, cqp.nc, cqp.nf
    nz = nc + M * nf
    dt, dev = cqp.qf.dtype, cqp.qf.device
    Xmap, xoff = x_map(cqp)
    # the rows selecting each particle's final state
    S = Xmap.reshape(B, M, N, xdim, nz)[:, :, N - 1].reshape(B, M * xdim, nz)
    s0 = xoff.reshape(B, M, N, xdim)[:, :, N - 1].reshape(B, M * xdim)
    Hf = torch.as_tensor(Hf, dtype=dt, device=dev).expand(B, M * xdim, M * xdim)
    hf = torch.zeros((B, M * xdim), dtype=dt, device=dev) if hf is None \
        else torch.as_tensor(hf, dtype=dt, device=dev).reshape(-1, M * xdim).expand(B, -1)
    H_extra = S.mT @ Hf @ S
    q_extra = ((Hf @ s0[..., None])[..., 0] + hf)[..., None, :] @ S
    return H_extra, q_extra[..., 0, :]


def _canon_extras(extra_cstrs, n_full) -> Tuple[Tuple, Tuple]:
    """Canonicalize user tuples once on the host: numpy shapes cleaned up,
    split into a static signature and the arrays."""
    sig, arrays = [], []
    for ec in (extra_cstrs or []):
        l, qsizes, e, G_left, G_right, h, c_left, c_right = tuple(ec)
        G_left = np.asarray(G_left, dtype=float)
        if G_left.ndim == 1:
            G_left = G_left[None, :]
        assert G_left.shape[1] == n_full, (
            f"extra constraint G_left has {G_left.shape[1]} cols, expected "
            f"{n_full} (consensus layout [u_cons; u_free_1..M; x_1..M])")
        h = np.asarray(h, dtype=float).reshape(-1)
        G_right = np.asarray(G_right, dtype=float)
        if G_right.ndim != 2:
            G_right = G_right[:, None] if G_right.size else \
                G_right.reshape(len(h), 0)
        c_left = np.asarray(c_left, dtype=float).reshape(-1)
        c_right = np.asarray(c_right, dtype=float).reshape(-1)
        qsizes = tuple(int(s) for s in np.asarray(qsizes).reshape(-1))
        n_rows = int(l) + sum(qsizes) + 3 * int(e)
        # under- or over-declared rows would be silently cut or ignored
        if G_left.shape[0] != n_rows or h.shape[0] != n_rows \
                or G_right.shape[0] != n_rows:
            raise ValueError(
                f"extra constraint declares l={int(l)}, q={qsizes}, "
                f"e={int(e)} -> {n_rows} rows, but G_left has "
                f"{G_left.shape[0]}, G_right {G_right.shape[0]}, "
                f"h {h.shape[0]}")
        if c_right.size != G_right.shape[1]:
            raise ValueError(
                f"extra constraint c_right has {c_right.size} entries for "
                f"{G_right.shape[1]} auxiliary variables")
        sig.append((int(l), qsizes, int(e), int(G_right.shape[1])))
        arrays.append((G_left, G_right, h, c_left, c_right))
    return tuple(sig), tuple(arrays)


def _solve_exp_host(H, q, Gl, hl, soc_blocks, exp_blocks):
    """Host (scipy trust-constr) solve of one dense cone QP with exp cones,
    numpy in and out: (v, converged).

    Exp cone (ECOS convention, ``cone_utils.jl:184-188``): the slack triple
    s = h - Gv lies in closure{(x, y, z): exp(x/z) <= y/z, z > 0}, i.e.
    z log(y/z) >= x with y, z > 0: a concave constraint function, so the
    program stays convex."""
    import scipy.optimize as sopt

    nv = q.shape[0]
    H, q = np.asarray(H, float), np.asarray(q, float)
    cons = []
    Gl, hl = np.asarray(Gl, float), np.asarray(hl, float)
    if Gl.shape[0]:
        cons.append(sopt.LinearConstraint(Gl, -np.inf, hl))
    for qsizes, Gc, hc in soc_blocks:
        Gc, hc = np.asarray(Gc, float), np.asarray(hc, float)
        r = 0
        for sz in qsizes:
            G, h = Gc[r:r + sz], hc[r:r + sz]
            r += sz

            def soc_fun(v, G=G, h=h):
                s = h - G @ v
                return s[0] - np.linalg.norm(s[1:])

            cons.append(sopt.NonlinearConstraint(soc_fun, 0.0, np.inf))
    eps = 1e-12
    for G, h in exp_blocks:
        G, h = np.asarray(G, float), np.asarray(h, float)
        # domain: y, z > 0 (linear rows), cone: z log(y/z) - x >= 0
        cons.append(sopt.LinearConstraint(-G[1:], eps - h[1:], np.inf))

        def exp_fun(v, G=G, h=h):
            s = h - G @ v
            y, z = max(s[1], eps), max(s[2], eps)
            return z * np.log(y / z) - s[0]

        cons.append(sopt.NonlinearConstraint(exp_fun, 0.0, np.inf))
    res = sopt.minimize(
        lambda v: 0.5 * v @ H @ v + q @ v, np.zeros(nv),
        jac=lambda v: H @ v + q,
        constraints=cons, method="trust-constr",
        options=dict(maxiter=5000, gtol=1e-10, xtol=1e-12))
    # status 1 (gtol) / 2 (xtol) are converged; 0 (maxiter) / 3 are not
    return res.x, res.status in (1, 2) and np.isfinite(res.x).all()


def split_stage_u_cones(sig, arrays, M, N, Nc, udim):
    """Recognize extras SOC blocks as per-stage control-norm cones
    ``||c u_ij|| <= r`` (``h = [r; 0..]``, rows 1..udim carrying ``c I`` on
    one stage's contiguous control slice), numpy.

    Returns ``(r_arr (M, N) with +inf where no cone, lin_G (l, n_full),
    lin_h (l,))`` when every SOC block of every tuple matches and nothing
    else is conic (no exp rows, no aux variables, no cost terms); None
    otherwise. A consensus-stage cone applies to the shared control and is
    recorded for every particle."""
    nc, nf = Nc * udim, (N - Nc) * udim
    r_arr = np.full((M, N), np.inf)
    lin_G, lin_h = [], []
    any_cone = False
    n_cols = None
    for (l, qsizes, e, na), (G_l, G_r, h, c_l, c_r) in zip(sig, arrays):
        if e or na:
            return None
        if np.any(np.asarray(c_l) != 0.0):
            return None
        if np.asarray(c_r).size and np.any(np.asarray(c_r) != 0.0):
            return None
        G_l = np.asarray(G_l, float)
        h = np.asarray(h, float)
        n_cols = G_l.shape[1]
        if l:
            lin_G.append(G_l[:l])
            lin_h.append(h[:l])
        if not qsizes:
            continue
        p = udim + 1
        if any(s != p for s in qsizes):
            return None
        c = len(qsizes)
        Gq = G_l[l:l + c * p].reshape(c, p, n_cols)
        hq = h[l:l + c * p].reshape(c, p)
        if np.any(Gq[:, 0, :] != 0.0) or np.any(hq[:, 1:] != 0.0):
            return None
        body = Gq[:, 1:, :]  # (c, udim, n_cols)
        nzmask = body != 0.0
        if not np.all(nzmask.sum(axis=2) == 1):
            return None
        cols = nzmask.argmax(axis=2)  # (c, udim)
        starts = cols[:, 0]
        if not np.array_equal(cols, starts[:, None] + np.arange(udim)):
            return None
        vals = np.take_along_axis(body, cols[..., None], axis=2)[..., 0]
        c0 = vals[:, 0]
        if np.any(c0 == 0.0) or not np.allclose(vals, c0[:, None]):
            return None
        r = hq[:, 0] / np.abs(c0)
        if not np.all(np.isfinite(r) & (r > 0)):
            return None
        cons = starts < nc
        if np.any(starts[cons] % udim):
            return None
        s2 = starts[~cons] - nc
        if np.any(s2 >= M * nf) or np.any((s2 % nf) % udim):
            return None
        for st, rr in zip(starts[cons], r[cons]):
            j = int(st // udim)
            r_arr[:, j] = np.minimum(r_arr[:, j], rr)
        i_f, rem = np.divmod(s2, nf)
        j_f = Nc + rem // udim
        for ii, jj, rr in zip(i_f, j_f, r[~cons]):
            r_arr[ii, jj] = min(r_arr[ii, jj], rr)
        any_cone = True
    if not any_cone:
        return None
    lg = np.concatenate(lin_G, axis=0) if lin_G else np.zeros((0, n_cols))
    lh = np.concatenate(lin_h) if lin_h else np.zeros((0,))
    return r_arr, lg, lh
