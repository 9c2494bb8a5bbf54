"""The composed dense cone program over the condensed consensus variable.

Twin of ``pmpc_tpu/solvers/compose.py``. The reference composes every
constraint flavor into one conic program (``PMPC.jl/src/main.jl:204-317``):
the k-worst (CVaR) epigraph objective, box bounds (optionally smoothed,
``cone_utils.jl:204-232``), user ``extra_cstrs`` splices
(``cone_utils.jl:99-170``) and per-stage control-norm cones. This module
assembles the same program densely over the condensed variable (states
eliminated through ``x = Xmap z + xoff``) and solves it with

- the NT-scaled cone IPM (`coneipm.cone_qp_solve`) when the program has only
  nonnegative and SOC cones, or
- the central-path barrier method (`expbarrier.exp_barrier_solve`) when
  exponential cones are present (logbarrier smoothing, user ``e`` rows),
  with a scipy host solve (`extras._solve_exp_host`) as the serial solve's
  fallback when the barrier run does not converge.

Every function works over an explicit leading batch axis B; the serial host
solve `composed_cone_solve` is the same code at B = 1.

Variable layout of the composed program:

    v = [ z (nz = nc + M*nf) ;        condensed consensus controls
          y_1..y_M, t (cvar only) ;   k-worst epigraph variables
          aux (extras' G_right) ;     user auxiliary variables
          t_1..t_s (smoothing) ]      one epigraph var per smoothed row

Smoothing (``smoothen_linear_inequlities``, ``cone_utils.jl:204-232``)
turns a row ``g'v <= h``, with a fresh aux ``t`` of objective cost 1, into

- logbarrier: the exp-cone triple of t >= -(1/alpha) log(alpha (h - g'v)),
- squareplus: the SOC triple of t >= (beta/2) (r + sqrt(r^2 + alpha^-2)),
  r = g'v - h.

As in the reference, squareplus smooths only the box rows, logbarrier the
extras' leading linear rows too (``main.jl:301-316``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.linalg import cholesky_factor
from .coneipm import ConeLP, cone_host_setup, cone_host_state, cone_host_stats, cone_qp_solve
from .expbarrier import exp_barrier_solve
from .reduced import CondensedQP, assemble_condensed, particle_H_q

COST_ANCHOR_EPS = 1e-3  # main.jl:221 anchor to pin the y/t degree of freedom
BIG_BOUND = 1e8  # stand-in for +-inf entries of smoothed one-sided bounds


def _blockdiag(X: torch.Tensor) -> torch.Tensor:
    """(B, M, r, c) -> the block-diagonal (B, M*r, M*c)."""
    B, M, r, c = X.shape
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    return (eye[:, None, :, None] * X[:, :, :, None, :]).reshape(B, M * r, M * c)


# -- shared condensed-layout helpers ------------------------------------------


def dense_H_q(cqp: CondensedQP) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arrow Hessian and linear term densified over z = [uc; uf_1..M]:
    (B, nz, nz), (B, nz)."""
    B, M, nc, nf = cqp.Hcc.shape[0], cqp.M, cqp.nc, cqp.nf
    top = cqp.Hcf.permute(0, 2, 1, 3).reshape(B, nc, M * nf)
    H = torch.cat([torch.cat([cqp.Hcc, top], -1),
                   torch.cat([top.mT, _blockdiag(cqp.Hff)], -1)], -2)
    return H, torch.cat([cqp.qc, cqp.qf.reshape(B, -1)], -1)


def x_map(cqp: CondensedQP) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense map from z to the stacked states, x_all = Xmap z + xoff:
    (B, M*NX, nz), (B, M*NX)."""
    B, M, nc = cqp.Hcc.shape[0], cqp.M, cqp.nc
    NX = cqp.g.shape[-1]
    left = cqp.Ft[..., :nc].reshape(B, M * NX, nc)
    return torch.cat([left, _blockdiag(cqp.Ft[..., nc:])], -1), cqp.g.reshape(B, -1)


def full_layout_sizes(M, nc, nf, NX):
    """(nu_total, n_full) of the canonical full layout [u_cons; u_free; x]."""
    nu_total = nc + M * nf
    return nu_total, nu_total + M * NX


def recover_XU(w, Xmap, xoff, M, nc, nf, N, udim, xdim):
    """(X (B, M, N, xdim), U (B, M, N, udim)) from z (B, nz)."""
    B = w.shape[0]
    U = torch.cat([w[:, None, :nc].expand(B, M, nc),
                   w[:, nc:nc + M * nf].reshape(B, M, nf)], -1).reshape(B, M, N, udim)
    X = ((Xmap @ w[..., None])[..., 0] + xoff).reshape(B, M, N, xdim)
    return X, U


def pad_socs(soc_blocks, nv, dtype, device=None, B=1):
    """Stack SOC cones into padded (B, ncones, pmax, nv) / (B, ncones, pmax)
    with one gather. ``soc_blocks`` is [(sizes, G_rows (B, m, nv), h_rows
    (B, m)), ...]; the cone sizes are static, so the padded row-index table
    is plain numpy (padding indexes a sentinel zero row)."""
    sizes = [int(s) for (qsizes, _, _) in soc_blocks for s in qsizes]
    ncones = len(sizes)
    if not ncones:
        return (torch.zeros((B, 0, 1, nv), dtype=dtype, device=device),
                torch.zeros((B, 0, 1), dtype=dtype, device=device))
    pmax = max(sizes)
    G_all = torch.cat([g for (_, g, _) in soc_blocks], -2)
    h_all = torch.cat([h for (_, _, h) in soc_blocks], -1)
    B, n_rows = G_all.shape[:2]
    idx = np.full((ncones, pmax), n_rows, dtype=np.int64)  # sentinel = pad
    r = 0
    for i, sz in enumerate(sizes):
        idx[i, :sz] = np.arange(r, r + sz)
        r += sz
    idx = torch.from_numpy(idx).to(G_all.device)
    Gq = torch.cat([G_all, G_all.new_zeros((B, 1, nv))], 1)[:, idx]
    hq = torch.cat([h_all, h_all.new_zeros((B, 1))], 1)[:, idx]
    return Gq, hq


# -- row and cone constructors --------------------------------------------------


def _box_rows(cqp, ubounds, xbounds, nv, Xmap, xoff, N, udim):
    """All box-bound rows as ``g'v <= h`` over v, (B, m, nv) / (B, m);
    consensus controls take particle 0's bounds (``lqp_utils.jl:323-331``).
    The bounds are (B, M, N, d) tensors or None."""
    B, M, nc, nf = cqp.Hcc.shape[0], cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    dt, dev = cqp.qf.dtype, cqp.qf.device
    nz = nc + M * nf
    eye_v = torch.eye(nv, dtype=dt, device=dev)
    G_rows, h_rows = [], []
    u_l, u_u = ubounds
    if u_l is not None and u_u is not None:
        ul = u_l.reshape(B, M, N * udim)
        uu = u_u.reshape(B, M, N * udim)
        if nc:
            sel_c = eye_v[:nc].expand(B, nc, nv)
            G_rows += [sel_c, -sel_c]
            h_rows += [uu[:, 0, :nc], -ul[:, 0, :nc]]
        if nf:
            sel_f = eye_v[nc:nz].expand(B, M * nf, nv)  # particle-major
            G_rows += [sel_f, -sel_f]
            h_rows += [uu[:, :, nc:].reshape(B, -1), -ul[:, :, nc:].reshape(B, -1)]
    x_l, x_u = xbounds
    if x_l is not None and x_u is not None:
        xl = x_l.reshape(B, M * NX)
        xu = x_u.reshape(B, M * NX)
        Gx = torch.cat([Xmap, Xmap.new_zeros((B, M * NX, nv - nz))], -1)
        G_rows += [Gx, -Gx]
        h_rows += [xu - xoff, -(xl - xoff)]
    if not G_rows:
        return (torch.zeros((B, 0, nv), dtype=dt, device=dev),
                torch.zeros((B, 0), dtype=dt, device=dev))
    return torch.cat(G_rows, 1), torch.cat(h_rows, 1)


def _neutralize_infinite(G, h):
    """Disable rows with an infinite bound: 0'v <= 1 (an always-slack row)."""
    finite = torch.isfinite(h)
    return torch.where(finite[..., None], G, 0.0), torch.where(finite, h, 1.0)


def _usoc_blocks(u_soc_r, nv, M, nc, nf, N, udim, dtype):
    """Per-stage control-norm cones ||u_ij|| <= r_ij as SOC rows over v:
    (B, ncones, udim+1, nv) / (B, ncones, udim+1). Consensus stages take
    particle 0's radius; an infinite radius gives the neutral cone (h = e,
    G = 0)."""
    Nc, Nf = nc // udim, nf // udim
    r = u_soc_r.to(dtype)  # (B, M, N)
    B, dev = r.shape[0], r.device
    eye_v = torch.eye(nv, dtype=dtype, device=dev)
    Gs, hs = [], []
    if nc:
        selc = eye_v[:nc].reshape(Nc, udim, nv)
        rc = r[:, 0, :Nc]
        fin = torch.isfinite(rc)
        G = torch.cat([torch.zeros((Nc, 1, nv), dtype=dtype, device=dev), -selc], 1)
        G = torch.where(fin[..., None, None], G, 0.0)
        h = torch.zeros((B, Nc, udim + 1), dtype=dtype, device=dev)
        h[..., 0] = torch.where(fin, rc, 1.0)
        Gs.append(G)
        hs.append(h)
    if nf:
        self_f = eye_v[nc:nc + M * nf].reshape(M, Nf, udim, nv)
        rf = r[:, :, Nc:]
        fin = torch.isfinite(rf)
        G = torch.cat([torch.zeros((M, Nf, 1, nv), dtype=dtype, device=dev), -self_f], 2)
        G = torch.where(fin[..., None, None], G, 0.0)
        h = torch.zeros((B, M, Nf, udim + 1), dtype=dtype, device=dev)
        h[..., 0] = torch.where(fin, rf, 1.0)
        Gs.append(G.reshape(B, M * Nf, udim + 1, nv))
        hs.append(h.reshape(B, M * Nf, udim + 1))
    return torch.cat(Gs, 1), torch.cat(hs, 1)


def _smooth_logbarrier(G, h, alpha, sm_off, nv):
    """Rows ``g'v <= h`` (B, m, nv) -> exp-cone triples of the logbarrier
    epigraph ``t >= -(1/alpha) log(alpha (h - g'v))`` in the convention
    s = h_3 - G_3 v, exp(s_x/s_z) <= s_y/s_z (the sign flip of the
    reference's ``make_logbarrier_constraint`` rows, ``cone_utils.jl:
    173-202``): (B, m, 3, nv) / (B, m, 3). An infinite bound is clamped to
    BIG_BOUND (its barrier term is then a constant); the aux t_i sit at
    columns sm_off.., objective cost 1."""
    B, m = h.shape
    dt, dev = G.dtype, G.device
    fin = torch.isfinite(h)
    Gf = torch.where(fin[..., None], G, 0.0)
    hf = torch.where(fin, h, BIG_BOUND)
    Ge = torch.zeros((B, m, 3, nv), dtype=dt, device=dev)
    Ge[:, :, 0, sm_off:sm_off + m] = alpha * torch.eye(m, dtype=dt, device=dev)
    Ge[:, :, 1, :] = alpha * Gf
    he = torch.stack([torch.zeros_like(hf), alpha * hf, torch.ones_like(hf)], -1)
    return Ge, he


def _smooth_squareplus(G, h, alpha, beta, sm_off, nv):
    """Rows ``g'v <= h`` (B, m, nv) -> SOC triples of the squareplus epigraph
    ``t >= (beta/2) (r + sqrt(r^2 + alpha^-2))``, r = g'v - h: (B, m, 3,
    nv) / (B, m, 3); the aux t_i at columns sm_off.., objective cost 1."""
    B, m = h.shape
    dt, dev = G.dtype, G.device
    fin = torch.isfinite(h)
    Gf = torch.where(fin[..., None], G, 0.0)
    hf = torch.where(fin, h, BIG_BOUND)
    Gq = torch.zeros((B, m, 3, nv), dtype=dt, device=dev)
    Gq[:, :, 0, :] = Gf
    Gq[:, :, 0, sm_off:sm_off + m] += -(2.0 / beta) * torch.eye(m, dtype=dt, device=dev)
    Gq[:, :, 1, :] = -Gf
    hq = torch.stack([hf, -hf, torch.full_like(hf, 1.0) / alpha], -1)
    return Gq, hq


def _epigraph_blocks(H_per, q_per, c_per, nv, nc, nf, M, epi_off, dtype):
    """Per-particle k-worst epigraph SOCs ``J_i(z_i) <= y_i + t``, J_i =
    0.5 z_i'H_i z_i + q_i'z_i + c_i, through the Cholesky factor of H_i (the
    ``Pqr2Gh`` trick, ``cone_utils.jl:25-61``; the library's factor, outside
    any kernel in both packages, NaN where it fails). H_per (B, M, nzi,
    nzi), q_per (B, M, nzi), c_per (B, M). Returns ((B, M, nzi+2, nv),
    (B, M, nzi+2))."""
    B, dev = H_per.shape[0], H_per.device
    nzi = nc + nf
    nz = nc + M * nf
    eyeM = torch.eye(M, dtype=dtype, device=dev)
    L = cholesky_factor(H_per + 1e-12 * torch.eye(nzi, dtype=dtype, device=dev))
    A = L.mT / np.sqrt(2.0)
    Az = torch.zeros((B, M, nzi, nv), dtype=dtype, device=dev)
    Az[..., :nc] = A[..., :nc]
    Az[..., nc:nz] = (eyeM[:, None, :, None] * A[:, :, :, None, nc:]).reshape(B, M, nzi, M * nf)
    qv = torch.zeros((B, M, nv), dtype=dtype, device=dev)
    qv[..., :nc] = q_per[..., :nc]
    qv[..., nc:nz] = (eyeM[:, :, None] * q_per[:, None, :, nc:]).reshape(B, M, M * nf)
    # w_i = y_i + t
    wv = torch.zeros((M, nv), dtype=dtype, device=dev)
    wv[:, epi_off:epi_off + M] = eyeM
    wv[:, epi_off + M] = 1.0
    # slack s = h - G v: s0 = 1 + (w - q'z - c), s_mid = 2 A z,
    # s_last = 1 - (w - q'z - c)
    G = torch.cat([-(wv - qv)[:, :, None, :], -2.0 * Az, (wv - qv)[:, :, None, :]], 2)
    h = torch.cat([(1.0 - c_per)[..., None], torch.zeros((B, M, nzi), dtype=dtype, device=dev),
                   (1.0 + c_per)[..., None]], -1)
    # a uniform per-cone scale (the same constraint) keeps the IPM
    # conditioned when the particle-cost constants are large
    scale = torch.clamp(torch.maximum(c_per.abs(), Az.abs().amax((-2, -1))), min=1.0)
    return G / scale[..., None, None], h / scale[..., None]


class CvarParts(NamedTuple):
    """The k-worst (CVaR) epigraph objective's pieces, batched."""

    H_per: torch.Tensor  # (B, M, nc+nf, nc+nf) per-particle Hessians over z_i
    q_per: torch.Tensor  # (B, M, nc+nf)
    c_per: torch.Tensor  # (B, M) per-particle constants (J_i at z_i = 0)
    k: Any  # scalar
    eps: Any  # COST_ANCHOR_EPS


class ComposedLayout(NamedTuple):
    """Static layout facts of the composed program (host ints)."""

    nz: int
    n_epi: int
    aux_off: int
    n_aux: int
    sm_off: int
    n_sm: int
    nv: int


def layout_sizes(M, nc, nf, NX, sig, ubounds_on, xbounds_on, smooth_method,
                 has_cvar) -> ComposedLayout:
    """Static variable layout of the composed program for (dims, sig, flags)."""
    nz = nc + M * nf
    n_epi = (M + 1) if has_cvar else 0
    n_aux = sum(s[3] for s in sig)
    m_box = (2 * nz if ubounds_on else 0) + (2 * M * NX if xbounds_on else 0)
    lin_extras = sum(s[0] for s in sig)
    if smooth_method == "logbarrier":
        n_sm = m_box + lin_extras
    elif smooth_method == "squareplus":
        n_sm = m_box
    else:
        n_sm = 0
    aux_off = nz + n_epi
    sm_off = aux_off + n_aux
    return ComposedLayout(nz=nz, n_epi=n_epi, aux_off=aux_off, n_aux=n_aux,
                          sm_off=sm_off, n_sm=n_sm, nv=sm_off + n_sm)


def build_cone_program(cqp: CondensedQP, dims: Tuple[int, int, int], sig: Tuple, ecs: Tuple,
                       ubounds, xbounds, smooth_method: str = "", smooth_alpha=None,
                       smooth_beta=None, u_soc_r=None, H_extra=None, q_extra=None,
                       cvar: Optional[CvarParts] = None):
    """Assemble the composed dense cone program of each lane.

    ``ecs``: per extras tuple (G_left (B, rows, n_full), G_right (B, rows,
    n_aux), h (B, rows), c_left (B, n), c_right (B, n_aux)); the bounds
    (B, M, N, d) tensors or None; ``u_soc_r`` (B, M, N) or None.
    Returns (P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay): soc_blocks
    is [(sizes, G_rows (B, m, nv), h_rows (B, m)), ...] for `pad_socs`,
    Ge / he the stacked exponential-cone triples (B, ne, 3, nv) / (B, ne, 3),
    lay the static `ComposedLayout`."""
    N, udim, xdim = dims
    B, M, nc, nf = cqp.Hcc.shape[0], cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    nu_total, n_full = full_layout_sizes(M, nc, nf, NX)
    dt, dev = cqp.qf.dtype, cqp.qf.device
    lay = layout_sizes(M, nc, nf, NX, sig, ubounds[0] is not None, xbounds[0] is not None,
                       smooth_method, cvar is not None)
    nz, nv = lay.nz, lay.nv
    Xmap, xoff = x_map(cqp)

    # -- objective -----------------------------------------------------------
    q_full = torch.zeros((B, nv), dtype=dt, device=dev)
    if cvar is None:
        H, q0 = dense_H_q(cqp)
        if H_extra is not None:
            H = H + H_extra
        if q_extra is not None:
            q0 = q0 + q_extra
        P = torch.zeros((B, nv, nv), dtype=dt, device=dev)
        P[:, :nz, :nz] = H
        q_full[:, :nz] = q0
    else:
        # k-worst epigraph objective (main.jl:221-227); a tiny quadratic
        # regularization keeps the LP-like init sane
        P = (1e-8 * torch.eye(nv, dtype=dt, device=dev)).expand(B, nv, nv).clone()
        q_full[:, nz:nz + M] = 1.0 + cvar.eps
        q_full[:, nz + M] = (1.0 - cvar.eps) * cvar.k

    Gl_rows: List[torch.Tensor] = []
    hl_rows: List[torch.Tensor] = []
    soc_blocks: List[Tuple[Tuple[int, ...], torch.Tensor, torch.Tensor]] = []
    exp_G: List[torch.Tensor] = []
    exp_h: List[torch.Tensor] = []
    to_smooth_G: List[torch.Tensor] = []  # rows deferred to the smoothers
    to_smooth_h: List[torch.Tensor] = []

    if cvar is not None:
        # y >= 0 rows (main.jl:230-232) + per-particle epigraph SOCs
        Gy = torch.zeros((B, M, nv), dtype=dt, device=dev)
        Gy[:, :, nz:nz + M] = -torch.eye(M, dtype=dt, device=dev)
        Gl_rows.append(Gy)
        hl_rows.append(torch.zeros((B, M), dtype=dt, device=dev))
        Gq_epi, hq_epi = _epigraph_blocks(cvar.H_per, cvar.q_per, cvar.c_per, nv, nc, nf, M,
                                          nz, dt)
        nzi = nc + nf
        soc_blocks.append(((nzi + 2,) * M, Gq_epi.reshape(B, M * (nzi + 2), nv),
                           hq_epi.reshape(B, M * (nzi + 2))))

    # -- box rows (plain, or deferred to smoothing) ----------------------------
    Gb, hb = _box_rows(cqp, ubounds, xbounds, nv, Xmap, xoff, N, udim)
    if Gb.shape[1]:
        if smooth_method in ("logbarrier", "squareplus"):
            to_smooth_G.append(Gb)
            to_smooth_h.append(hb)
        else:
            Gb, hb = _neutralize_infinite(Gb, hb)
            Gl_rows.append(Gb)
            hl_rows.append(hb)

    # -- per-stage control-norm cones ------------------------------------------
    if u_soc_r is not None:
        Gu, hu = _usoc_blocks(u_soc_r, nv, M, nc, nf, N, udim, dt)
        ncu = Gu.shape[1]
        soc_blocks.append(((udim + 1,) * ncu, Gu.reshape(B, ncu * (udim + 1), nv),
                           hu.reshape(B, ncu * (udim + 1))))

    # -- user extra constraints -------------------------------------------------
    aux_off = lay.aux_off
    for (l, qsizes, e, _), (G_left, G_right, h, c_left, c_right) in zip(sig, ecs):
        n_aux = G_right.shape[-1]
        # rows over z_full = [u; x] lifted onto v (states eliminated)
        Gx_part = G_left[..., nu_total:]
        Gv = G_left[..., :nu_total] + Gx_part @ Xmap
        h_adj = h - (Gx_part @ xoff[..., None])[..., 0]
        G_full = torch.zeros((B, Gv.shape[1], nv), dtype=dt, device=dev)
        G_full[..., :nz] = Gv
        if n_aux:
            G_full[..., aux_off:aux_off + n_aux] = G_right
        if c_left.shape[-1]:
            assert c_left.shape[-1] in (n_full, nz), c_left.shape
            if c_left.shape[-1] == n_full:
                q_full[:, :nz] += c_left[:, :nu_total] \
                    + (c_left[:, None, nu_total:] @ Xmap)[:, 0]
            else:
                q_full[:, :nz] += c_left
        if n_aux and c_right.shape[-1]:
            q_full[:, aux_off:aux_off + n_aux] += c_right
        if l:
            if smooth_method == "logbarrier":
                # the reference smooths the extras' leading linear rows too
                # (main.jl:301-316)
                to_smooth_G.append(G_full[:, :l])
                to_smooth_h.append(h_adj[:, :l])
            else:
                Gl_rows.append(G_full[:, :l])
                hl_rows.append(h_adj[:, :l])
        nq = sum(qsizes)
        if nq:
            soc_blocks.append((qsizes, G_full[:, l:l + nq], h_adj[:, l:l + nq]))
        # exp cones: e triples of rows after the linear and SOC sections,
        # s = h - Gv with exp(s_x/s_z) <= s_y/s_z, s_z > 0
        r = l + nq
        if e:
            exp_G.append(G_full[:, r:r + 3 * e].reshape(B, e, 3, nv))
            exp_h.append(h_adj[:, r:r + 3 * e].reshape(B, e, 3))
        aux_off += n_aux

    # -- smoothing reformulation of the deferred rows ----------------------------
    if to_smooth_G:
        Gs = torch.cat(to_smooth_G, 1)
        hs = torch.cat(to_smooth_h, 1)
        assert Gs.shape[1] == lay.n_sm, (Gs.shape, lay)
        alpha = 1.0 if smooth_alpha is None else smooth_alpha
        # the smoothing aux vars carry objective cost 1 (main.jl:260-261)
        q_full[:, lay.sm_off:] = 1.0
        if smooth_method == "logbarrier":
            Ge_s, he_s = _smooth_logbarrier(Gs, hs, alpha, lay.sm_off, nv)
            exp_G.append(Ge_s)
            exp_h.append(he_s)
        else:
            beta = 1.0 if smooth_beta is None else smooth_beta
            Gq_s, hq_s = _smooth_squareplus(Gs, hs, alpha, beta, lay.sm_off, nv)
            m = Gq_s.shape[1]
            soc_blocks.append(((3,) * m, Gq_s.reshape(B, m * 3, nv), hq_s.reshape(B, m * 3)))

    if cvar is not None:
        # normalize the LP objective by the particle-cost scale so the IPM
        # duality measure is a relative gap (a uniform scaling of the linear
        # objective keeps the argmin)
        sigma = torch.clamp(cvar.c_per.abs().mean(-1), min=1.0)
        q_full = q_full / sigma[:, None]

    Gl = torch.cat(Gl_rows, 1) if Gl_rows else torch.zeros((B, 0, nv), dtype=dt, device=dev)
    hl = torch.cat(hl_rows, 1) if hl_rows else torch.zeros((B, 0), dtype=dt, device=dev)
    Ge = torch.cat(exp_G, 1) if exp_G else torch.zeros((B, 0, 3, nv), dtype=dt, device=dev)
    he = torch.cat(exp_h, 1) if exp_h else torch.zeros((B, 0, 3), dtype=dt, device=dev)
    return P, q_full, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay


# -- solves -----------------------------------------------------------------------


def _composed_symmetric_device(cqp, dims, sig, ubounds, xbounds, ecs, H_extra, q_extra,
                               smooth_method, smooth_alpha, smooth_beta, u_soc_r, cvar,
                               iters: int, tol_exp: int, kappa: float, tol_dynamic=None,
                               warm=None):
    """Assemble the composed programs (symmetric cones) and solve them with
    the NT-scaled cone IPM: (X, U, aux (B, nv - nz), stats, (v, z))."""
    N, udim, xdim = dims
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay = build_cone_program(
        cqp, dims, sig, ecs, ubounds, xbounds, smooth_method=smooth_method,
        smooth_alpha=smooth_alpha, smooth_beta=smooth_beta, u_soc_r=u_soc_r,
        H_extra=H_extra, q_extra=q_extra, cvar=cvar)
    assert Ge.shape[1] == 0  # exponential cones take `_composed_exp_device`
    Gq, hq = pad_socs(soc_blocks, lay.nv, q.dtype, q.device, q.shape[0])
    v, s, z, stats = cone_qp_solve(ConeLP(P=P, q=q, Gl=Gl, hl=hl, Gq=Gq, hq=hq), iters=iters,
                                   tol_exp=tol_exp, kappa=kappa, tol_dynamic=tol_dynamic,
                                   warm=warm)
    X, U = recover_XU(v[:, :lay.nz], Xmap, xoff, M, nc, nf, N, udim, xdim)
    return X, U, v[:, lay.nz:], stats, (v, z)


def _composed_exp_device(cqp, dims, sig, ubounds, xbounds, ecs, H_extra, q_extra,
                         smooth_method, smooth_alpha, smooth_beta, u_soc_r, cvar,
                         tol_exp: int):
    """Assemble the composed programs with exponential cones and solve them
    with the central-path barrier method: (X, U, v (B, nv), stats, (zeros
    shaped as the nonnegative and the padded SOC duals)); the zeros stand
    in for the duals of a warm tuple, which the barrier method has not."""
    N, udim, xdim = dims
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay = build_cone_program(
        cqp, dims, sig, ecs, ubounds, xbounds, smooth_method=smooth_method,
        smooth_alpha=smooth_alpha, smooth_beta=smooth_beta, u_soc_r=u_soc_r,
        H_extra=H_extra, q_extra=q_extra, cvar=cvar)
    Gq, hq = pad_socs(soc_blocks, lay.nv, q.dtype, q.device, q.shape[0])
    v, stats = exp_barrier_solve(P, q, Gl, hl, Gq, hq, Ge, he, tol_exp=tol_exp)
    X, U = recover_XU(v[:, :lay.nz], Xmap, xoff, M, nc, nf, N, udim, xdim)
    return X, U, v, stats, (torch.zeros_like(hl), torch.zeros_like(hq))


def _t(a, dt, dev):
    """numpy (or None) -> a tensor with a leading batch axis of 1."""
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dt, device=dev)[None]


def composed_cone_solve(cqp: CondensedQP, N: int, udim: int, xdim: int, u_l, u_u, x_l, x_u,
                        extra_cstrs, settings: Optional[Dict[str, Any]] = None, H_extra=None,
                        q_extra=None, u_soc_r=None, smooth_method: str = "",
                        smooth_alpha=None, smooth_beta=None,
                        cvar: Optional[CvarParts] = None):
    """The serial host solve of the composed cone program: one problem, the
    batched code at B = 1. Returns numpy (X (M, N, xdim), U (M, N, udim),
    data).

    ``cqp`` (and ``H_extra``, ``q_extra``, ``cvar``) carry a leading batch
    axis of 1 and fix the device and dtype; the bounds (M, N, d), the radii
    (M, N) and the ``extra_cstrs`` tuples are numpy. ``data`` has the JAX
    function's keys: solver_state (``cone_warm``, the (v, zl, zq) tuple as
    numpy, and ``cone_warm_key``), aux, ipm_mu, ipm_iters, ipm_converged,
    ipm_failed, and ts (the epigraph variables y, t) with CVaR.

    A program with exponential cones (logbarrier smoothing, user ``e``
    rows) runs the central-path barrier method, in place unless
    ``settings["exp_device"]`` is False; where that run does not converge,
    or is not asked for, the scipy host solve `extras._solve_exp_host`
    takes it (``data["exp_host_fallback"]``). Its ``data`` has the JAX
    function's keys of that branch: solver_state (passed through), aux,
    ipm_converged and exp_device / ipm_mu, or exp_host_fallback /
    ipm_failed."""
    from .extras import _canon_extras  # extras imports this module

    settings = settings or {}
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    _, n_full = full_layout_sizes(M, nc, nf, NX)
    dt, dev = cqp.qf.dtype, cqp.qf.device
    if cqp.qf.shape[0] != 1:
        raise ValueError("composed_cone_solve solves one problem (batch axis 1); "
                         "composed_solve_batch_device takes a batch")
    dims = (N, udim, xdim)
    sig, ecs = _canon_extras(extra_cstrs, n_full)
    ecs_t = tuple(tuple(_t(a, dt, dev) for a in ec) for ec in ecs)
    ubounds = (_t(u_l, dt, dev), _t(u_u, dt, dev))
    xbounds = (_t(x_l, dt, dev), _t(x_u, dt, dev))
    usoc = _t(u_soc_r, dt, dev)
    lay = layout_sizes(M, nc, nf, NX, sig, u_l is not None, x_l is not None,
                       smooth_method, cvar is not None)
    if smooth_method == "logbarrier" or any(e for (_, _, e, _) in sig):
        return _composed_exp_solve(cqp, dims, sig, ecs_t, ubounds, xbounds, H_extra, q_extra,
                                   smooth_method, smooth_alpha, smooth_beta, usoc, cvar,
                                   settings, lay)

    # the shared host-cone prelude: early-exit iteration cap, inexact-Newton
    # forcing from the SCP residual, warm start keyed on the exact signature
    if cvar is not None:
        iters32, tolexp32, kappa32 = 50, -3, 1e-6
    else:
        iters32, tolexp32, kappa32 = 35, -5, 1e-7
    sig_key = ("composed", dims, sig, M, nc, nf, u_l is not None, x_l is not None,
               u_soc_r is not None, H_extra is not None, smooth_method,
               None if cvar is None else "cvar")
    iters, tol_exp, kappa, tol_eff, tol_dyn, warm = cone_host_setup(
        settings, dt, sig_key, "cone_warm", iters32=iters32, tolexp32=tolexp32,
        kappa32=kappa32, device=dev)
    X, U, aux, stats, (v_out, z_out) = _composed_symmetric_device(
        cqp, dims, sig, ubounds, xbounds, ecs_t, H_extra, q_extra, smooth_method,
        smooth_alpha, smooth_beta, usoc, cvar, iters=iters, tol_exp=tol_exp, kappa=kappa,
        tol_dynamic=tol_dyn, warm=warm)
    aux = aux[0].cpu().numpy()
    data = dict(
        solver_state=cone_host_state(sig_key, "cone_warm", v_out[0], (z_out[0][0], z_out[1][0])),
        aux=aux,
        **cone_host_stats({k: a[0].item() for k, a in stats.items()}, tol_eff),
    )
    if cvar is not None:
        data["ts"] = aux[:lay.n_epi]
    return X[0].cpu().numpy(), U[0].cpu().numpy(), data


def _composed_exp_solve(cqp, dims, sig, ecs, ubounds, xbounds, H_extra, q_extra,
                        smooth_method, smooth_alpha, smooth_beta, usoc, cvar, settings, lay):
    """The exponential-cone branch of `composed_cone_solve`: the barrier run
    (f64-class accuracy at mu = 10^ipm_tol_exp), the scipy host solve where
    it does not converge or ``exp_device`` is False, as in the JAX package.
    A non-finite point from the barrier run on a CUDA tensor raises instead:
    the method keeps its last finite point, so only a faulty factor gives
    one there, and the host solve would hide it."""
    from .extras import _solve_exp_host  # extras imports this module

    N, udim, xdim = dims
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    f64 = cqp.qf.dtype == torch.float64
    tol_exp = int(settings.get("ipm_tol_exp", -8 if f64 else -5))
    v, extra = None, {}
    if bool(settings.get("exp_device", True)):
        X, U, v_dev, stats, _ = _composed_exp_device(
            cqp, dims, sig, ubounds, xbounds, ecs, H_extra, q_extra, smooth_method,
            smooth_alpha, smooth_beta, usoc, cvar, tol_exp=tol_exp)
        finite = bool(torch.isfinite(v_dev).all())
        if not finite and v_dev.is_cuda:
            raise RuntimeError("the exponential-cone barrier method returned a non-finite "
                               "point on the card (a factor kernel fault?)")
        if bool(stats["converged"][0]) and finite:
            v = v_dev[0].cpu().numpy()
            extra = dict(exp_device=True, ipm_mu=float(stats["mu"][0]))
    if v is None:
        P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, _ = build_cone_program(
            cqp, dims, sig, ecs, ubounds, xbounds, smooth_method=smooth_method,
            smooth_alpha=smooth_alpha, smooth_beta=smooth_beta, u_soc_r=usoc,
            H_extra=H_extra, q_extra=q_extra, cvar=cvar)
        npy = lambda a: a[0].cpu().numpy()
        blocks = [(sizes, npy(G), npy(h)) for sizes, G, h in soc_blocks]
        exp_blocks = [(npy(Ge)[i], npy(he)[i]) for i in range(Ge.shape[1])]
        v, host_ok = _solve_exp_host(npy(P), npy(q), npy(Gl), npy(hl), blocks, exp_blocks)
        extra = dict(exp_host_fallback=True, ipm_failed=not bool(host_ok))
        w = torch.as_tensor(v[:lay.nz], dtype=cqp.qf.dtype, device=cqp.qf.device)[None]
        X, U = recover_XU(w, Xmap, xoff, M, nc, nf, N, udim, xdim)
    data = dict(solver_state=settings.get("solver_state"),
                ipm_converged=not extra.get("ipm_failed", False),
                aux=np.asarray(v)[lay.nz:], **extra)
    return X[0].cpu().numpy(), U[0].cpu().numpy(), data


# -- the scenario-batched solve -------------------------------------------------------


def particle_constants_t(g, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u, slew_reg0,
                         slew_um1):
    """Torch twin of `cvar.particle_constants` over any leading axes
    (..., M): c_i = J_i at U = 0, so J_i(z) = 0.5 z'H_i z + q_i'z + c_i."""
    N, xdim = X_prev.shape[-2:]
    g = g.reshape(X_prev.shape)
    dX = g - X_ref
    quad = lambda u, A: (u[..., None, :] @ A @ u[..., None])[..., 0, 0].sum(-1)
    c = 0.5 * quad(dX, Q)
    c = c + 0.5 * reg_x * ((g - X_prev) ** 2).sum((-2, -1))
    c = c + 0.5 * quad(U_ref, R)
    c = c + 0.5 * reg_u * (U_prev ** 2).sum((-2, -1))
    return c + 0.5 * slew_reg0 * (slew_um1 ** 2).sum(-1)


def composed_solve_batch_device(probs, bounds, ecs, extras_q, dims, sig, smooth_method,
                                smooth_alpha, smooth_beta, Nc: int, k=None, eps=None,
                                has_cvar: bool = False, iters: int = 35, tol_exp: int = -5,
                                kappa: float = 1e-7, tol_dynamic=None, warm=None):
    """B same-signature composed cone problems at once: per-problem condensed
    assembly, program build and NT cone IPM over the batch axis; a signature
    with exponential cones (logbarrier smoothing, user ``e`` rows) runs the
    central-path barrier method instead, whose warm tuple is (v, zeros,
    zeros) and whose ``warm`` input is ignored.

    ``probs``: dict of (B, M, ...) tensors (x0, f, fx, fu, X_prev, U_prev,
    Q, R, X_ref, U_ref, reg_x, reg_u, slew_reg, slew_reg0, slew_um1);
    ``bounds``: dict possibly holding (B, ...) u_l/u_u/x_l/x_u/u_soc_r;
    ``ecs``: tuple of tuples of (B, ...) extras tensors; ``extras_q``: dict
    possibly holding (B, ...) Hf / hf. Returns (X (B, M, N, xdim), U, aux
    (B, nv - nz), stats dict of (B,) tensors, warm_out (v, zl, zq))."""
    from .extras import terminal_cross_cost  # extras imports this module

    N, udim, xdim = dims
    p = probs
    M = p["f"].shape[1]
    nc = Nc * udim
    args15 = tuple(p[key] for key in ("x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R",
                                      "X_ref", "U_ref", "reg_x", "reg_u", "slew_reg",
                                      "slew_reg0", "slew_um1"))
    cvar = None
    if has_cvar:
        H_per, q_per, Ft, g = particle_H_q(*args15)
        cqp = CondensedQP(
            Hcc=H_per[:, :, :nc, :nc].sum(1), Hcf=H_per[:, :, :nc, nc:],
            Hff=H_per[:, :, nc:, nc:], qc=q_per[:, :, :nc].sum(1), qf=q_per[:, :, nc:],
            Ft=Ft, g=g, w_prev=p["U_prev"].reshape(p["U_prev"].shape[:2] + (-1,)),
            Qt=None, Rt=None, sl_reg=None, sl_reg0=None)
        c_per = particle_constants_t(g, p["X_prev"], p["U_prev"], p["Q"], p["R"], p["X_ref"],
                                     p["U_ref"], p["reg_x"], p["reg_u"], p["slew_reg0"],
                                     p["slew_um1"])
        cvar = CvarParts(H_per=H_per, q_per=q_per, c_per=c_per, k=k, eps=eps)
    else:
        cqp = assemble_condensed(*args15, Nc=Nc)
    H_extra = q_extra = None
    if "Hf" in extras_q:
        H_extra, q_extra = terminal_cross_cost(cqp, N=N, xdim=xdim, Hf=extras_q["Hf"],
                                               hf=extras_q.get("hf"))
    ubounds = (bounds.get("u_l"), bounds.get("u_u"))
    xbounds = (bounds.get("x_l"), bounds.get("x_u"))
    lay = layout_sizes(M, nc, cqp.nf, cqp.g.shape[-1], sig, ubounds[0] is not None,
                       xbounds[0] is not None, smooth_method, has_cvar)
    if any(e for (_, _, e, _) in sig) or (smooth_method == "logbarrier" and lay.n_sm):
        # exponential cones: the central-path barrier method, which has no
        # warm start; neutral placeholders keep the warm tuple's shapes
        X, U, v, stats, (zl, zq) = _composed_exp_device(
            cqp, dims, sig, ubounds, xbounds, ecs, H_extra, q_extra, smooth_method,
            smooth_alpha, smooth_beta, bounds.get("u_soc_r"), cvar, tol_exp=tol_exp)
        return X, U, v[:, lay.nz:], stats, (v, zl, zq)
    X, U, aux, stats, (v, z) = _composed_symmetric_device(
        cqp, dims, sig, ubounds, xbounds, ecs, H_extra, q_extra, smooth_method,
        smooth_alpha, smooth_beta, bounds.get("u_soc_r"), cvar, iters=iters, tol_exp=tol_exp,
        kappa=kappa, tol_dynamic=tol_dynamic, warm=warm)
    return X, U, aux, stats, (v, z[0], z[1])
