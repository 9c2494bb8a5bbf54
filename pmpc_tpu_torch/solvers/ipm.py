"""Batched primal-dual interior-point method for the condensed consensus QP.

Twin of ``pmpc_tpu/solvers/ipm.py``: a Mehrotra predictor-corrector IPM
over the condensed variable z = [u_cons; u_free_1..M] with control bounds
(``has_u``), state boxes (``has_x``), per-stage second-order cones on the
controls (``has_soc``) and dense linear extra rows (``has_ex``):

    min 0.5 z'Hz + q'z   s.t.  lo_u <= u <= hi_u,  lo_x <= Ft z + g <= hi_x,
                               ||u_j||_2 <= r_j (per stage),  G z <= h.

With control bounds only, every Newton matrix is H plus a diagonal, so each
iteration costs one diagonal-adding per-particle factor (`arrow_factor_diag`,
kernel K1, or K3 past n = 64) and one consensus Schur factor (K2), both
reused by the predictor and the corrector. State boxes add per-particle
``Ft' D Ft`` terms (`box_weighted_K`) and the cones block-diagonal
(udim x udim) NT blocks per stage; the Newton blocks are then formed and go
to the factor without a diagonal (K2, or K4 past n = 64). Extra rows border
the arrow system: their l x l Schur complement is one more K2 factor.

The cone path follows the JAX package at ``69d522d``, not at HEAD: the
fraction to the boundary ``tau`` defaults to 0.99 with cones as without, and
a short step is not a breakdown (no ``stalled`` rule). ROADMAP §3 R1 and F5
say why.

The JAX core runs one scenario under ``jax.vmap``; here the scenario axis B
is explicit. Every reduction is per lane (over all dims but B), and the
per-lane scalars (tol, mu, done, ok, iters, badc, failed, step lengths, the
breakdown boost) are (B,) tensors. The batched ``while_loop`` becomes a
Python loop that runs while any lane is active; a lane that is not active
keeps its state unchanged (``jax.vmap`` of ``lax.while_loop`` selects the
same way), on top of the body's own freeze. The loop test costs one host
sync per iteration. On the card's box-only path the loop runs as chunks of
k iterations captured once as a CUDA graph (`graphs`) and replayed, with a
host test between replays at most (`_ChunkGraph`); the arithmetic is the same.

Under a particle group (`particles.particle_scope`) the (B, M, ...) arrays
hold this rank's particles: the flat constraint vector's consensus rows are
the same on every rank and its particle rows the rank's own, and every
reduction over them (counts, mu, step lengths, residual norms, the
non-finite test, the loop test) is completed over the group.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import graphs
from ..ops.linalg import spd_apply, spd_factor
from ..particles import group as particle_group, pany, pfirst, pmax, pmean, psum, \
    split_max, split_min, split_sum
from ..tracing import COUNTS, span
from ..utils import default_device, full_matmul_precision, lane_where, to_host
from .coneipm import _soc_W, _soc_inv, _soc_prod, _soc_shift, _soc_step_len
from .reduced import ArrowFactors, CondensedQP, H_apply_factored, arrow_apply, \
    arrow_factor, arrow_factor_diag, assemble_condensed, recover_XU, z_to_w


class BoxBounds(NamedTuple):
    """Two-sided bounds in the consensus layout (+-inf where absent).
    Consensus bounds follow particle 0 (``lqp_utils.jl:323-331``). The state
    bounds are read only with ``has_x``."""

    lo_c: torch.Tensor  # (B, nc)    consensus control lower bounds
    hi_c: torch.Tensor  # (B, nc)
    lo_f: torch.Tensor  # (B, M, nf) free control bounds
    hi_f: torch.Tensor  # (B, M, nf)
    lo_x: Optional[torch.Tensor] = None  # (B, M, NX) state bounds
    hi_x: Optional[torch.Tensor] = None  # (B, M, NX)


class SocSpec(NamedTuple):
    """Per-stage control norm cones ||u_j||_2 <= r (+inf where absent).
    Consensus stages carry one cone each (their controls are shared); the
    radii follow particle 0, as the box bounds do."""

    r_c: torch.Tensor  # (B, Nc)    consensus-stage radii
    r_f: torch.Tensor  # (B, M, Nf) free-stage radii


class ExtraRows(NamedTuple):
    """Dense linear inequality rows ``g'w <= h`` over w = [uc; uf_1..M],
    the state block already eliminated through the condensed map
    (`map_extras_rows`). They border the arrow Newton system: l + 2 arrow
    solves per direction and one l x l factor per iteration."""

    Gc: torch.Tensor  # (B, l, nc)
    Gf: torch.Tensor  # (B, l, M, nf)
    h: torch.Tensor  # (B, l)  (+inf rows inactive)


class IPMState(NamedTuple):
    uc: torch.Tensor  # (B, nc)
    uf: torch.Tensor  # (B, M, nf)
    s: torch.Tensor  # (B, mtot) flat slacks [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi; ex]
    lam: torch.Tensor  # (B, mtot) flat multipliers, same order
    sq: torch.Tensor  # (B, nq, 1 + udim) cone slacks ((B, 1, 1) zeros without cones)
    zq: torch.Tensor  # (B, nq, 1 + udim) cone multipliers
    mu: torch.Tensor  # (B,) duality measure
    done: torch.Tensor  # (B,) bool: converged OR gave up, stop updating
    ok: torch.Tensor  # (B,) bool: converged
    iters: torch.Tensor  # (B,) int32 iterations taken
    badc: torch.Tensor  # (B,) int32 consecutive breakdowns (the cone retry counter)
    failed: torch.Tensor  # (B,) bool: gave up (the iterate has NO
    #                       feasibility guarantee)


class _Opts(NamedTuple):
    """The options that an IPM iteration's arithmetic reads (part of a
    captured chunk's key)."""

    has_u: bool
    has_x: bool
    has_soc: bool
    has_ex: bool
    tol_exp: int
    kappa: float
    mu_target: float
    tau: float
    gondzio: int
    predictor: bool


def box_weighted_K(cqp: CondensedQP, wc, wf, wx, Ftc, Ftf, has_u: bool,
                   has_x: bool):
    """Arrow blocks of ``H + G' diag(w) G`` for the box-constraint Jacobians:
    diagonal updates from control boxes (wc (B, nc), wf (B, M, nf)),
    per-particle ``Ft' D Ft`` from state boxes (wx (B, M, NX); Ftc/Ftf the
    consensus/free columns of Ft)."""
    Kcc, Kcf, Kff = cqp.Hcc, cqp.Hcf, cqp.Hff
    if has_u:
        Kcc = Kcc + torch.diag_embed(wc)
        Kff = Kff + torch.diag_embed(wf)
    if has_x:
        DFtf = wx[..., None] * Ftf
        Kff = Kff + Ftf.mT @ DFtf
        if cqp.nc > 0:
            Kcc = Kcc + psum((Ftc.mT @ (wx[..., None] * Ftc)).sum(dim=-3))
            Kcf = Kcf + Ftc.mT @ DFtf
    return Kcc, Kcf, Kff


def _block_diag(blk: torch.Tensor) -> torch.Tensor:
    """(..., n, d, d) blocks -> the (..., n d, n d) block-diagonal matrix,
    written through the diagonal view of an (..., n, d, n, d) array."""
    *lead, n, d, _ = blk.shape
    out = blk.new_zeros((*lead, n, d, n, d))
    out.diagonal(dim1=-4, dim2=-2).copy_(blk.movedim(-3, -1))
    return out.reshape(*lead, n * d, n * d)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def ipm_core(
    cqp: CondensedQP,
    bounds: BoxBounds,
    has_u: bool = True,
    has_x: bool = False,
    iters: int = 30,
    tol_exp: int = -8,
    kappa: float = 0.0,
    mu_target: float = 0.0,
    warm: Optional[Tuple] = None,
    tol_dynamic: Optional[torch.Tensor] = None,
    tau: Optional[float] = None,
    socs: Optional[SocSpec] = None,
    has_soc: bool = False,
    gondzio: int = 0,
    ex: Optional[ExtraRows] = None,
    has_ex: bool = False,
    predictor: bool = True,
):
    """Run the IPM on a batch. Returns (uc, uf, stats).

    All box and extra-row constraint groups live in ONE flat (B, mtot)
    vector, order [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi; ex]; the state rows
    exist only with ``has_x``, the extra rows only with ``has_ex``.
    ``has_u=False`` ignores the control bounds entirely (their rows are
    masked). The cones (``socs`` with ``has_soc``) are a stacked
    (B, nq, 1 + udim) array, consensus-stage cones first, then the free ones
    particle-major; a cone of radius +inf is masked and sits at the unit
    point e.

    ``warm`` is (uc (B,nc), uf (B,M,nf), s (B,mtot), lam (B,mtot)) or, with
    cones, the same plus (sq, zq) (B, nq, 1 + udim); ``tol_dynamic`` (B,)
    overrides the static tol ``10**tol_exp`` where larger. ``tau`` is the
    fraction to the boundary (0.99 when None). ``gondzio`` adds that many
    centrality correctors (without cones), each kept per lane where it
    lengthens the step; ``predictor=False`` replaces the affine probe by
    the LOQO centering rule (one solve an iteration); ``mu_target > 0``
    stops on the central path at that duality measure (the logbarrier
    smoothing's solution) and ends with 10 pure centering steps.

    ``stats``: mu, iters, converged, failed (all (B,)), s, lam, sq, zq.
    """
    if has_soc and socs is None:
        raise ValueError("ipm_core: has_soc=True needs the cone radii (socs)")
    if has_ex and ex is None:
        raise ValueError("ipm_core: has_ex=True needs the extra rows (ex)")
    if has_ex and particle_group() is not None:
        raise ValueError("ipm_core: extra rows do not take a particle group")

    opts = _Opts(has_u, has_x, has_soc, has_ex, tol_exp, kappa, mu_target,
                 0.99 if tau is None else tau, gondzio, predictor)
    init, body, failed_of = _core(cqp, bounds, tol_dynamic, socs, ex, opts)
    state = init(warm)
    ins = [*cqp, *bounds, tol_dynamic]  # what the box iteration reads (None: absent)
    graph = _graph_for(ins, state, opts, iters)
    if graph is not None:
        state = graph.run(ins, state)
    else:
        # the loop of `jax.vmap(lax.while_loop)`: runs while ANY lane's
        # condition holds; lanes whose own condition is false keep their state
        active = _active(state, iters)
        while pany(active):
            with span("ipm.iter"):
                state, active = _chunk(body, state, active, 1, iters)
    if mu_target > 0:
        # finish with pure centering steps: Mehrotra's second-order
        # correction hunts mu -> 0 and wobbles around the mu_target point
        ok_main = state.ok
        state = state._replace(done=state.done & ~state.ok, ok=torch.zeros_like(ok_main))
        for _ in range(10):
            state = body(state, mehrotra=False)
        # a transient breakdown during centering must not latch `failed` for
        # a solve whose main phase converged (the frozen iterate is that point)
        state = state._replace(failed=state.failed & ~ok_main,
                               ok=state.ok | (ok_main & ~state.failed))
    stats = dict(mu=state.mu, iters=state.iters, converged=state.ok,
                 failed=failed_of(state), s=state.s, lam=state.lam, sq=state.sq, zq=state.zq)
    return state.uc, state.uf, stats


def _core(cqp: CondensedQP, bounds: BoxBounds, tol_dynamic, socs, ex, opts: _Opts):
    """What one IPM iteration reads, derived from the inputs, and the
    functions over it: ``init(warm)`` the starting `IPMState`,
    ``body(state, mehrotra=True)`` one iteration of every lane, and
    ``failed_of(state)`` the ``failed`` that `ipm_core` reports (with cones
    an iterate outside them fails too). Pure tensor work with no host read,
    so a CUDA graph can hold it (`_ChunkGraph`)."""
    has_u, has_x, has_soc, has_ex, tol_exp, kappa, mu_target, tau, gondzio, predictor = opts
    dtype, dev = cqp.qf.dtype, cqp.qf.device
    B, M, nc, nf = cqp.Hff.shape[0], cqp.M, cqp.nc, cqp.nf
    tol = torch.full((B,), 10.0 ** tol_exp, dtype=dtype, device=dev)
    if tol_dynamic is not None:
        tol = torch.maximum(tol_dynamic.to(dtype), tol)
    sqrt_tol = torch.sqrt(tol)
    mu_ok_floor = torch.clamp(tol, min=mu_target * 1.05)
    NX = cqp.g.shape[-1]
    Ftc = Ftf = None
    if has_x:  # (B, M, NX, nc/nf), loop-invariant matmul operands
        Ftc, Ftf = cqp.Ft[..., :nc].contiguous(), cqp.Ft[..., nc:].contiguous()
    mnf = M * nf
    mnx = M * NX if has_x else 0  # state rows only when state bounds are active
    o_chi, o_flo, o_fhi, o_xlo, o_xhi = (
        nc, 2 * nc, 2 * nc + mnf, 2 * nc + 2 * mnf, 2 * nc + 2 * mnf + mnx)
    o_ex = o_xhi + mnx

    lo_parts = [bounds.lo_c, bounds.hi_c,
                bounds.lo_f.reshape(B, -1), bounds.hi_f.reshape(B, -1)]
    if not has_u:
        # the control bounds are IGNORED: finite entries would activate mask
        # rows whose barrier terms `box_weighted_K` skips
        lo_parts = [torch.full_like(a, -torch.inf) for a in lo_parts]
    if has_x:
        lo_parts += [bounds.lo_x.reshape(B, -1), bounds.hi_x.reshape(B, -1)]
    if has_ex:
        lo_parts += [ex.h]
        Gf_flat = ex.Gf.reshape(B, ex.h.shape[-1], M * nf)
    mask = torch.isfinite(torch.cat(lo_parts, -1))
    n_c = 2 * nc  # the consensus rows lead the flat layout
    n_act = split_sum(mask, n_c).to(dtype)

    # -- cone bookkeeping ------------------------------------------------------
    if has_soc:
        Nc_soc, Nf_soc = socs.r_c.shape[-1], socs.r_f.shape[-1]
        udim = nc // Nc_soc if Nc_soc else nf // max(Nf_soc, 1)
        p = udim + 1
        nq = Nc_soc + M * Nf_soc
        r_flat = torch.cat([socs.r_c, socs.r_f.reshape(B, -1)], -1)  # (B, nq)
        rmask = torch.isfinite(r_flat)
        rmaskf = rmask.to(dtype)
        e_soc = torch.zeros((nq, p), dtype=dtype, device=dev)
        e_soc[:, 0] = 1.0
        n_act = n_act + split_sum(rmask, Nc_soc).to(dtype)

        def soc_viol(v):
            """`_soc_viol` over the live cones of every rank."""
            return split_max(rmaskf * (torch.linalg.vector_norm(v[..., 1:], dim=-1)
                                       - v[..., 0]), Nc_soc)

        def cone_vals(uc, uf):
            """h - G z per cone: [r_k; u_stage] (B, nq, p); e on masked cones."""
            u_all = torch.cat([uc.reshape(B, Nc_soc, udim),
                               uf.reshape(B, M * Nf_soc, udim)], 1)
            vals = torch.cat([r_flat[..., None], u_all], -1)
            return torch.where(rmask[..., None], vals, e_soc)

        def cone_scatter(vq):
            """S' vq[1:] -> (vc (B, nc), vf (B, M, nf)); masked cones give 0."""
            vq = vq * rmaskf[..., None]
            return (vq[:, :Nc_soc, 1:].reshape(B, nc),
                    vq[:, Nc_soc:, 1:].reshape(B, M, nf))

        def cone_gdv(duc, duf):
            """G dz per cone = [0; -du_stage]; masked cones give 0."""
            du = cone_vals(duc, duf)[..., 1:]
            return torch.cat([torch.zeros_like(du[..., :1]), -du], -1) * rmaskf[..., None]

    n_act = torch.clamp(n_act, min=1.0)

    # -- the constraint maps of the flat layout --------------------------------
    def states(uc, uf):
        """Ft z as (B, M, NX)."""
        return _mv(cqp.Ft, z_to_w(uc, uf))

    def ex_dot(uc, uf):
        """G z of the extra rows, (B, l)."""
        return _mv(ex.Gc, uc) + _mv(Gf_flat, uf.reshape(B, -1))

    def slack_vals(uc, uf):
        """s = h - Gz as one flat (B, mtot) vector (garbage on masked rows)."""
        vals = [uc - bounds.lo_c, bounds.hi_c - uc,
                (uf - bounds.lo_f).reshape(B, -1),
                (bounds.hi_f - uf).reshape(B, -1)]
        if has_x:
            x = states(uc, uf) + cqp.g
            vals += [(x - bounds.lo_x).reshape(B, -1),
                     (bounds.hi_x - x).reshape(B, -1)]
        if has_ex:
            vals += [ex.h - ex_dot(uc, uf)]
        return torch.cat(vals, -1)

    def g_dot_z(duc, duf):
        duf_f = duf.reshape(B, -1)
        parts = [-duc, duc, -duf_f, duf_f]
        if has_x:
            dx = states(duc, duf).reshape(B, -1)
            parts += [-dx, dx]
        if has_ex:
            parts += [ex_dot(duc, duf)]
        return torch.cat(parts, -1)

    def gT_dot(v):
        """(G' v) split into consensus/free contributions."""
        bc = v[:, o_chi:o_flo] - v[:, :nc]
        bf = (v[:, o_fhi:o_xlo] - v[:, o_flo:o_fhi]).reshape(B, M, nf)
        if has_x:
            dv = (v[:, o_xhi:o_ex] - v[:, o_xlo:o_xhi]).reshape(B, M, NX, 1)
            bc = bc + psum((Ftc.mT @ dv)[..., 0].sum(dim=-2))
            bf = bf + (Ftf.mT @ dv)[..., 0]
        if has_ex:
            ve = v[:, None, o_ex:]
            bc = bc + (ve @ ex.Gc)[:, 0]
            bf = bf + (ve @ Gf_flat)[:, 0].reshape(B, M, nf)
        return bc, bf

    def mu_of(s_, lam_, sq_, zq_):
        tot = split_sum(torch.where(mask, s_ * lam_, 0.0), n_c)
        if has_soc:
            tot = tot + split_sum(rmaskf * (sq_ * zq_).sum(-1), Nc_soc)
        return tot / n_act

    # -- initialization -------------------------------------------------------
    false = torch.zeros(B, dtype=torch.bool, device=dev)

    def init(warm):
        """The starting point: ``warm`` (see `ipm_core`) or the cold start."""
        if warm is not None:
            # warm point with a Yildirim-Wright interior shift; slacks recomputed
            # from the warm primal against the new bounds
            uc0, uf0, _, warm_lam = warm[:4]
            s0 = torch.where(mask, torch.clamp(slack_vals(uc0, uf0), min=1e-2), 1.0)
            lam0 = torch.where(mask, torch.clamp(warm_lam, min=1e-2), 0.0)
        else:
            F0 = arrow_factor(cqp.Hcc, cqp.Hcf, cqp.Hff, jitter=kappa)
            uc0, uf0 = arrow_apply(F0, -cqp.qc, -cqp.qf)
            s0 = torch.where(mask, torch.clamp(slack_vals(uc0, uf0), min=1.0), 1.0)
            lam0 = torch.where(mask, 1.0 / s0, 0.0)
        if has_soc:
            sq0 = _soc_shift(cone_vals(uc0, uf0))
            if warm is not None and len(warm) >= 6:
                zq0 = _soc_shift(torch.where(rmask[..., None], warm[5], e_soc))
            else:
                zq0 = e_soc.expand(B, nq, p).clone()
        else:  # placeholders: the cone fields of the state carry nothing
            sq0 = zq0 = torch.zeros((B, 1, 1), dtype=dtype, device=dev)
        zero_i = torch.zeros(B, dtype=torch.int32, device=dev)
        return IPMState(uc0, uf0, s0, lam0, sq0, zq0, mu_of(s0, lam0, sq0, zq0),
                        false, false, zero_i, zero_i, false)

    def grad_lagrangian(uc, uf, lam, zq):
        """(gc, gf) = Hz + q + G'lam (+ the cone duals), Hz in factored form."""
        with span("ipm.residual"):
            Hc, Hf = H_apply_factored(cqp, uc, uf)
            dc, df = gT_dot(lam)
            gc, gf = Hc + cqp.qc + dc, Hf + cqp.qf + df
            if has_soc:  # the cone Jacobian G_k' z_k = -S_k' z_k[1:]
                zc, zf = cone_scatter(zq)
                gc, gf = gc - zc, gf - zf
            return gc, gf

    w_max = 1e14 if dtype == torch.float64 else 1e7

    def body(st: IPMState, mehrotra: bool = True) -> IPMState:
        uc, uf, s, lam, sq, zq, mu, done, ok, it_count, badc, failed = st
        r_p = torch.where(mask, s - slack_vals(uc, uf), 0.0)
        gc, gf = grad_lagrangian(uc, uf, lam, zq)

        # capped scaling ratios: uncapped lam/s overflows the f32 factor late
        w = torch.where(mask, torch.clamp(lam / s, max=w_max), 0.0)
        wc_d = w[:, :nc] + w[:, o_chi:o_flo]
        wf_d = (w[:, o_flo:o_fhi] + w[:, o_fhi:o_xlo]).reshape(B, M, nf)
        K = None
        if has_u and not has_x and not has_soc:
            # box-only fast path: K = H + diag(w), the diagonal folded into
            # the factor kernel, so the Newton matrix never materializes
            with span("ipm.factor"):
                F = arrow_factor_diag(cqp.Hcc, cqp.Hcf, cqp.Hff, wc_d, wf_d,
                                      jitter=kappa)
        else:
            wx = (w[:, o_xlo:o_xhi] + w[:, o_xhi:o_ex]).reshape(B, M, NX) \
                if has_x else None
            Kcc, Kcf, Kff = box_weighted_K(cqp, wc_d, wf_d, wx, Ftc, Ftf,
                                           has_u=has_u, has_x=has_x)
            if has_soc:
                # NT scalings per cone; r_pq = s - (h - Gz)
                r_pq = (sq - cone_vals(uc, uf)) * rmaskf[..., None]
                Wq, Wqinv, Wq2inv, lamq = _soc_W(sq, zq)
                # K += S' (W^-2)[1:, 1:] S: block-diagonal per stage
                Bq = Wq2inv[..., 1:, 1:] * rmaskf[..., None, None]
                if nc:
                    Kcc = Kcc + _block_diag(Bq[:, :Nc_soc])
                if Nf_soc:
                    Kff = Kff + _block_diag(Bq[:, Nc_soc:].reshape(B, M, Nf_soc, udim, udim))
                # breakdown retries boost the regularization: a near-singular
                # K (the cone scalings grow ~1/mu near convergence) makes the
                # factor NaN; the retry re-solves the same iterate with more
                diag_scale = (pmean(Kff.diagonal(dim1=-2, dim2=-1), (-2, -1)) if nf
                              else Kcc.diagonal(dim1=-2, dim2=-1).abs().mean(-1)) + 1.0
                boost = badc.to(dtype) ** 2 * 1e-5 * diag_scale
                if nc:
                    Kcc = Kcc + boost[:, None, None] * torch.eye(nc, dtype=dtype, device=dev)
                if nf:
                    Kff = Kff + boost[:, None, None, None] * torch.eye(nf, dtype=dtype, device=dev)
            K = (Kcc, Kcf, Kff)
            with span("ipm.factor"):
                F = arrow_factor(Kcc, Kcf, Kff, jitter=kappa)

        def base_solve(bc_, bf_, F_=F, K_=K):
            """Arrow solve; with cones one round of iterative refinement (the
            recovered cone dual multiplies the solve error by W^-2, ~1/mu
            near convergence). ``F_``/``K_`` with an inserted axis take
            several right-hand sides, (B, k, nc) and (B, k, M, nf)."""
            with span("ipm.solve"):
                duc_, duf_ = arrow_apply(F_, bc_, bf_)
                if has_soc:
                    Kcc_, Kcf_, Kff_ = K_
                    oc = _mv(Kcc_, duc_) + psum(_mv(Kcf_, duf_).sum(-2))
                    of = _mv(Kcf_.mT, duc_[..., None, :]) + _mv(Kff_, duf_)
                    ddc, ddf = arrow_apply(F_, bc_ - oc, bf_ - of)
                    duc_, duf_ = duc_ + ddc, duf_ + ddf
                return duc_, duf_

        if has_ex:
            # augmented bordered solve: the l dense rows stay explicit, their
            # dual step from the l x l Schur system
            #   (G A^-1 G' + W^-1) dlam = G A^-1 b - c2
            # and the primal step from one more arrow solve of (b - G'dlam);
            # exact at any border weight (the SMW elimination cancels at
            # w ~ 1/mu). The l solves of G' are columns of one arrow solve.
            mask_ex = mask[:, o_ex:]
            Zc, Zf = base_solve(ex.Gc, ex.Gf, ArrowFactors(*(t[:, None] for t in F)),
                                None if K is None else tuple(t[:, None] for t in K))
            S = ex.Gc @ Zc.mT + Gf_flat @ Zf.reshape(Zf.shape[:2] + (-1,)).mT
            S = S + torch.diag_embed(torch.where(
                mask_ex, 1.0 / torch.clamp(w[:, o_ex:], min=1e-30), 1e30))
            LS_ex = spd_factor(S, jitter=1e-12)

            def solve_K(bc_, bf_, c2_):
                yc, yf = base_solve(bc_, bf_)
                dle = torch.where(mask_ex, spd_apply(LS_ex, ex_dot(yc, yf) - c2_), 0.0)
                dle_r = dle[:, None, :]
                duc_, duf_ = base_solve(bc_ - (dle_r @ ex.Gc)[:, 0],
                                        bf_ - (dle_r @ Gf_flat)[:, 0].reshape(B, M, nf))
                return duc_, duf_, dle
        else:
            def solve_K(bc_, bf_, c2_):
                duc_, duf_ = base_solve(bc_, bf_)
                return duc_, duf_, None

        def newton_rhs(r_c, dq_c):
            v = torch.where(mask, (lam * r_p - r_c) / s, 0.0)
            c2 = None
            v_fold = v
            if has_ex:
                # the extra rows stay EXPLICIT in the Newton system: folding
                # them through v multiplies the solve error by w_ex ~ 1/mu.
                # c2 is their Schur system's rhs (-r_p + r_c/lam per row)
                v_fold = torch.cat([v[:, :o_ex], torch.zeros_like(v[:, o_ex:])], -1)
                c2 = torch.where(mask[:, o_ex:], -r_p[:, o_ex:] + r_c[:, o_ex:]
                                 / torch.clamp(lam[:, o_ex:], min=1e-30), 0.0)
            dc, df = gT_dot(v_fold)
            bc, bf = -(gc + dc), -(gf + df)
            vq = None
            if has_soc:
                vq = _mv(Wq2inv, r_pq) - _mv(Wqinv, _soc_prod(_soc_inv(lamq), dq_c))
                vqc, vqf = cone_scatter(vq)  # rhs -= G' vq = +S' vq[1:]
                bc, bf = bc + vqc, bf + vqf
            return (bc, bf), v, vq, c2

        def recover_steps(duc, duf, v, vq, dlam_ex=None):
            gdz = g_dot_z(duc, duf)
            ds = torch.where(mask, -r_p - gdz, 0.0)
            dlam = torch.where(mask, w * gdz + v, 0.0)
            if has_ex:
                # the Schur-computed extras dual step is the stable one
                dlam = torch.cat([dlam[:, :o_ex],
                                  torch.where(mask[:, o_ex:], dlam_ex, 0.0)], -1)
            dsq = dzq = None
            if has_soc:
                gdq = cone_gdv(duc, duf)
                dsq = (-r_pq - gdq) * rmaskf[..., None]
                # dzq = W^-2 (G dz + r_pq) - W^-1 (lam^-1 o dq_c) = W^-2 G dz + vq
                dzq = (_mv(Wq2inv, gdq) + vq) * rmaskf[..., None]
            return ds, dlam, dsq, dzq

        def step_len(s_, ds, lam_, dlam, sq_, dsq, zq_, dzq):
            # torch.where evaluates both branches: the inner guards keep the
            # unused branch finite
            rp_ = torch.where(mask & (ds < 0),
                              -s_ / torch.where(ds < 0, ds, -1.0), torch.inf)
            rd_ = torch.where(mask & (dlam < 0),
                              -lam_ / torch.where(dlam < 0, dlam, -1.0), torch.inf)
            mins = split_min(torch.stack([rp_, rd_], 1), n_c)  # (B, 2)
            ap = torch.clamp(tau * mins[:, 0], max=1.0)
            ad = torch.clamp(tau * mins[:, 1], max=1.0)
            if has_soc:
                aq_p = torch.where(rmask, _soc_step_len(sq_, dsq), torch.inf)
                aq_d = torch.where(rmask, _soc_step_len(zq_, dzq), torch.inf)
                ap = torch.minimum(ap, tau * split_min(aq_p, Nc_soc))
                ad = torch.minimum(ad, tau * split_min(aq_d, Nc_soc))
            return ap, ad

        def ahead(x, a, dx):
            return x + a.reshape((B,) + (1,) * (x.ndim - 1)) * dx

        lam2 = _soc_prod(lamq, lamq) if has_soc else None
        dq_c = None
        if mehrotra and not predictor:
            # single-solve mode: no affine probe; the centering parameter
            # from the LOQO distance-to-centrality rule (xi = the least
            # complementarity product / mu). One solve an iteration
            xi_min = split_min(torch.where(mask, s * lam, torch.inf), n_c)
            if has_soc:
                prod_q = (sq * zq).sum(-1)
                xi_min = torch.minimum(
                    xi_min, split_min(torch.where(rmask, prod_q, torch.inf), Nc_soc))
            xi = torch.clamp(xi_min / torch.clamp(mu, min=1e-30), 1e-6, 1.0)
            sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi) / xi, max=2.0) ** 3
            sigma = torch.clamp(sigma, 0.05, 0.8)
            sig_mu = torch.clamp(sigma * mu, min=mu_target)
            r_c = torch.where(mask, s * lam - sig_mu[:, None], 0.0)
            if has_soc:
                dq_c = lam2 - sig_mu[:, None, None] * e_soc
        elif mehrotra:
            # predictor (affine) step
            (bc, bf), v_aff, vq_aff, c2_aff = newton_rhs(
                torch.where(mask, s * lam, 0.0), lam2)
            duc_a, duf_a, dle_a = solve_K(bc, bf, c2_aff)
            ds_a, dlam_a, dsq_a, dzq_a = recover_steps(duc_a, duf_a, v_aff, vq_aff, dle_a)
            ap_a, ad_a = step_len(s, ds_a, lam, dlam_a, sq, dsq_a, zq, dzq_a)
            if has_soc:
                # NT scaling assumes s and z move together: separate steps
                # let a cone crash into its boundary and stall
                ap_a = ad_a = torch.minimum(ap_a, ad_a)
            mu_aff = mu_of(ahead(s, ap_a, ds_a), ahead(lam, ad_a, dlam_a),
                           ahead(sq, ap_a, dsq_a) if has_soc else sq,
                           ahead(zq, ad_a, dzq_a) if has_soc else zq)
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
            sig_mu = torch.clamp(sigma * mu, min=mu_target)  # central-path floor
            # corrector (reuses the factorization)
            r_c = torch.where(mask, s * lam + ds_a * dlam_a - sig_mu[:, None], 0.0)
            if has_soc:
                eta_a, th_a = _mv(Wqinv, dsq_a), _mv(Wq, dzq_a)
                dq_c = lam2 + _soc_prod(eta_a, th_a) - sig_mu[:, None, None] * e_soc
        else:
            # pure centering Newton on the perturbed KKT at mu_target
            r_c = torch.where(mask, s * lam - mu_target, 0.0)
            if has_soc:
                dq_c = lam2 - mu_target * e_soc
        (bc, bf), v, vq, c2_m = newton_rhs(r_c, dq_c)
        duc, duf, dle_m = solve_K(bc, bf, c2_m)
        ds, dlam, dsq, dzq = recover_steps(duc, duf, v, vq, dle_m)
        ap, ad = step_len(s, ds, lam, dlam, sq, dsq, zq, dzq)
        if has_soc:
            ap = ad = torch.minimum(ap, ad)  # one combined step (see above)

        if mehrotra and gondzio > 0 and not has_soc:
            # Gondzio centrality correctors: each reuses the factorization
            # and pushes outlying complementarity products of the trial point
            # back towards the central path; kept per lane only where it
            # lengthens the step
            for _ in range(gondzio):
                ap_t = torch.clamp(ap + 0.1, max=1.0)[:, None]
                ad_t = torch.clamp(ad + 0.1, max=1.0)[:, None]
                sm = sig_mu[:, None]
                prod = torch.where(mask, (s + ap_t * ds) * (lam + ad_t * dlam), sm)
                target = torch.clamp(prod, min=0.1 * sm, max=10.0 * sm)
                r_c2 = torch.where(mask, r_c + (prod - target), 0.0)
                (bc2, bf2), v2, _, c2_g = newton_rhs(r_c2, None)
                duc2, duf2, dle_g = solve_K(bc2, bf2, c2_g)
                ds2, dlam2, _, _ = recover_steps(duc2, duf2, v2, None, dle_g)
                ap2, ad2 = step_len(s, ds2, lam, dlam2, sq, None, zq, None)
                acc = (ap2 + ad2) > (ap + ad) + 0.01
                duc, duf = lane_where(acc, duc2, duc), lane_where(acc, duf2, duf)
                ds, dlam = lane_where(acc, ds2, ds), lane_where(acc, dlam2, dlam)
                ap, ad = torch.where(acc, ap2, ap), torch.where(acc, ad2, ad)
                r_c = lane_where(acc, r_c2, r_c)

        uc_n = ahead(uc, ap, duc)
        uf_n = ahead(uf, ap, duf)
        s_n = torch.where(mask, ahead(s, ap, ds), 1.0)
        lam_n = torch.where(mask, ahead(lam, ad, dlam), 0.0)
        if has_soc:
            sq_n = torch.where(rmask[..., None], ahead(sq, ap, dsq), e_soc)
            zq_n = torch.where(rmask[..., None], ahead(zq, ad, dzq), e_soc)
            # f32 hazard: the step-length quadratic's discriminant cancels
            # near the boundary, so a crossing can be missed and a full step
            # lands OUTSIDE the cone (after which the primal residual still
            # contracts and the solver "converges" to an infeasible point):
            # an escape is a breakdown, which the retry below restores
            cone_escaped = (soc_viol(sq_n) > 0) | (soc_viol(zq_n) > 0)
        else:
            sq_n, zq_n = sq, zq
        mu_n = mu_of(s_n, lam_n, sq_n, zq_n)

        # convergence / divergence tests (per lane)
        rp_inf = split_max(r_p.abs(), n_c)
        if has_soc:
            rp_inf = torch.maximum(rp_inf, split_max(r_pq.abs().amax(-1), Nc_soc))
        gd_inf = split_max(torch.cat([gc, gf.reshape(B, -1)], -1).abs(), nc)
        # non-finite steps freeze to the PREVIOUS iterate
        step_bad = pmax(~(torch.isfinite(mu_n) & torch.isfinite(uc_n.sum(-1))
                          & torch.isfinite(uf_n.sum((-2, -1)))))
        mu_ok = mu_n < mu_ok_floor
        if mu_target > 0:
            # on the central path the products must also be CENTERED at
            # mu_target (that is what makes the point the logbarrier solution)
            center_err = split_max(torch.where(mask, (s_n * lam_n - mu_target).abs(), 0.0),
                                   n_c)
            if has_soc:
                center_err = torch.maximum(center_err, split_max(rmaskf * (
                    (sq_n * zq_n).sum(-1) - mu_target).abs(), Nc_soc))
            mu_ok = mu_ok & (center_err < 0.002 * mu_target + tol)
        # with cones the dual accuracy is cancellation-limited by the NT
        # scaling near the boundary, with extra rows by the bordered solve at
        # row weights ~1/mu: both ~sqrt(tol)
        gd_tol = sqrt_tol if (has_soc or has_ex) else 1e3 * tol
        now_done = mu_ok & (rp_inf < sqrt_tol) & (gd_inf < gd_tol)
        now_bad = step_bad | (mu_n > 1e12)
        if has_soc:
            # convergence also needs the NEW primal point to be cone-feasible
            now_done = now_done & (soc_viol(cone_vals(uc_n, uf_n)) < sqrt_tol)
            now_bad = now_bad | cone_escaped
            badc_n = torch.where(now_bad, badc + 1, 0).to(badc.dtype)
            give_up = badc_n >= 4  # repeated breakdowns: stop at the best iterate
        else:
            badc_n = badc
            give_up = now_bad  # box path: freeze on the first bad step

        frozen = done | now_bad
        # already-done lanes do not count an iteration (the centering phase
        # runs a fixed number of steps over possibly frozen lanes)
        it_old = it_count + torch.where(done, 0, 1).to(it_count.dtype)
        new = IPMState(uc_n, uf_n, s_n, lam_n, sq_n, zq_n, mu_n, false,
                       ok | now_done, it_count + 1, badc_n, failed)
        old = IPMState(uc, uf, s, lam, sq, zq, mu, false, ok, it_old, badc_n, failed)
        merged = IPMState(*(lane_where(frozen, o, n) for n, o in zip(new, old)))
        if has_soc:
            # restoration: a breakdown is usually a cone point crashed into
            # its boundary; regularization cannot fix the ITERATE, so the
            # offending cone points move back into the interior before the
            # retry (a no-op on points comfortably inside)
            retry = now_bad & ~done
            merged = merged._replace(sq=lane_where(retry, _soc_shift(merged.sq), merged.sq),
                                     zq=lane_where(retry, _soc_shift(merged.zq), merged.zq))
        return merged._replace(done=done | now_done | give_up, ok=ok | now_done,
                               failed=failed | (give_up & ~ok & ~now_done))

    def failed_of(st: IPMState) -> torch.Tensor:
        if not has_soc:
            return st.failed
        # an exit at the iteration cap can leave any primal point: only a
        # cone-feasible iterate may be handed back as usable
        return st.failed | (soc_viol(cone_vals(st.uc, st.uf)) > 2.0 * sqrt_tol)

    return init, body, failed_of


# -- the loop in chunks, and chunks captured as CUDA graphs ---------------------

def _active(st: IPMState, cap: int) -> torch.Tensor:
    """The lanes the loop still advances: not done and under the cap."""
    return ~st.done & (st.iters < cap)


def _chunk(body, state: IPMState, active: torch.Tensor, k: int, cap: int):
    """k turns of the IPM loop with no host read. A turn runs ``body`` over
    every lane, keeps its step in the ``active`` lanes alone (the others keep
    their state, as `jax.vmap` of `lax.while_loop` selects) and finds the
    lanes active in the next turn. A turn with no lane active changes
    nothing, so a chunk that runs past the loop's end ends in the loop's own
    state. Returns (state, active)."""
    for _ in range(k):
        new = body(state)
        state = IPMState(*(lane_where(active, n, o) for n, o in zip(new, state)))
        active = _active(state, cap)
    return state, active


def _engages(device_type: str, opts: _Opts, group) -> bool:
    """Whether the loop runs as captured chunks (`_ChunkGraph`): where
    `graphs.engages` holds, with control bounds alone and no central-path
    target (the logbarrier smoothing's centering tail runs eager)."""
    return (graphs.engages(device_type, group) and opts.has_u
            and not (opts.has_x or opts.has_soc or opts.has_ex) and opts.mu_target <= 0)


# A chunk's iterations, from B M (lanes x particles, the device work of one
# iteration). A chunk of the whole cap reads nothing on the host in the IPM
# but runs the iterations left once every lane has finished: free while the
# device idles through the host's part of an SCP round, a cost once the
# device sets the pace. The headline program (cap 8) on an H100, 700 W
# (PERF.md §6): at B M = 2,048 (0.83 ms of device time an iteration, the
# device busy a fifth of a round) chunks of 8 ran 12% more iterations and
# 1.72x the eager loop's solves/s; at 32,768 (6.77 ms, busy four fifths)
# chunks of 8 ran 6% more iterations and 3% slower than the eager loop,
# chunks of 2 ran 2.5% more and as fast. The switch lies between the two.
# Config 5 (f64, nf = 90, cap 12) at 16,384: chunks of 2 and 4 within the
# run-to-run spread of each other, 3, 6 and 12 slower (PERF.md §6).
CHUNK_LANES = 8192  # B M up to which chunks run up to CHUNK_MAX iterations
CHUNK_MAX = 8  # the longest chunk measured
CHUNK_ABOVE = 2  # the chunk's iterations above CHUNK_LANES


def _chunk_len(lanes: int, cap: int) -> int:
    """Iterations a captured chunk runs, from ``lanes`` = B M: the fewest
    replays of at most the longest chunk that cover the cap, each as short
    as they allow, so that a cap over CHUNK_MAX runs no turn past it where
    the replays divide it (cap 12: two chunks of 6, not two of 8)."""
    kmax = CHUNK_MAX if lanes <= CHUNK_LANES else CHUNK_ABOVE
    return -(-cap // -(-cap // kmax))


GRAPH_CACHE = 4  # captured chunks kept, for the process (`graphs` says why)
_CACHE = graphs.Cache(GRAPH_CACHE, "ipm.capture", "ipm_graph_capture")


def _graph_for(ins: list, state: IPMState, opts: _Opts, cap: int):
    """The captured chunk that runs this call's loop, or None for the eager
    loop; keyed by the inputs (`graphs.key`), options, chunk length and cap."""
    cqp = CondensedQP(*ins[:len(CondensedQP._fields)])
    if not _engages(cqp.qf.device.type, opts, particle_group()):
        return None
    k = _chunk_len(cqp.Hff.shape[0] * cqp.M, cap)
    return _CACHE.get(graphs.key(ins, opts, k, cap),
                      lambda: _ChunkGraph(ins, state, opts, k, cap))


class _ChunkGraph:
    """k iterations of the box IPM (`_chunk`) captured over static copies of
    the inputs and the state, replayed in place of the eager loop: a layout
    graph (`_core`) once a call, then at most ceil(cap / k) chunks, which
    write their state back into its copies, with a host test between (none
    where k covers the cap). A call hands back copies of the state."""

    def __init__(self, ins: list, state: IPMState, opts: _Opts, k: int, cap: int):
        self.active = torch.zeros_like(state.done)  # the lanes active after a chunk
        self.k, self.cap = k, cap
        n, m = len(CondensedQP._fields), len(ins)

        def layout(*s):  # the inputs and the state, the chunk's body from them
            return _core(CondensedQP(*s[:n]), BoxBounds(*s[n:m - 1]), s[m - 1], None, None,
                         opts)[1]

        def chunk():
            new, active = _chunk(self.layout.out, self.state, _active(self.state, cap), k, cap)
            graphs.copy_in((*self.state, self.active), (*new, active))

        self.layout = graphs.Captured(layout, (*ins, *state))
        self.state = IPMState(*self.layout.ins[m:])
        self.chunk = graphs.Captured(chunk)

    def run(self, ins: list, state: IPMState) -> IPMState:
        self.layout.copy_in((*ins, *state))
        self.layout.replay()
        for r in range(-(-self.cap // self.k)):
            if r and not pany(self.active):
                break
            with span("ipm.iter", self.k):
                self.chunk.replay()
            COUNTS["ipm_graph_replay"] += 1
        out = IPMState(*(torch.empty_like(t) for t in self.state))
        graphs.copy_in(out, self.state)
        return out


def _layout_bounds(u_l, u_u, x_l, x_u, M, N, NX, nc, nf, udim, dtype, device=None
                   ) -> BoxBounds:
    """(M, N, udim) / (M, N, xdim) numpy bound arrays (or None) in the
    consensus layout, +-inf where absent, as `BoxBounds` of one problem (a
    leading batch axis of 1) in the numpy ``dtype`` on ``device``. The
    consensus control bounds are particle 0's (``lqp_utils.jl:323-331``)."""
    inf = np.inf

    def flat_u(b, fill):
        if b is None:
            return np.full((M, N * udim), fill, dtype=dtype)
        return np.asarray(b, dtype=dtype).reshape(M, N * udim)

    def flat_x(b, fill):
        if b is None:
            return np.full((M, NX), fill, dtype=dtype)
        return np.asarray(b, dtype=dtype).reshape(M, NX)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)[None]
    ul, uu = flat_u(u_l, -inf), flat_u(u_u, inf)
    return BoxBounds(lo_c=t(ul[0, :nc]), hi_c=t(uu[0, :nc]), lo_f=t(ul[:, nc:]),
                     hi_f=t(uu[:, nc:]), lo_x=t(flat_x(x_l, -inf)), hi_x=t(flat_x(x_u, inf)))


def layout_socs(u_soc_r: torch.Tensor, Nc: int) -> SocSpec:
    """Map (B, M, N) per-stage radii (+inf = no cone) to the consensus cone
    layout; the consensus stages take particle 0's radii (the particle
    group's first rank's, when the particles are spread)."""
    return SocSpec(r_c=pfirst(u_soc_r[:, 0, :Nc]), r_f=u_soc_r[:, :, Nc:])


def map_extras_rows(cqp: CondensedQP, ex_G: torch.Tensor, ex_h: torch.Tensor) -> ExtraRows:
    """Eliminate the state block of full-layout linear rows through the
    condensed map x = Ft w + g: rows (B, l, n_full) over [u_cons; u_free;
    x] become dense rows over w = [uc; uf] plus a shift of h (B, l)."""
    B, l = ex_h.shape
    M, NX, nc, nf = cqp.M, cqp.g.shape[-1], cqp.nc, cqp.nf
    nu_total = nc + M * nf
    G_x = ex_G[..., nu_total:].reshape(B, l, M, NX)
    # (B, M, l, NX) @ (B, M, NX, NU): each particle's state block through Ft
    GxFt = (G_x.transpose(1, 2) @ cqp.Ft).transpose(1, 2)  # (B, l, M, NU)
    Gc = ex_G[..., :nc] + GxFt[..., :nc].sum(2)
    Gf = ex_G[..., nc:nu_total].reshape(B, l, M, nf) + GxFt[..., nc:]
    h = ex_h - (G_x * cqp.g[:, None]).sum((-2, -1))
    return ExtraRows(Gc=Gc, Gf=Gf, h=h)


@full_matmul_precision
def _host_box_solve(base_args, reg_args, bounds, socs, warm, tol_dyn, weights, Nc: int,
                    scale_slew_target: bool, N: int, has_u: bool, has_x: bool,
                    has_soc: bool, iters: int, tol_exp: int, kappa: float, mu_target: float,
                    tau, gondzio: int = 0, ex_G=None, ex_h=None, predictor: bool = True):
    """Assemble, IPM and recover of one host subproblem (tensors with a
    leading batch axis of 1). Returns (X, U, uc, uf, stats)."""
    cqp = assemble_condensed(*base_args, *reg_args, Nc=Nc, weights=weights,
                             scale_slew_target=scale_slew_target)
    has_ex = ex_G is not None
    ex = map_extras_rows(cqp, ex_G, ex_h) if has_ex else None
    uc, uf, stats = ipm_core(
        cqp, bounds, has_u=has_u, has_x=has_x, iters=iters, tol_exp=tol_exp, kappa=kappa,
        mu_target=mu_target, warm=warm, tol_dynamic=tol_dyn, tau=tau, socs=socs,
        has_soc=has_soc, gondzio=gondzio, ex=ex, has_ex=has_ex, predictor=predictor)
    X, U = recover_XU(cqp, uc, uf, N=N)
    return X, U, uc, uf, stats


def ipm_solve_np(base_args, reg_args, u_l, u_u, x_l, x_u, Nc: int, weights=None,
                 settings: Optional[Dict[str, Any]] = None, ex_G=None, ex_h=None,
                 device=None) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """The numpy frontend of the condensed IPM: one subproblem, numpy in and
    out (X (M, N, xdim), U (M, N, udim), data).

    ``base_args`` (x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref) and
    ``reg_args`` (reg_x, reg_u, slew_reg, slew_reg0, slew_um1) as the JAX
    function takes them; the dtype is f's, the tensors go to ``device`` (the
    card when None). ``ex_G (l, n_full)`` / ``ex_h (l,)``: LINEAR extra
    rows over the full consensus layout [u_cons; u_free; x], bordering the
    arrow system (`ExtraRows`). The host path's defaults: ``ipm_iters``
    30, ``ipm_tol_exp`` -8 in f64 and -5 in f32, ``ipm_kappa`` 0 in f64 and
    1e-7 in f32. ``settings["solver_state"]["ipm_warm"]``, the previous
    subproblem's numpy (uc (nc,), uf (M, nf), s (mtot,), lam (mtot,)[, sq,
    zq]), warm-starts it where the shapes match. The inexact-Newton forcing
    ``min(1e-3 r^2, 1e-3)`` follows the SCP residual r in
    ``settings["scp_residual"]`` unless ``ipm_tol_exp`` is given (then only
    ``ipm_adaptive_tol`` turns it on). Everything comes back in ONE
    device-to-host transfer; ``data`` has solver_state (``ipm_warm``),
    ipm_mu, ipm_iters, ipm_converged and ipm_failed."""
    settings = settings or {}
    dev = default_device() if device is None else torch.device(device)
    f = np.asarray(base_args[1])
    M, N, xdim = f.shape
    udim = np.asarray(base_args[3]).shape[-1]
    dtype = f.dtype
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    T = lambda a: torch.as_tensor(np.array(a, dtype=dtype), device=dev)[None]

    nc, nf = Nc * udim, (N - Nc) * udim
    bounds = _layout_bounds(u_l, u_u, x_l, x_u, M, N, N * xdim, nc, nf, udim, dtype,
                            device=dev)
    u_soc_r = settings.get("u_soc_r", None)
    has_soc = u_soc_r is not None
    socs = layout_socs(T(np.broadcast_to(np.asarray(u_soc_r, dtype=dtype), (M, N))), Nc) \
        if has_soc else None

    has_u = u_l is not None or u_u is not None
    has_x = x_l is not None or x_u is not None
    iters = int(settings.get("ipm_iters", 30))
    tol_exp = int(settings.get("ipm_tol_exp", -8 if dtype == np.float64 else -5))
    kappa = float(settings.get("ipm_kappa", 0.0 if dtype == np.float64 else 1e-7))
    mu_target = float(settings.get("mu_target", 0.0))

    # warm start from the previous SCP iteration's primal/dual point, threaded
    # through settings["solver_state"] by the host SCP loop; ignored when the
    # shapes do not match the new problem
    warm = None
    prev_state = settings.get("solver_state") or {}
    has_ex = ex_G is not None
    l_ex = int(np.shape(ex_G)[0]) if has_ex else 0
    cand = prev_state.get("ipm_warm") if isinstance(prev_state, dict) else None
    if cand is not None:
        uc_w, uf_w, s_w, lam_w = cand[:4]
        mtot = 2 * nc + 2 * M * nf + (2 * M * (N * xdim) if has_x else 0) + l_ex
        if (np.shape(uc_w) == (nc,) and np.shape(uf_w) == (M, nf)
                and np.shape(s_w) == (mtot,) and np.shape(lam_w) == (mtot,)):
            warm = tuple(T(z) for z in cand)
            if has_soc and len(warm) < 6:
                warm = None  # cone duals missing: cold start

    # inexact-Newton forcing from the SCP residual (the fused path's
    # adaptive_tol rule); an EXPLICIT ipm_tol_exp asks for that accuracy on
    # every subproblem and turns it off unless ipm_adaptive_tol is set
    tol_dyn = None
    r_scp = settings.get("scp_residual")
    adaptive_dflt = "ipm_tol_exp" not in settings
    if r_scp is not None and np.isfinite(r_scp) \
            and settings.get("ipm_adaptive_tol", adaptive_dflt):
        r = min(float(r_scp), 1e3)
        tol_dyn = torch.full((1,), min(1e-3 * r * r, 1e-3), dtype=tdt, device=dev)

    X, U, uc, uf, stats = _host_box_solve(
        tuple(T(a) for a in base_args), tuple(T(a) for a in reg_args), bounds, socs, warm,
        tol_dyn, None if weights is None else T(weights), Nc=Nc,
        scale_slew_target=bool(settings.get("weights_scale_slew_target", True)),
        N=N, has_u=has_u, has_x=has_x, has_soc=has_soc, iters=iters, tol_exp=tol_exp,
        kappa=kappa, mu_target=mu_target,
        tau=float(settings["ipm_tau"]) if settings.get("ipm_tau") is not None else None,
        gondzio=int(settings.get("ipm_gondzio", 0)),
        predictor=bool(settings.get("ipm_predictor", True)),
        ex_G=T(ex_G) if has_ex else None, ex_h=T(ex_h) if has_ex else None)
    # ONE device->host transfer for everything
    pull = [X, U, uc, uf, stats["s"], stats["lam"], stats["mu"], stats["iters"],
            stats["converged"], stats["failed"]]
    if has_soc:
        pull += [stats["sq"], stats["zq"]]
    host = [a[0] for a in to_host(pull)]
    X_h, U_h, uc_h, uf_h, s_h, lam_h, mu_h, it_h, conv_h, fail_h = host[:10]
    data = dict(
        solver_state=dict(ipm_warm=tuple([uc_h, uf_h, s_h, lam_h] + host[10:])),
        ipm_mu=float(mu_h),
        ipm_iters=int(it_h),
        ipm_converged=bool(conv_h > 0),
        ipm_failed=bool(fail_h > 0),
    )
    return X_h, U_h, data
