"""Batched primal-dual interior-point method for the condensed consensus QP.

Twin of ``pmpc_tpu/solvers/ipm.py``, box path: control bounds (``has_u``)
and state boxes (``has_x``), no SOC cones, no extra rows, Mehrotra
predictor-corrector, no Gondzio correctors, ``mu_target = 0``:

    min 0.5 z'Hz + q'z   s.t.  lo_u <= u <= hi_u,  lo_x <= Ft z + g <= hi_x.

With control bounds only, every Newton matrix is H plus a diagonal, so each
iteration costs one diagonal-adding per-particle factor (`arrow_factor_diag`,
kernel K1, or K3 past n = 64) and one consensus Schur factor (K2), both
reused by the predictor and the corrector. State boxes add per-particle
``Ft' D Ft`` terms (`box_weighted_K`); the Newton blocks are then formed and
go to the factor without a diagonal (K2, or K4 past n = 64).

The JAX core runs one scenario under ``jax.vmap``; here the scenario axis B
is explicit. Every reduction is per lane (over all dims but B), and the
per-lane scalars (tol, mu, done, ok, iters, failed, step lengths) are (B,)
tensors. The batched ``while_loop`` becomes a Python loop that runs while
any lane is active; a lane that is not active keeps its state unchanged
(``jax.vmap`` of ``lax.while_loop`` selects the same way), on top of the
body's own freeze. The loop test costs one host sync per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import lane_where
from .reduced import CondensedQP, H_apply_factored, arrow_apply, arrow_factor, \
    arrow_factor_diag, z_to_w


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


class IPMState(NamedTuple):
    uc: torch.Tensor  # (B, nc)
    uf: torch.Tensor  # (B, M, nf)
    s: torch.Tensor  # (B, mtot) flat slacks [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi]
    lam: torch.Tensor  # (B, mtot) flat multipliers, same order
    mu: torch.Tensor  # (B,) duality measure
    done: torch.Tensor  # (B,) bool: converged OR diverged, stop updating
    ok: torch.Tensor  # (B,) bool: converged
    iters: torch.Tensor  # (B,) int32 iterations taken
    failed: torch.Tensor  # (B,) bool: gave up (the iterate has NO
    #                       feasibility guarantee)


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"ipm_core: {what} is not ported yet ({item})")


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
            Kcc = Kcc + (Ftc.mT @ (wx[..., None] * Ftc)).sum(dim=-3)
            Kcf = Kcf + Ftc.mT @ DFtf
    return Kcc, Kcf, Kff


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
    has_soc: bool = False,
    gondzio: int = 0,
    has_ex: bool = False,
    predictor: bool = True,
):
    """Run the predictor-corrector IPM on a batch. Returns (uc, uf, stats).

    All box constraint groups live in ONE flat (B, mtot) vector, order
    [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi]; the state rows exist only with
    ``has_x``. ``has_u=False`` ignores the control bounds entirely (their
    rows are masked). ``warm`` is (uc (B,nc), uf (B,M,nf), s (B,mtot),
    lam (B,mtot)); ``tol_dynamic`` (B,) overrides the static tol
    ``10**tol_exp`` where larger. ``stats``: mu, iters, converged, failed
    (all (B,)), s, lam.
    """
    if has_soc:
        _unsupported("SOC cones (has_soc)", "ROADMAP §1.4, coneipm._soc_*")
    if has_ex:
        _unsupported("extra rows (has_ex)", "ROADMAP §1.4, ExtraRows")
    if gondzio:
        _unsupported("Gondzio correctors", "ROADMAP §1.4")
    if not predictor:
        _unsupported("predictor=False", "ROADMAP §1.4")
    if mu_target > 0:
        _unsupported("mu_target > 0 (centering phase)", "ROADMAP §1.4")

    dtype, dev = cqp.qf.dtype, cqp.qf.device
    B, M, nc, nf = cqp.Hff.shape[0], cqp.M, cqp.nc, cqp.nf
    tol = torch.full((B,), 10.0 ** tol_exp, dtype=dtype, device=dev)
    if tol_dynamic is not None:
        tol = torch.maximum(tol_dynamic.to(dtype), tol)
    sqrt_tol = torch.sqrt(tol)
    tau = torch.tensor(0.99 if tau is None else tau, dtype=dtype, device=dev)
    NX = cqp.g.shape[-1]
    Ftc = Ftf = None
    if has_x:  # (B, M, NX, nc/nf), loop-invariant matmul operands
        Ftc, Ftf = cqp.Ft[..., :nc].contiguous(), cqp.Ft[..., nc:].contiguous()
    mnf = M * nf
    mnx = M * NX if has_x else 0  # state rows only when state bounds are active
    o_chi, o_flo, o_fhi, o_xlo, o_xhi = (
        nc, 2 * nc, 2 * nc + mnf, 2 * nc + 2 * mnf, 2 * nc + 2 * mnf + mnx)

    lo_parts = [bounds.lo_c, bounds.hi_c,
                bounds.lo_f.reshape(B, -1), bounds.hi_f.reshape(B, -1)]
    if not has_u:
        # the control bounds are IGNORED: finite entries would activate mask
        # rows whose barrier terms `box_weighted_K` skips
        lo_parts = [torch.full_like(a, -torch.inf) for a in lo_parts]
    if has_x:
        lo_parts += [bounds.lo_x.reshape(B, -1), bounds.hi_x.reshape(B, -1)]
    mask = torch.isfinite(torch.cat(lo_parts, -1))
    n_act = torch.clamp(mask.sum(-1).to(dtype), min=1.0)

    def states(uc, uf):
        """Ft z as (B, M, NX)."""
        return (cqp.Ft @ z_to_w(uc, uf)[..., None])[..., 0]

    def slack_vals(uc, uf):
        """s = h - Gz as one flat (B, mtot) vector (garbage on masked rows)."""
        vals = [uc - bounds.lo_c, bounds.hi_c - uc,
                (uf - bounds.lo_f).reshape(B, -1),
                (bounds.hi_f - uf).reshape(B, -1)]
        if has_x:
            x = states(uc, uf) + cqp.g
            vals += [(x - bounds.lo_x).reshape(B, -1),
                     (bounds.hi_x - x).reshape(B, -1)]
        return torch.cat(vals, -1)

    def g_dot_z(duc, duf):
        duf_f = duf.reshape(B, -1)
        parts = [-duc, duc, -duf_f, duf_f]
        if has_x:
            dx = states(duc, duf).reshape(B, -1)
            parts += [-dx, dx]
        return torch.cat(parts, -1)

    def gT_dot(v):
        """(G' v) split into consensus/free contributions."""
        bc = v[:, o_chi:o_flo] - v[:, :nc]
        bf = (v[:, o_fhi:o_xlo] - v[:, o_flo:o_fhi]).reshape(B, M, nf)
        if has_x:
            dv = (v[:, o_xhi:] - v[:, o_xlo:o_xhi]).reshape(B, M, NX, 1)
            bc = bc + (Ftc.mT @ dv)[..., 0].sum(dim=-2)
            bf = bf + (Ftf.mT @ dv)[..., 0]
        return bc, bf

    def mu_of(s_, lam_):
        return torch.where(mask, s_ * lam_, 0.0).sum(-1) / n_act

    # -- initialization -------------------------------------------------------
    if warm is not None:
        # warm point with a Yildirim-Wright interior shift; slacks recomputed
        # from the warm primal against the new bounds
        uc0, uf0, _, warm_lam = warm[:4]
        delta = 1e-2
        s0 = torch.where(mask, torch.clamp(slack_vals(uc0, uf0), min=delta), 1.0)
        lam0 = torch.where(mask, torch.clamp(warm_lam, min=delta), 0.0)
    else:
        F0 = arrow_factor(cqp.Hcc, cqp.Hcf, cqp.Hff, jitter=kappa)
        uc0, uf0 = arrow_apply(F0, -cqp.qc, -cqp.qf)
        s0 = torch.where(mask, torch.clamp(slack_vals(uc0, uf0), min=1.0), 1.0)
        lam0 = torch.where(mask, 1.0 / s0, 0.0)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    state = IPMState(uc0, uf0, s0, lam0, mu_of(s0, lam0), false, false,
                     torch.zeros(B, dtype=torch.int32, device=dev), false)

    def grad_lagrangian(uc, uf, lam):
        """(gc, gf) = Hz + q + G'lam, Hz in factored form."""
        Hc, Hf = H_apply_factored(cqp, uc, uf)
        dc, df = gT_dot(lam)
        return Hc + cqp.qc + dc, Hf + cqp.qf + df

    w_max = 1e14 if dtype == torch.float64 else 1e7

    def body(st: IPMState) -> IPMState:
        uc, uf, s, lam, mu, done, ok, it_count, failed = st
        r_p = torch.where(mask, s - slack_vals(uc, uf), 0.0)
        gc, gf = grad_lagrangian(uc, uf, lam)

        # capped scaling ratios: uncapped lam/s overflows the f32 factor late
        w = torch.where(mask, torch.clamp(lam / s, max=w_max), 0.0)
        wc_d = w[:, :nc] + w[:, o_chi:o_flo]
        wf_d = (w[:, o_flo:o_fhi] + w[:, o_fhi:o_xlo]).reshape(B, M, nf)
        if has_u and not has_x:
            # box-only fast path: K = H + diag(w), the diagonal folded into
            # the factor kernel, so the Newton matrix never materializes
            F = arrow_factor_diag(cqp.Hcc, cqp.Hcf, cqp.Hff, wc_d, wf_d,
                                  jitter=kappa)
        else:
            wx = (w[:, o_xlo:o_xhi] + w[:, o_xhi:]).reshape(B, M, NX) \
                if has_x else None
            F = arrow_factor(*box_weighted_K(cqp, wc_d, wf_d, wx, Ftc, Ftf,
                                             has_u=has_u, has_x=has_x),
                             jitter=kappa)

        def newton_rhs(r_c):
            v = torch.where(mask, (lam * r_p - r_c) / s, 0.0)
            dc, df = gT_dot(v)
            return -(gc + dc), -(gf + df), v

        def recover_steps(duc, duf, v):
            gdz = g_dot_z(duc, duf)
            ds = torch.where(mask, -r_p - gdz, 0.0)
            dlam = torch.where(mask, w * gdz + v, 0.0)
            return ds, dlam

        def step_len(s_, ds, lam_, dlam):
            # torch.where evaluates both branches: the inner guards keep the
            # unused branch finite
            rp_ = torch.where(mask & (ds < 0),
                              -s_ / torch.where(ds < 0, ds, -1.0), torch.inf)
            rd_ = torch.where(mask & (dlam < 0),
                              -lam_ / torch.where(dlam < 0, dlam, -1.0), torch.inf)
            mins = torch.stack([rp_, rd_], 1).amin(-1)  # (B, 2)
            return (torch.clamp(tau * mins[:, 0], max=1.0),
                    torch.clamp(tau * mins[:, 1], max=1.0))

        # predictor (affine) step
        bc, bf, v_aff = newton_rhs(torch.where(mask, s * lam, 0.0))
        duc_a, duf_a = arrow_apply(F, bc, bf)
        ds_a, dlam_a = recover_steps(duc_a, duf_a, v_aff)
        ap_a, ad_a = step_len(s, ds_a, lam, dlam_a)
        mu_aff = mu_of(s + ap_a[:, None] * ds_a, lam + ad_a[:, None] * dlam_a)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
        sig_mu = sigma * mu
        # corrector (reuses the factorization)
        r_c = torch.where(mask, s * lam + ds_a * dlam_a - sig_mu[:, None], 0.0)
        bc, bf, v = newton_rhs(r_c)
        duc, duf = arrow_apply(F, bc, bf)
        ds, dlam = recover_steps(duc, duf, v)
        ap, ad = step_len(s, ds, lam, dlam)

        uc_n = uc + ap[:, None] * duc
        uf_n = uf + ap[:, None, None] * duf
        s_n = torch.where(mask, s + ap[:, None] * ds, 1.0)
        lam_n = torch.where(mask, lam + ad[:, None] * dlam, 0.0)
        mu_n = mu_of(s_n, lam_n)

        # convergence / divergence tests (per lane)
        rp_inf = r_p.abs().amax(-1)
        gd_inf = torch.cat([gc, gf.reshape(B, -1)], -1).abs().amax(-1)
        # non-finite steps freeze to the PREVIOUS iterate
        step_bad = ~(torch.isfinite(mu_n) & torch.isfinite(uc_n.sum(-1))
                     & torch.isfinite(uf_n.sum((-2, -1))))
        now_done = (mu_n < tol) & (rp_inf < sqrt_tol) & (gd_inf < 1e3 * tol)
        now_bad = step_bad | (mu_n > 1e12)
        give_up = now_bad  # box path: freeze on the first bad step

        frozen = done | now_bad
        # already-done lanes do not count an iteration
        it_old = it_count + torch.where(done, 0, 1).to(it_count.dtype)
        new = IPMState(uc_n, uf_n, s_n, lam_n, mu_n, false, ok | now_done,
                       it_count + 1, failed)
        old = IPMState(uc, uf, s, lam, mu, false, ok, it_old, failed)
        merged = IPMState(*(lane_where(frozen, o, n) for n, o in zip(new, old)))
        return merged._replace(done=done | now_done | give_up, ok=ok | now_done,
                               failed=failed | (give_up & ~ok & ~now_done))

    # the loop of `jax.vmap(lax.while_loop)`: runs while ANY lane's condition
    # holds; lanes whose own condition is false keep their state
    while True:
        active = ~state.done & (state.iters < iters)
        if not bool(active.any()):
            break
        new = body(state)
        state = IPMState(*(lane_where(active, n, o) for n, o in zip(new, state)))

    stats = dict(mu=state.mu, iters=state.iters, converged=state.ok,
                 failed=state.failed, s=state.s, lam=state.lam)
    return state.uc, state.uf, stats
