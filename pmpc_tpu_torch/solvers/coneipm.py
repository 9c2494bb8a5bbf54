"""Second-order-cone primitives, the Nesterov-Todd scaling and the dense
symmetric-cone IPM.

Twin of ``pmpc_tpu/solvers/coneipm.py``. The JAX primitives (`_soc_W`,
`_soc_scaling`, `_soc_prod`, `_soc_inv`, `_soc_step_len`) take one (p,) cone
point and are mapped with ``jax.vmap``; these take any leading axes,
(..., p), and work on the last one. A cone point u = (u0; u1) lies in the
cone when u0 >= ||u1||; its determinant is det(u) = u0^2 - ||u1||^2 and J =
diag(1, -1, ..., -1).

`cone_qp_solve` is the NT-scaled Mehrotra IPM over nonnegative rows and
padded SOC rows,

    min 0.5 v'Pv + q'v   s.t.  G v + s = h,  s in R+^l x SOC(p_1) x ...,

over an explicit leading batch axis B (the JAX solver runs one program and
is mapped with ``jax.vmap``). Each iteration factors K = P + G'W^2 G once
through `ops.linalg.spd_factor` (on a CUDA tensor the hand kernel K2 for
nv <= 64, K4 for nv <= 96; the library above) and reuses it for the
predictor, both correctors and the safe direction. The condensed and Riccati
IPMs use the primitives for their per-stage control cones, and the two
helpers `_soc_shift` and `_soc_viol`, which both JAX cores write inline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.linalg import spd_apply, spd_factor


def _jdiag(u: torch.Tensor) -> torch.Tensor:
    """The diagonal of J, (p,), in u's dtype and device."""
    J = torch.full((u.shape[-1],), -1.0, dtype=u.dtype, device=u.device)
    # a fill on the device: ``J[0] = 1.0`` copies a host scalar into the
    # card's memory, a synchronising copy that a CUDA graph cannot capture
    J[0].fill_(1.0)
    return J


def _det(u: torch.Tensor) -> torch.Tensor:
    return u[..., 0] ** 2 - (u[..., 1:] ** 2).sum(-1)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def _nt_point(s: torch.Tensor, z: torch.Tensor):
    """The NT point of cone points s, z (..., p): (J, y, w, beta).

    w is the NT point (its quadratic representation P(w) = 2 w w' - det(w) J
    satisfies P(w) z = s, det(w) = beta^2) and y its Jordan square root, so
    that P(y), the symmetric positive square root of P(w), is the scaling W
    with W z = W^-1 s. The clamps at 1e-30, 1e-12 and 1e-20 keep a point on
    the cone's wall finite; zero padding stays neutral (the padded
    coordinates of y and w are 0)."""
    J = _jdiag(s)
    det_s = torch.clamp(_det(s), min=1e-30)
    det_z = torch.clamp(_det(z), min=1e-30)
    sbar = s / torch.sqrt(det_s)[..., None]
    zbar = z / torch.sqrt(det_z)[..., None]
    gamma = torch.sqrt(torch.clamp((1.0 + (sbar * zbar).sum(-1)) / 2.0, min=1e-12))
    wbar = (sbar + J * zbar) / (2.0 * gamma)[..., None]  # normalized, det 1
    beta = (det_s / det_z) ** 0.25
    w = beta[..., None] * wbar
    y0 = torch.sqrt(torch.clamp((w[..., 0] + beta) / 2.0, min=1e-20))
    y = torch.cat([y0[..., None], w[..., 1:] / (2.0 * y0)[..., None]], -1)
    return J, y, w, beta


def _soc_W(s: torch.Tensor, z: torch.Tensor):
    """NT scaling of cone points s, z (..., p) as matrices: (W, W^-1, W^-2,
    lam = W z), each (..., p, p) but lam (..., p)."""
    J, y, w, beta = _nt_point(s, z)
    Jmat = torch.diag(J)
    b = beta[..., None, None]
    W = 2.0 * _outer(y, y) - b * Jmat  # det(y) = beta
    Jy = J * y
    Winv = (2.0 / (b * b)) * _outer(Jy, Jy) - Jmat / b
    Jw = J * w
    W2inv = (2.0 / b ** 4) * _outer(Jw, Jw) - Jmat / (b * b)
    lam = (W @ z[..., None])[..., 0]
    return W, Winv, W2inv, lam


def _soc_prod(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Jordan product (u'v; u0 v1 + v0 u1)."""
    first = (u * v).sum(-1, keepdim=True)
    rest = u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]
    return torch.cat([first, rest], -1)


def _soc_inv(u: torch.Tensor) -> torch.Tensor:
    """Jordan inverse J u / det(u), the determinant held off zero at 1e-30."""
    det = _det(u)
    det = torch.where(det.abs() > 1e-30, det, 1e-30)
    return (_jdiag(u) * u) / det[..., None]


def _soc_step_len(s: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Largest alpha >= 0 with s + alpha ds in the cone, (...,); +inf when
    the ray never leaves it.

    Boundary crossings are roots of det(s + t ds) = a t^2 + b t + c with
    c = det(s) >= 0. The roots come in the cancellation-stable form
    q = -(b + sign(b) sqrt(disc)) / 2, roots q / a and c / q: the naive
    (-b - sqrt(disc)) / (2a) cancels in f32 on near-tangent steps. The
    discriminant itself can still round to the wrong sign near tangency;
    the IPM treats a resulting cone escape as a breakdown. torch.where
    evaluates both branches: their infinities and NaNs are selected away."""
    a = _det(ds)
    b = 2.0 * (s[..., 0] * ds[..., 0] - (s[..., 1:] * ds[..., 1:]).sum(-1))
    c = _det(s)
    disc = b * b - 4.0 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    qq = -0.5 * (b + torch.where(b < 0, -1.0, 1.0) * sqrt_disc)
    r1 = torch.where(a.abs() > 1e-30, qq / a, torch.inf)
    r2 = torch.where(qq.abs() > 1e-30, c / qq, torch.inf)
    # the first coordinate must stay nonnegative too: s0 + alpha ds0 >= 0
    neg = ds[..., 0] < 0
    r0 = torch.where(neg, -s[..., 0] / torch.where(neg, ds[..., 0], -1.0), torch.inf)
    # no boundary crossing (disc < 0): the quadratic's roots do not count
    rq = torch.where((disc >= 0)[..., None], torch.stack([r1, r2], -1), torch.inf)
    cands = torch.cat([rq, r0[..., None]], -1)
    return torch.where(cands > 0, cands, torch.inf).amin(-1)


def _soc_shift(u: torch.Tensor) -> torch.Tensor:
    """Shift each cone point (..., p) into the interior along e = (1; 0): a
    no-op on points comfortably inside (||u1|| - u0 < -1e-3)."""
    a = torch.linalg.vector_norm(u[..., 1:], dim=-1) - u[..., 0]
    shift = torch.where(a < -1e-3, 0.0, 1e-3 + torch.clamp(a, min=0.0) * 1.001)
    return torch.cat([(u[..., 0] + shift)[..., None], u[..., 1:]], -1)


def _soc_viol(v: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Largest ||v1|| - v0 over the live cones (``live`` (B, nq) 1/0) of
    v (B, nq, p), per lane (B,)."""
    return (live * (torch.linalg.vector_norm(v[..., 1:], dim=-1) - v[..., 0])).amax(-1)


def _soc_scaling(s: torch.Tensor, z: torch.Tensor):
    """NT scaling of cone points s, z (..., p) in vector form: (lam, y, w,
    beta) with

        W    = 2 y y' - beta J           (y the Jordan square root of w)
        W^-1 = (2/beta^2) (Jy)(Jy)' - J/beta
        W^-2 = (2/beta^4) (Jw)(Jw)' - J/beta^2
        lam  = W z

    so every scaling is rank-1 plus diagonal, and G'W^-2 G a rank-1 update
    of the constant J-gram G'JG."""
    J, y, w, beta = _nt_point(s, z)
    lam = 2.0 * y * (y * z).sum(-1, keepdim=True) - beta[..., None] * (J * z)
    return lam, y, w, beta


class ConeLP(NamedTuple):
    """A batch of dense cone QPs of one static shape."""

    P: torch.Tensor  # (B, nv, nv)
    q: torch.Tensor  # (B, nv)
    Gl: torch.Tensor  # (B, ml, nv)  nonnegative rows
    hl: torch.Tensor  # (B, ml)
    Gq: torch.Tensor  # (B, ncones, pmax, nv)  SOC blocks, zero-padded
    hq: torch.Tensor  # (B, ncones, pmax)


def _is_f64(dtype) -> bool:
    """True for float64, given as a numpy or a torch dtype."""
    return str(dtype).replace("torch.", "") == "float64"


def cone_host_setup(settings, dtype, sig_key, warm_name, iters32=35, tolexp32=-5,
                    kappa32=1e-7, device=None):
    """Shared prelude of the host cone solves (extras / CVaR).

    Returns (iters, tol_exp, kappa, tol_eff, tol_dyn, warm):
    - a generous f64 iteration cap (the loop exits early on convergence),
    - inexact-Newton forcing from the previous SCP residual (tol =
      clip(1e-3 r^2, 0, 1e-3)); an explicit ``ipm_tol_exp`` turns it off
      unless ``ipm_adaptive_tol`` is set as well,
    - the warm (v, zl, zq) tuple from ``solver_state``, taken only when the
      stored problem signature equals ``sig_key``; its entries become
      tensors with a leading batch axis of 1 on ``device``."""
    f64 = _is_f64(dtype)
    iters = int(settings.get("ipm_iters", 100 if f64 else iters32))
    tol_exp = int(settings.get("ipm_tol_exp", -8 if f64 else tolexp32))
    kappa = float(settings.get("ipm_kappa", 1e-10 if f64 else kappa32))
    tol_eff = 10.0 ** tol_exp
    tol_dyn = None
    r = settings.get("scp_residual", None)
    adaptive_dflt = "ipm_tol_exp" not in settings
    if bool(settings.get("ipm_adaptive_tol", adaptive_dflt)) and r is not None \
            and np.isfinite(r):
        tol_dyn = float(np.clip(1e-3 * r * r, 0.0, 1e-3))
        tol_eff = max(tol_eff, tol_dyn)
    warm = None
    prev = settings.get("solver_state")
    if bool(settings.get("ipm_warm_start", True)) and isinstance(prev, dict) \
            and prev.get(warm_name + "_key") == sig_key:
        cand = prev.get(warm_name)
        if cand is not None:
            tdt = torch.float64 if f64 else torch.float32
            warm = tuple(torch.tensor(np.asarray(a), dtype=tdt, device=device)[None]
                         for a in cand)
    return iters, tol_exp, kappa, tol_eff, tol_dyn, warm


def cone_host_state(sig_key, warm_name, v, z):
    """The ``solver_state`` payload: the warm tuple (v, zl, zq) of one
    problem (no batch axis) as numpy, and its signature key."""
    warm_out = (v, z[0], z[1])
    return {warm_name: tuple(a.detach().cpu().numpy() for a in warm_out),
            warm_name + "_key": sig_key}


def cone_host_stats(stats, tol_eff):
    """The solve-quality report of one problem, with the hard-failure flag:
    a cone IPM far from its central path returned no usable point, and the
    SCP loop rejects that subproblem."""
    mu = float(stats["mu"])
    converged = bool(stats["converged"])
    return dict(
        ipm_mu=mu,
        ipm_iters=int(stats["iters"]),
        ipm_converged=converged,
        ipm_failed=bool((not converged) and (not np.isfinite(mu) or mu > 1e2 * tol_eff)),
    )


def _lane(x: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-lane (B,) tensor shaped to broadcast over ``nd`` trailing dims."""
    return x.reshape(x.shape + (1,) * nd)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


# the host reads "are all lanes done?" once every this many iterations; the
# iterations in between run with every finished lane frozen, so the counts
# do not change
CHECK_EVERY = 4


def cone_qp_solve(prob: ConeLP, iters: int = 35, tol_exp: int = -8, kappa: float = 0.0,
                  tol_dynamic=None, warm=None, debug_trace: bool = False):
    """Solve the batch of cone QPs; returns (v, (sl, sq), (zl, zq), stats)
    with stats mu, iters, converged, each (B,).

    ``tol_dynamic`` (None, a float or a (B,) tensor) raises the tolerance to
    ``max(10^tol_exp, tol_dynamic)``. ``warm`` is a (v, zl, zq) tuple of a
    previous solve of the same padded shapes: the slacks are recomputed from
    the warm primal against the new constraints and nudged into the cone
    interiors, the duals carry over.

    Every lane runs the JAX while-loop's iterations: a lane whose condition
    (not done, fewer than ``iters`` steps) turned false keeps its whole
    state, so each lane's count equals the JAX lane's.

    ``debug_trace=True`` runs every lane for exactly ``iters`` steps (the
    JAX fixed-length scan: a lane that is done keeps its state, and its
    entries are still computed on that frozen state) and adds
    ``stats["trace"]``: mu, a, a_aff, sigma, rp, rd and bad, each (B,
    iters), filled on the device and read by no host sync inside the
    loop."""
    dtype, dev = prob.q.dtype, prob.q.device
    B, nv = prob.q.shape
    ml = prob.hl.shape[-1]
    ncones, pmax = prob.hq.shape[-2:]
    tol = torch.full((B,), 10.0 ** tol_exp, dtype=dtype, device=dev)
    if tol_dynamic is not None:
        tol = torch.maximum(tol, torch.as_tensor(tol_dynamic, dtype=dtype, device=dev))
    sqrt_tol = torch.sqrt(tol)

    if ml == 0 and ncones == 0:
        # unconstrained QP: the Newton solution is exact
        v = spd_apply(spd_factor(prob.P, jitter=kappa), -prob.q)
        zero = torch.zeros((B, 0), dtype=dtype, device=dev)
        zeroq = torch.zeros((B, 0, pmax), dtype=dtype, device=dev)
        stats = dict(mu=torch.zeros(B, dtype=dtype, device=dev),
                     iters=torch.zeros(B, dtype=torch.int32, device=dev),
                     converged=torch.ones(B, dtype=torch.bool, device=dev))
        return v, (zero, zeroq), (zero, zeroq), stats

    # an empty family gets one neutral dummy (0'v <= 1, or a free SOC slack
    # at e): its slack converges like any inactive constraint and never
    # touches K or the primal (the JAX code pads for its compiler; the
    # iterates must match, so the port pads too)
    if ml == 0:
        prob = prob._replace(Gl=torch.zeros((B, 1, nv), dtype=dtype, device=dev),
                             hl=torch.ones((B, 1), dtype=dtype, device=dev))
        ml = 1
    if ncones == 0:
        pmax = max(pmax, 2)
        hq = torch.zeros((B, 1, pmax), dtype=dtype, device=dev)
        hq[:, 0, 0] = 1.0
        prob = prob._replace(Gq=torch.zeros((B, 1, pmax, nv), dtype=dtype, device=dev), hq=hq)
        ncones = 1
    P, q, Gl, hl, Gq, hq = prob

    nu = ml + ncones  # cone degree for the mu normalization
    tau = 0.99 if dtype == torch.float64 else 0.95
    wl_max = 1e14 if dtype == torch.float64 else 1e7
    e_soc = torch.zeros((ncones, pmax), dtype=dtype, device=dev)
    e_soc[:, 0] = 1.0
    Jq = _jdiag(hq)
    Gq2d = Gq.reshape(B, ncones * pmax, nv)
    GlT, Gq2dT = Gl.mT, Gq2d.mT
    # wide cones (the CVaR epigraph class): G'W^-2 G = rank-1 - weighted
    # J-gram, and the per-cone J-grams G_c'JG_c are constant; for narrow
    # cones the (c, nv, nv) buffer costs more than it saves
    use_jgram = pmax >= 32
    if use_jgram:
        Tq = ((Gq * Jq[:, None]).mT @ Gq).reshape(B, ncones, nv * nv)

    def Gq_mv(x):  # (B, nv) -> (B, c, p)
        return _mv(Gq2d, x).reshape(B, ncones, pmax)

    def GqT_mv(y):  # (B, c, p) -> (B, nv)
        return _mv(Gq2dT, y.reshape(B, -1))

    def init():
        # least-squares primal; slacks shifted into the cone interiors; SOC
        # duals on the central ray, scaled by the residual
        GtG = GlT @ Gl + Gq2dT @ Gq2d
        Gth = _mv(GlT, hl) + GqT_mv(hq)
        v = spd_apply(spd_factor(P + GtG, jitter=1e-8), -q + Gth)
        res_l = hl - _mv(Gl, v)
        res_q = hq - Gq_mv(v)
        a = -res_l.amin(-1)
        sl = torch.where(_lane(a < 0, 1), res_l, res_l + _lane(1.0 + a, 1))
        zl = torch.clamp(-res_l, min=1.0)
        a = torch.linalg.vector_norm(res_q[..., 1:], dim=-1) - res_q[..., 0]
        sq = res_q.clone()
        sq[..., 0] += torch.where(a < 0, 0.0, 1.0 + a)
        scale_q = torch.clamp(torch.linalg.vector_norm(res_q, dim=-1), min=1.0)
        zq = e_soc * scale_q[..., None]
        return v, sl, zl, sq, zq

    def init_warm(w):
        vw, zlw, zqw = (torch.as_tensor(a, dtype=dtype, device=dev) for a in w)
        delta = 1e-2
        res_l = hl - _mv(Gl, vw)
        sl = torch.clamp(res_l, min=delta)
        zl = torch.clamp(zlw, min=delta)
        res_q = hq - Gq_mv(vw)
        a = torch.linalg.vector_norm(res_q[..., 1:], dim=-1) - res_q[..., 0]
        sq = res_q.clone()
        sq[..., 0] += torch.clamp(a, min=0.0) + delta
        zq = zqw.clone()
        az = torch.linalg.vector_norm(zq[..., 1:], dim=-1) - zq[..., 0]
        zq[..., 0] += torch.clamp(az, min=0.0) + delta
        return vw, sl, zl, sq, zq

    def posratio(val, dval):
        neg = dval < 0
        return torch.where(neg, -val / torch.where(neg, dval, -1.0), torch.inf).amin(-1)

    def step_len(sl_, dsl, zl_, dzl, sq_, dsq, zq_, dzq):
        ap = torch.minimum(posratio(sl_, dsl), _soc_step_len(sq_, dsq).amin(-1))
        ad = torch.minimum(posratio(zl_, dzl), _soc_step_len(zq_, dzq).amin(-1))
        return torch.clamp(tau * ap, max=1.0), torch.clamp(tau * ad, max=1.0)

    def body(carry):
        v, sl, zl, sq, zq, done, ok, mu_prev, nsteps, badc = carry
        r_d = _mv(P, v) + q + _mv(GlT, zl) + GqT_mv(zq)
        r_pl = _mv(Gl, v) + sl - hl
        r_pq = Gq_mv(v) + sq - hq

        wl2 = torch.clamp(zl / sl, max=wl_max)
        lamq, Yq, Wvq, betaq = _soc_scaling(sq, zq)
        mu = ((sl * zl).sum(-1) + (sq * zq).sum((-2, -1))) / nu
        JYq, JWq = Jq * Yq, Jq * Wvq
        b2 = betaq * betaq
        bq, b2q = betaq[..., None], b2[..., None]

        def socW(x):
            return 2.0 * Yq * (Yq * x).sum(-1, keepdim=True) - bq * (Jq * x)

        def socWinv(x):
            return (2.0 / b2q) * JYq * (JYq * x).sum(-1, keepdim=True) - (Jq * x) / bq

        def socW2inv(x):
            return (2.0 / (b2q * b2q)) * JWq * (JWq * x).sum(-1, keepdim=True) \
                - (Jq * x) / b2q

        # G'W^-2 G = (2/beta^4) (G'Jw)(G'Jw)' - (1/beta^2) G'JG per cone
        Uq = (JWq[..., None, :] @ Gq)[..., 0, :]  # (B, c, nv)
        K_soc = (Uq * (2.0 / (b2 * b2))[..., None]).mT @ Uq
        if use_jgram:
            K_soc = K_soc - ((1.0 / b2)[:, None, :] @ Tq).reshape(B, nv, nv)
        else:
            dJ = (Jq / b2q).reshape(B, -1)
            K_soc = K_soc - (Gq2dT * dJ[:, None, :]) @ Gq2d
        K = P + (GlT * wl2[:, None, :]) @ Gl + K_soc
        # breakdown retries boost the regularization (badc grows on bad steps)
        diag_scale = K.diagonal(dim1=-2, dim2=-1).mean(-1) + 1.0
        boost = badc.to(dtype) ** 2 * 1e-4 * diag_scale
        K = K + _lane(boost, 2) * torch.eye(nv, dtype=dtype, device=dev)
        L = spd_factor(K, jitter=kappa)
        lam_inv = _soc_inv(lamq)

        def solve_dir(dl_c, dq_c):
            """Newton direction for the complementarity targets dl_c (R+) and
            dq_c (SOC, scaled space): dz = W^-2 (G dv + r_p) -
            W^-1 (lam^-1 o d_c), K dv = -(r_d + G'[W^-2 r_p - W^-1 (lam^-1 o
            d_c)])."""
            wld = socWinv(_soc_prod(lam_inv, dq_c))
            rhs = -(r_d + _mv(GlT, wl2 * r_pl - dl_c / sl) + GqT_mv(socW2inv(r_pq) - wld))
            dv = spd_apply(L, rhs)
            Gdv_l, Gdv_q = _mv(Gl, dv), Gq_mv(dv)
            return (dv, -r_pl - Gdv_l, wl2 * (Gdv_l + r_pl) - dl_c / sl,
                    -r_pq - Gdv_q, socW2inv(Gdv_q + r_pq) - wld)

        def steps(d):
            ap, ad = step_len(sl, d[1], zl, d[2], sq, d[3], zq, d[4])
            return torch.minimum(ap, ad)

        def pick(use, d_new, d_old):
            return tuple(torch.where(_lane(use, x.ndim - 1), xn, x)
                         for xn, x in zip(d_new, d_old))

        # predictor
        lam2 = _soc_prod(lamq, lamq)
        d_a = solve_dir(sl * zl, lam2)
        a_a = steps(d_a)
        _, dsl_a, dzl_a, dsq_a, dzq_a = d_a
        a1, a2_ = _lane(a_a, 1), _lane(a_a, 2)
        mu_aff = (((sl + a1 * dsl_a) * (zl + a1 * dzl_a)).sum(-1)
                  + ((sq + a2_ * dsq_a) * (zq + a2_ * dzq_a)).sum((-2, -1))) / nu
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
        smu1, smu2 = _lane(sigma * mu, 1), _lane(sigma * mu, 2)

        # corrector: d_c = lam o lam + (W^-T ds_aff) o (W dz_aff) - sigma mu e
        so_l = dsl_a * dzl_a
        so_q = _soc_prod(socWinv(dsq_a), socW(dzq_a))
        d = solve_dir(sl * zl + so_l - smu1, lam2 + so_q - smu2 * e_soc)
        a = steps(d)
        # the full correction can overshoot SOC walls, the damped one stalls
        # LP-like programs: compute both, keep the larger step where the full
        # one collapses against the affine step
        damp = a_a * a_a
        d2 = solve_dir(sl * zl + _lane(damp, 1) * so_l - smu1,
                       lam2 + _lane(damp, 2) * so_q - smu2 * e_soc)
        a2 = steps(d2)
        use2 = (a < 0.5 * a_a) & (a2 > a)
        d = pick(use2, d2, d)
        a = torch.where(use2, a2, a)
        # recovery: a plain centering direction (sigma = 0.8) where the
        # corrector step still collapses
        d3 = solve_dir(sl * zl - _lane(0.8 * mu, 1), lam2 - _lane(0.8 * mu, 2) * e_soc)
        a3 = steps(d3)
        use_safe = a < 0.05
        dv, dsl, dzl, dsq, dzq = pick(use_safe, d3, d)
        a = torch.where(use_safe, a3, a)

        a1, a2_ = _lane(a, 1), _lane(a, 2)
        v_n = v + a1 * dv
        sl_n, zl_n = sl + a1 * dsl, zl + a1 * dzl
        sq_n, zq_n = sq + a2_ * dsq, zq + a2_ * dzq
        mu_n = ((sl_n * zl_n).sum(-1) + (sq_n * zq_n).sum((-2, -1))) / nu

        rp_inf = torch.maximum(r_pl.abs().amax(-1), r_pq.abs().amax((-2, -1)))
        rd_inf = r_d.abs().amax(-1)
        # a non-finite or exploding step keeps the previous iterate and bumps
        # the retry counter; so does a step that lands outside a cone (a
        # missed boundary crossing)
        step_bad = ~(torch.isfinite(mu_n) & torch.isfinite(v_n.sum(-1))) \
            | (mu_n > torch.clamp(1e4 * mu_prev, min=1e12))
        esc = lambda u_: (torch.linalg.vector_norm(u_[..., 1:], dim=-1) - u_[..., 0]).amax(-1)
        step_bad = step_bad | (esc(sq_n) > 0) | (esc(zq_n) > 0)
        now_done = (~step_bad) & (mu_n < tol) & (rp_inf < sqrt_tol) & (rd_inf < 1e3 * tol)

        frozen = done | step_bad
        new = (v_n, sl_n, zl_n, sq_n, zq_n)
        old = (v, sl, zl, sq, zq)
        v_o, sl_o, zl_o, sq_o, zq_o = (torch.where(_lane(frozen, n.ndim - 1), o, n)
                                       for n, o in zip(new, old))
        mu_o = torch.where(frozen, mu_prev, mu_n)
        steps_o = nsteps + torch.where(done, 0, 1).to(nsteps.dtype)
        badc_o = torch.where(done, badc, torch.where(step_bad, badc + 1, 0)).to(badc.dtype)
        give_up = badc_o >= 4
        trace = dict(mu=mu_n, a=a, a_aff=a_a, sigma=sigma, rp=rp_inf, rd=rd_inf,
                     bad=step_bad)
        return (v_o, sl_o, zl_o, sq_o, zq_o, done | now_done | give_up, ok | now_done,
                mu_o, steps_o, badc_o), trace

    v0, sl0, zl0, sq0, zq0 = init() if warm is None else init_warm(warm)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    carry = (v0, sl0, zl0, sq0, zq0, false, false,
             torch.ones(B, dtype=dtype, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    if debug_trace:
        # the fixed-length `lax.scan`: the body alone freezes finished lanes
        tr = {k: torch.empty((B, iters), dtype=torch.bool if k == "bad" else dtype,
                             device=dev)
              for k in ("mu", "a", "a_aff", "sigma", "rp", "rd", "bad")}
        for n in range(iters):
            carry, step_tr = body(carry)
            for k, x in step_tr.items():
                tr[k][:, n] = x
    else:
        # `jax.vmap(lax.while_loop)`: the body runs while ANY lane's condition
        # holds, and a lane whose own condition is false keeps its whole carry
        for n in range(iters):
            active = ~carry[5] & (carry[8] < iters)
            if n % CHECK_EVERY == 0 and not bool(active.any()):
                break
            new = body(carry)[0]
            carry = tuple(torch.where(_lane(active, x.ndim - 1), xn, x)
                          for xn, x in zip(new, carry))
    v, sl, zl, sq, zq, done, ok, mu, nsteps, _ = carry
    stats = dict(mu=mu, iters=nsteps, converged=ok)
    if debug_trace:
        stats["trace"] = tr
    return v, (sl, sq), (zl, zq), stats
