"""Plain reference of the particle consensus MPC problem, batched over lanes,
in plain PyTorch, and independent of the program under test.

The problem of one lane: M particles start from x0[m] and share the first Nc
controls; each follows the user's dynamics x_{j+1} = step(x_j, u_j). Find U
minimizing

    1/2 sum_m sum_j q ||x_{m,j+1} - xr_{m,j}||^2 + r ||u_{m,j} - ur_{m,j}||^2

subject to lo <= u <= hi. The decision vector of a lane is
z = [u shared (nc = Nc udim); u free of particle 0 (nf = (N - Nc) udim); ...;
of particle M-1], so its Hessian is an arrow: a shared block, each
particle's free block, and their couplings, with no coupling between
particles' free blocks (`Arrow`).

The method is projected Newton with a backtracking line search on that cost:
each iteration rolls the controls out through the dynamics, takes the
Jacobians by reverse-mode autodiff, condenses them into the affine map
X = F w + c of each particle (w = vec(U)), and solves the box QP of the
quadratic model by a primal-dual interior-point method, whose Newton systems
it factors by block elimination of the arrow, and whose active set it then
makes exact by primal-dual active-set rounds. The model's Hessian is the
exact one: the Gauss-Newton term F'qF + rI plus the dynamics' second-order
term (each stage's Hessian of p'f, p the adjoint, mapped through the
sensitivities), so the iterations converge quadratically; a lane where that
is not positive definite, or whose last exact step found no descent, takes
the Gauss-Newton Hessian alone. Its fixed
points are the KKT points of the problem above, the same points at which a
sequential convex programming solver stops. The answer is U with the states
X = F w + c of the last condensed map, as a QP-based solver returns them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PIN = 1e3  # the proximal weight on controls at a bound in a Newton step
POLISH_ROUNDS = 8  # active-set steps after the interior point
FLAT = 1e-12  # a decrease under this share of the cost is below its float64 rounding


def rollout(step, x0, U):
    """States after each step, (..., N, xdim), from x0 (..., xdim) under U
    (..., N, udim)."""
    x, xs = x0, []
    for j in range(U.shape[-2]):
        x = step(x, U[..., j, :])
        xs.append(x)
    return torch.stack(xs, dim=-2)


def jacobians(step, X_in, U):
    """(fx (..., xdim, xdim), fu (..., xdim, udim)) of ``step`` at every
    point: X_in (..., xdim), U (..., udim)."""
    xdim, udim = X_in.shape[-1], U.shape[-1]
    x, u = X_in.reshape(-1, xdim), U.reshape(-1, udim)
    fx, fu = torch.func.vmap(torch.func.jacrev(step, argnums=(0, 1)))(x, u)
    lead = X_in.shape[:-1]
    return fx.reshape(lead + (xdim, xdim)), fu.reshape(lead + (xdim, udim))


def second_order(step, X_in, U, P):
    """Each stage's Hessian (..., N, xdim + udim, xdim + udim) of p'f(x, u)
    in (x, u), at X_in, U with the adjoints P (..., N, xdim)."""
    xdim, udim = X_in.shape[-1], U.shape[-1]
    k = xdim + udim
    xu = torch.cat([X_in, U], -1).reshape(-1, k)
    lag = lambda v, p: (p * step(v[:xdim], v[xdim:])).sum()
    W = torch.func.vmap(torch.func.hessian(lag))(xu, P.reshape(-1, xdim))
    return W.reshape(X_in.shape[:-1] + (k, k))


def condense(fx, fu):
    """The sensitivity F (..., N xdim, N udim) of the states after each step
    to the controls: block (j, l) is fx_j ... fx_{l+1} fu_l for l <= j, zero
    above."""
    N, xdim, udim = fu.shape[-3], fu.shape[-2], fu.shape[-1]
    lead = fu.shape[:-3]
    row = torch.zeros(lead + (xdim, N * udim), dtype=fu.dtype, device=fu.device)
    rows = []
    for j in range(N):
        row = fx[..., j, :, :] @ row
        row[..., j * udim:(j + 1) * udim] = row[..., j * udim:(j + 1) * udim] + fu[..., j, :, :]
        rows.append(row)
    return torch.stack(rows, dim=-3).reshape(lead + (N * xdim, N * udim))


class Arrow(NamedTuple):
    """A lane's symmetric matrix over z = [shared; free_0; ...; free_M-1]:
    cc (L, nc, nc), cf (L, M, nc, nf) (shared rows, particle m's free
    columns), ff (L, M, nf, nf)."""

    cc: torch.Tensor
    cf: torch.Tensor
    ff: torch.Tensor

    @staticmethod
    def of_particles(Hm, nc):
        """The lane's matrix from each particle's (L, M, NU, NU) over its
        own controls [shared; free]."""
        return Arrow(Hm[:, :, :nc, :nc].sum(1), Hm[:, :, :nc, nc:], Hm[:, :, nc:, nc:])

    def split(self, z):
        L, M, nc, nf = self.cf.shape
        return z[:, :nc], z[:, nc:].reshape(L, M, nf)

    @staticmethod
    def join(zc, zf):
        return torch.cat([zc, zf.flatten(1)], 1)

    def __add__(self, other):
        return Arrow(*(a + b for a, b in zip(self, other)))

    def mv(self, z):
        zc, zf = self.split(z)
        yc = (self.cc @ zc[..., None])[..., 0] + (self.cf @ zf[..., None])[..., 0].sum(1)
        yf = (self.cf.mT @ zc[:, None, :, None])[..., 0] + (self.ff @ zf[..., None])[..., 0]
        return self.join(yc, yf)

    def plus_diag(self, d):
        dc, df = self.split(d)
        return Arrow(self.cc + torch.diag_embed(dc), self.cf, self.ff + torch.diag_embed(df))

    def masked(self, keep):
        """Rows and columns off ``keep`` (L, nv) zeroed."""
        kc, kf = self.split(keep.to(self.cc.dtype))
        return Arrow(self.cc * kc[:, :, None] * kc[:, None, :],
                     self.cf * kc[:, None, :, None] * kf[:, :, None, :],
                     self.ff * kf[..., :, None] * kf[..., None, :])

    def where(self, cond, other):
        """Lane by lane: self where ``cond`` (L,), else other."""
        return Arrow(*(torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)), a, b)
                       for a, b in zip(self, other)))

    def factor(self):
        """Block elimination: each free block's Cholesky factor, then that of
        the shared block's Schur complement. Returns (solve, ok (L,))."""
        Lf, info_f = torch.linalg.cholesky_ex(self.ff)
        Y = torch.linalg.solve_triangular(Lf, self.cf.mT, upper=False)  # (L, M, nf, nc)
        Ls, info_s = torch.linalg.cholesky_ex(self.cc - (Y.mT @ Y).sum(1))
        ok = (info_f == 0).all(1) & (info_s == 0)

        def solve(rhs):
            rc, rf = self.split(rhs)
            tf = torch.linalg.solve_triangular(Lf, rf[..., None], upper=False)
            xc = torch.cholesky_solve((rc - (Y.mT @ tf)[..., 0].sum(1))[..., None], Ls)[..., 0]
            xf = torch.linalg.solve_triangular(Lf.mT, tf - Y @ xc[:, None, :, None], upper=True)
            return self.join(xc, xf[..., 0])

        return solve, ok


def box_qp(H, g, lo, hi, tol, max_iter=100):
    """min 1/2 w'Hw + g'w subject to lo <= w <= hi, for a batch of lanes
    (H an `Arrow`, positive definite; g, lo, hi (L, n), bounds finite), by
    Mehrotra's primal-dual interior-point method with slacks s1 = w - lo,
    s2 = hi - w and multipliers y1, y2, on the normal equations
    (H + Y1/S1 + Y2/S2) dw = -rd + (t1 - s1 y1 - y1 r1)/s1 - (t2 - s2 y2 - y2 r2)/s2.
    Returns (w, ok): ok where the residuals and the duality measure fell
    under ``tol`` (relative to the gradient's size); a lane whose factor
    fails stops where it is."""
    n = g.shape[-1]
    w = 0.5 * (lo + hi)
    s1, s2 = w - lo, hi - w
    y1, y2 = torch.ones_like(g), torch.ones_like(g)
    scale = 1.0 + g.abs().amax(-1)
    ok = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)

    def max_step(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, torch.inf))
        return ratio.amin(-1)

    def steps(dw, r1, r2, t1, t2):
        ds1, ds2 = dw + r1, r2 - dw
        dy1 = (t1 - s1 * y1 - y1 * ds1) / s1
        dy2 = (t2 - s2 * y2 - y2 * ds2) / s2
        a = torch.stack([max_step(s1, ds1), max_step(s2, ds2),
                         max_step(y1, dy1), max_step(y2, dy2)]).amin(0)
        return ds1, ds2, dy1, dy2, a

    for _ in range(max_iter):
        rd = H.mv(w) + g - y1 + y2
        r1, r2 = w - lo - s1, hi - w - s2
        mu = ((s1 * y1).sum(-1) + (s2 * y2).sum(-1)) / (2 * n)
        res = torch.stack([rd.abs().amax(-1), r1.abs().amax(-1), r2.abs().amax(-1), mu])
        ok = (res <= tol * scale).all(0)
        if bool(ok.all()):
            break
        solve, factored = H.plus_diag(y1 / s1 + y2 / s2).factor()

        def direction(t1, t2):
            return solve(-rd + (t1 - s1 * y1 - y1 * r1) / s1 - (t2 - s2 * y2 - y2 * r2) / s2)

        # predictor: the affine-scaling direction
        zero = torch.zeros_like(g)
        dw = direction(zero, zero)
        ds1, ds2, dy1, dy2, a = steps(dw, r1, r2, zero, zero)
        a = a.clamp(max=1.0)[:, None]
        mu_a = (((s1 + a * ds1) * (y1 + a * dy1)).sum(-1)
                + ((s2 + a * ds2) * (y2 + a * dy2)).sum(-1)) / (2 * n)
        sigma = ((mu_a / mu) ** 3)[:, None]
        # corrector: centring and the second-order term of the predictor
        t1, t2 = sigma * mu[:, None] - ds1 * dy1, sigma * mu[:, None] - ds2 * dy2
        dw = direction(t1, t2)
        ds1, ds2, dy1, dy2, a = steps(dw, r1, r2, t1, t2)
        a = (0.99 * a).clamp(max=1.0)
        move = ~ok & factored & torch.isfinite(a)
        for d in (dw, ds1, ds2, dy1, dy2):
            move = move & torch.isfinite(d).all(-1)
        a = torch.where(move, a, torch.zeros_like(a))[:, None]
        upd = lambda v, dv: torch.where(move[:, None], v + a * dv, v)
        w, s1, s2, y1, y2 = upd(w, dw), upd(s1, ds1), upd(s2, ds2), upd(y1, dy1), upd(y2, dy2)
    return polish(H, g, lo, hi, w, s1, s2, y1, y2), ok


def polish(H, g, lo, hi, w, s1, s2, y1, y2):
    """The interior point's active set made exact: the controls whose slack
    is below their multiplier sit on their bound, the rest solve the
    equality-constrained QP; then, for at most ``POLISH_ROUNDS`` rounds, a
    control whose multiplier has the wrong sign leaves the set and a free
    one outside its box joins it (primal-dual active-set steps), until the
    solution is feasible and its multipliers have the right sign. Lanes
    where that is not reached keep the interior point."""
    at_lo, at_hi = s1 < y1, s2 < y2
    eps = 1e-9 * (1.0 + g.abs().amax(-1, keepdim=True))
    for _ in range(POLISH_ROUNDS):
        act = at_lo | at_hi
        w_a = torch.where(at_lo, lo, torch.where(at_hi, hi, torch.zeros_like(w)))
        solve, factored = H.masked(~act).plus_diag(act.to(w.dtype)).factor()
        wp = solve(torch.where(act, w_a, -g - H.mv(w_a)))
        grad = H.mv(wp) + g
        good = (factored & (wp >= lo - eps).all(-1) & (wp <= hi + eps).all(-1)
                & (~at_lo | (grad >= -eps)).all(-1) & (~at_hi | (grad <= eps)).all(-1))
        if bool(good.all()):
            break
        at_lo = (at_lo & (grad >= -eps)) | (~act & (wp < lo - eps))
        at_hi = (at_hi & (grad <= eps)) | (~act & (wp > hi + eps))
    return torch.where(good[:, None], wp.clamp(lo, hi), w.clamp(lo, hi))


def solve(step, x0, X_ref, U_ref, q, r, lo, hi, Nc, tol, max_it, qp_tol, U0=None,
          qp_max_iter=100):
    """Solve a batch of lanes: x0 (L, M, xdim), X_ref (L, M, N, xdim),
    U_ref (L, M, N, udim); scalar weights q, r and box [lo, hi]; the first
    Nc controls shared by the M particles.

    Iterates from ``U0`` (U_ref where None; the shared controls take the
    particles' mean) until a lane's exact Newton step |dz|_inf and its
    scaled natural residual both fall under ``tol``, at most ``max_it``
    times; each QP takes at most ``qp_max_iter``
    interior-point iterations. Returns (U (L, M, N, udim), X (L, M, N+1,
    xdim) with x0 first, converged (L,), iterations (L,))."""
    L, M, N, xdim = X_ref.shape
    udim = U_ref.shape[-1]
    nc, nf, NU = Nc * udim, (N - Nc) * udim, N * udim
    dt, dev = x0.dtype, x0.device

    def to_U(z):
        zc, zf = z[:, :nc], z[:, nc:].reshape(L, M, nf)
        return torch.cat([zc[:, None].expand(L, M, nc), zf], -1).reshape(L, M, N, udim)

    def to_z(U):
        w = U.reshape(L, M, NU)
        return torch.cat([w[..., :nc].mean(1), w[..., nc:].flatten(1)], 1)

    def cost(X, U):
        return 0.5 * (q * ((X - X_ref) ** 2).sum((-3, -2, -1))
                      + r * ((U - U_ref) ** 2).sum((-3, -2, -1)))

    z = to_z(U_ref if U0 is None else U0).clamp(lo, hi)
    zlo, zhi = torch.full_like(z, lo), torch.full_like(z, hi)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    iters = torch.zeros(L, dtype=torch.int64, device=dev)
    exact = torch.ones(L, dtype=torch.bool, device=dev)
    X_out = None
    eye_u = torch.eye(NU, dtype=dt, device=dev)
    for _ in range(max_it):
        U = to_U(z)
        Xb = rollout(step, x0, U)
        X_in = torch.cat([x0[..., None, :], Xb[..., :-1, :]], dim=-2)
        fx, fu = jacobians(step, X_in, U)
        F = condense(fx, fu)  # (L, M, N xdim, N udim)
        c = Xb.reshape(L, M, -1) - (F @ U.reshape(L, M, NU, 1))[..., 0]
        # the Gauss-Newton model 1/2 z'Hz + g'z of the cost, particle by
        # particle over its own controls [shared; free]
        gm = q * (F.mT @ (c - X_ref.reshape(L, M, -1))[..., None])[..., 0] \
            - r * U_ref.reshape(L, M, NU)
        H = Arrow.of_particles(q * (F.mT @ F) + r * eye_u, nc)
        g = torch.cat([gm[..., :nc].sum(1), gm[..., nc:].flatten(1)], 1)
        # the second-order term: adjoints backward from the last stage, each
        # stage's Hessian mapped through the sensitivities G_j of (x_j, u_j)
        # to w
        resid = q * (Xb - X_ref)
        p, P = resid[..., -1, :], [resid[..., -1, :]]
        for j in range(N - 2, -1, -1):
            p = resid[..., j, :] + (fx[..., j + 1, :, :].mT @ p[..., None])[..., 0]
            P.append(p)
        W = second_order(step, X_in, U, torch.stack(P[::-1], -2))
        Fr = F.reshape(L, M, N, xdim, NU)
        Gx = torch.cat([torch.zeros_like(Fr[..., :1, :, :]), Fr[..., :-1, :, :]], -3)
        G = torch.cat([Gx, eye_u.reshape(N, udim, NU).expand(L, M, N, udim, NU)], -2)
        # the cost's gradient, and the box problem's natural residual scaled
        # by the Gauss-Newton diagonal: how far a diagonal Newton step would
        # move each control, which the pins below do not damp
        grad = H.mv(z) + g
        dg = torch.cat([H.cc.diagonal(dim1=-2, dim2=-1),
                        H.ff.diagonal(dim1=-2, dim2=-1).flatten(1)], 1)
        kkt = (z - (z - grad / dg).clamp(lo, hi)).abs().amax(-1)
        # the exact Hessian needs to be positive definite only on the
        # controls off their bounds: a proximal weight, which vanishes at the
        # fixed point, pins those at a bound that the gradient holds there;
        # one that the gradient moves inward stays free
        at_bound = (((z - lo).abs() < 1e-6) & (grad > 0)) | (((hi - z).abs() < 1e-6) & (grad < 0))
        H2 = Arrow.of_particles(torch.einsum("lmjan,lmjab,lmjbk->lmnk", G, W, G), nc) \
            .plus_diag(PIN * at_bound.to(dt))
        He = H + H2
        pd = He.factor()[1] & exact
        # the step's QP, in the step: min 1/2 dz'H dz + grad'dz within the
        # box, so the IPM's tolerance is relative to the gradient alone
        H = He.where(pd, H)
        dz, _ = box_qp(H, grad, zlo - z, zhi - z, qp_tol, qp_max_iter)
        dz = torch.where(torch.isfinite(dz).all(-1, keepdim=True), dz, torch.zeros_like(dz))
        # backtracking on the cost itself, from the full step; a step whose
        # predicted decrease lies under the cost's rounding (a sum of
        # thousands of terms) is taken whole, since the cost cannot judge it
        J0 = cost(Xb, U)
        slope = grad.mul(dz).sum(-1)
        flat = -slope <= FLAT * (1.0 + J0.abs())
        alpha = torch.ones(L, dtype=dt, device=dev)
        for _ in range(30):
            Ut = to_U(z + alpha[:, None] * dz)
            Jt = cost(rollout(step, x0, Ut), Ut)
            bad = ~(Jt <= J0 + 1e-4 * alpha * slope) & (alpha > 1e-6) & ~flat
            if not bool(bad.any()):
                break
            alpha = torch.where(bad, 0.5 * alpha, alpha)
        exact = alpha > 1e-6  # a failed search retries with Gauss-Newton
        z_new = z + alpha[:, None] * dz
        X_new = ((F @ to_U(z_new).reshape(L, M, NU, 1))[..., 0] + c).reshape(L, M, N, xdim)
        act = ~done
        z = torch.where(act[:, None], z_new, z)
        X_out = X_new if X_out is None else torch.where(act[:, None, None, None], X_new, X_out)
        iters = iters + act.to(iters.dtype)
        # a fixed point counts where the step and the residual are both under
        # tol and the exact Hessian was positive definite there: a local
        # minimum, not a saddle at which the Gauss-Newton step vanishes too
        done = done | ((dz.abs().amax(-1) < tol) & (kkt < tol) & pd)
        if bool(done.all()):
            break
    X = torch.cat([x0[..., None, :], X_out], dim=-2)
    return to_U(z), X, done, iters
