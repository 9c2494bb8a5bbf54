"""Plain reference of the particle consensus MPC problem, batched over lanes,
in plain PyTorch, and independent of the program under test.

The problem of one lane: M particles start from x0[m] and share the first Nc
controls; each follows the user's dynamics x_{j+1} = step(x_j, u_j). Find U
minimizing

    1/2 sum_m sum_j q ||x_{m,j+1} - xr_{m,j}||^2 + r ||u_{m,j} - ur_{m,j}||^2

subject to lo <= u <= hi and, where a configuration states a radius rho,
the control cone ||u_{m,j}||_2 <= rho on every stage. The decision vector of
a lane is z = [u shared (nc = Nc udim); u free of particle 0 (nf = (N - Nc)
udim); ...; of particle M-1], so its Hessian is an arrow: a shared block,
each particle's free block, and their couplings, with no coupling between
particles' free blocks (`Arrow`). A shared stage's control, and so its cone,
appears once in z, as the program lays its cones out: z's stages are the Nc
shared ones, then each particle's N - Nc free ones.

The method is projected Newton with a backtracking line search on that cost:
each iteration rolls the controls out through the dynamics, takes the
Jacobians by reverse-mode autodiff, condenses them into the affine map
X = F w + c of each particle (w = vec(U)), and solves the QP of the
quadratic model over the exact feasible set. Without cones that is the box
QP (`box_qp`): a primal-dual interior-point method, whose Newton systems it
factors by block elimination of the arrow, and whose active set it then
makes exact by primal-dual active-set rounds. With cones it is `cone_qp`:
the same interior point with each stage's cone held as the convex
constraint 1/2 (||u_j||^2 - rho^2) <= 0, whose Newton block (the
multiplier times the identity, plus the multiplier over the slack times
u_j u_j') is one udim x udim block on the arrow's shared or free diagonal,
so the same elimination factors it. The model's Hessian is the exact one of
the cost: the Gauss-Newton term F'qF + rI plus the dynamics' second-order
term (each stage's Hessian of p'f, p the adjoint, mapped through the
sensitivities), so the iterations converge quadratically; a lane where that
is not positive definite, or whose last exact step found no descent, takes
the Gauss-Newton Hessian alone. A control held at a bound, or a stage held
on its cone, by the gradient has its direction (the coordinate, or the
radial one) pinned by a proximal weight that vanishes at the fixed point:
the model needs to be positive definite only off those. Along a sphere the
cone's curvature, its multiplier times the identity, is what makes it so
where the gradient presses hard on the cone, so the model carries a share
of it, with the same share of the stage's control in its gradient: the QP
then minimizes the model of the cost plus lam / 2 ||u||^2 over the box and
the ball themselves, whose own multiplier on the ball takes the rest. Its
fixed points are the KKT points of the problem above, the same points
at which a sequential convex programming solver stops; the stopping test,
the natural residual with each stage's projection onto its feasible set
(box, or box and ball), is zero exactly there. The answer is U with the
states X = F w + c of the last condensed map, as a QP-based solver returns
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PIN = 1e3  # the proximal weight on controls at a bound in a Newton step
POLISH_ROUNDS = 8  # active-set steps after the interior point
FLAT = 1e-12  # a decrease under this share of the cost is below its float64 rounding
# the share of a binding cone's multiplier in the model: any share in [0, 1]
# keeps the fixed points and the quadratic rate; under 1 the QP's own
# multiplier on the ball stays positive, so a fit a little too large does
# not pull the iterate inside the ball (0.9 stalled a lane there, 0.5 none)
LAM_SHARE = 0.5
NEWTON_STEPS = 4  # a cone polish's Newton steps on one active set
STALL = 3  # iterations without progress after which a cone QP's lane stops


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


def block_diag(b):
    """The block-diagonal matrix (..., S d, S d) of blocks b (..., S, d, d)."""
    S, d = b.shape[-3], b.shape[-1]
    e = torch.diag_embed(b.movedim(-3, -1))  # (..., d, d, S, S)
    return e.movedim(-2, -4).movedim(-1, -2).reshape(b.shape[:-3] + (S * d, S * d))


def project(v, lo, hi, rho):
    """The Euclidean projection of each stage's control v (..., udim) onto
    {lo <= u <= hi, ||u|| <= rho}, for a box that holds the origin inside:
    clamp(v t, lo, hi), with t = 1 where that lies in the ball, else the t in
    (0, 1) at which its norm is rho (t = 1 / (1 + the ball's multiplier),
    found by bisection on the norm, which does not fall as t grows)."""
    norm = lambda t: (v * t).clamp(lo, hi).norm(dim=-1, keepdim=True)
    t_in, t_out = torch.zeros_like(v[..., :1]), torch.ones_like(v[..., :1])
    outside = norm(t_out) > rho
    for _ in range(64):  # to below a float64 ulp of t
        t = 0.5 * (t_in + t_out)
        big = norm(t) > rho
        t_in, t_out = torch.where(big, t_in, t), torch.where(big, t, t_out)
    return (v * torch.where(outside, t_in, t_out)).clamp(lo, hi)


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

    def plus_blocks(self, b):
        """Each stage's udim x udim block b (L, S, udim, udim) added on the
        diagonal: the Nc shared stages' to the shared block, each particle's
        free stages' to its free block."""
        L, M, nc, nf = self.cf.shape
        d = b.shape[-1]
        sc = nc // d
        return Arrow(self.cc + block_diag(b[:, :sc]), self.cf,
                     self.ff + block_diag(b[:, sc:].reshape(L, M, nf // d, d, d)))

    def congruent(self, P):
        """P A P for P block-diagonal over the stages, (L, S, udim, udim)
        (`plus_blocks`)."""
        L, M, nc, nf = self.cf.shape
        d = P.shape[-1]
        sc = nc // d
        Pc, Pf = block_diag(P[:, :sc]), block_diag(P[:, sc:].reshape(L, M, nf // d, d, d))
        return Arrow(Pc @ self.cc @ Pc, Pc[:, None] @ self.cf @ Pf, Pf @ self.ff @ Pf)

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


def cone_qp(H, g, lo, hi, u0, rho, tol, max_iter=100):
    """min 1/2 w'Hw + g'w subject to lo <= w <= hi and ||u0_j + w_j|| <= rho
    on every stage j, for a batch of lanes (H an `Arrow`, positive definite;
    g, lo, hi (L, n), bounds finite; u0 (L, S, udim), w's stages in the
    order of `Arrow.plus_blocks`). Mehrotra's primal-dual interior point of
    `box_qp`, with each stage's cone as the convex constraint
    c_j = 1/2 (||u_j||^2 - rho^2) <= 0 (u = u0 + w), its slack t_j
    (c_j + t_j = 0) and multiplier lam_j: the Lagrangian's gradient gains
    lam_j u_j, and the normal equations gain on stage j's diagonal block
    lam_j I + (lam_j / t_j) u_j u_j' and on their right-hand side
    -u_j (tc_j - t_j lam_j + lam_j rc_j) / t_j, rc_j = c_j + t_j. Returns
    (w, ok): ok where the residuals and the duality measure fell under
    ``tol`` (relative to the gradient's size); a lane whose factor fails
    stops where it is, and so does one whose dual residual alone is left
    and has not halved in ``STALL`` iterations: a cone's multiplier over its
    slack, ~1 / mu, leaves its Newton direction that much rounding."""
    L, n = g.shape
    S, d = u0.shape[-2:]
    w = 0.5 * (lo + hi)
    s1, s2 = w - lo, hi - w
    y1, y2 = torch.ones_like(g), torch.ones_like(g)
    t = torch.full((L, S), 0.5 * rho ** 2, dtype=g.dtype, device=g.device)
    lam = torch.ones_like(t)
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    scale = 1.0 + g.abs().amax(-1)
    ok = torch.zeros(L, dtype=torch.bool, device=g.device)
    best_rd = torch.full_like(scale, torch.inf)
    stalled = torch.zeros(L, dtype=torch.int64, device=g.device)
    pairs = 2 * n + S

    def max_step(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, torch.inf))
        return ratio.amin(-1)

    for _ in range(max_iter):
        u = u0 + w.view(L, S, d)
        rd = H.mv(w) + g - y1 + y2 + (lam[..., None] * u).flatten(1)
        r1, r2 = w - lo - s1, hi - w - s2
        rc = 0.5 * ((u * u).sum(-1) - rho ** 2) + t
        mu = ((s1 * y1).sum(-1) + (s2 * y2).sum(-1) + (t * lam).sum(-1)) / pairs
        res = torch.stack([rd.abs().amax(-1), r1.abs().amax(-1), r2.abs().amax(-1),
                           rc.abs().amax(-1), mu])
        under = res <= tol * scale
        ok = under.all(0)
        halved = res[0] < 0.5 * best_rd
        best_rd = torch.where(halved, res[0], best_rd)
        stalled = torch.where(under[1:].all(0) & ~halved, stalled + 1, torch.zeros_like(stalled))
        stop = ok | (stalled >= STALL)
        if bool(stop.all()):
            break
        blocks = lam[..., None, None] * eye + (lam / t)[..., None, None] * (u[..., :, None]
                                                                           * u[..., None, :])
        solve, factored = H.plus_diag(y1 / s1 + y2 / s2).plus_blocks(blocks).factor()

        def direction(t1, t2, tc):
            return solve(-rd + (t1 - s1 * y1 - y1 * r1) / s1 - (t2 - s2 * y2 - y2 * r2) / s2
                         - (u * ((tc - t * lam + lam * rc) / t)[..., None]).flatten(1))

        def steps(dw, t1, t2, tc):
            ds1, ds2 = dw + r1, r2 - dw
            dy1 = (t1 - s1 * y1 - y1 * ds1) / s1
            dy2 = (t2 - s2 * y2 - y2 * ds2) / s2
            dt = -rc - (u * dw.view(L, S, d)).sum(-1)
            dlam = (tc - t * lam - lam * dt) / t
            a = torch.stack([max_step(s1, ds1), max_step(s2, ds2), max_step(y1, dy1),
                             max_step(y2, dy2), max_step(t, dt), max_step(lam, dlam)]).amin(0)
            return ds1, ds2, dy1, dy2, dt, dlam, a

        # predictor: the affine-scaling direction
        zero, zc = torch.zeros_like(g), torch.zeros_like(t)
        dw = direction(zero, zero, zc)
        ds1, ds2, dy1, dy2, dt, dlam, a = steps(dw, zero, zero, zc)
        a = a.clamp(max=1.0)[:, None]
        mu_a = (((s1 + a * ds1) * (y1 + a * dy1)).sum(-1)
                + ((s2 + a * ds2) * (y2 + a * dy2)).sum(-1)
                + ((t + a * dt) * (lam + a * dlam)).sum(-1)) / pairs
        sigma = ((mu_a / mu) ** 3)[:, None]
        # corrector: centring and the second-order term of the predictor
        t1, t2 = sigma * mu[:, None] - ds1 * dy1, sigma * mu[:, None] - ds2 * dy2
        tc = sigma * mu[:, None] - dt * dlam
        dw = direction(t1, t2, tc)
        ds1, ds2, dy1, dy2, dt, dlam, a = steps(dw, t1, t2, tc)
        a = (0.99 * a).clamp(max=1.0)
        move = ~stop & factored & torch.isfinite(a)
        for dv in (dw, ds1, ds2, dy1, dy2, dt, dlam):
            move = move & torch.isfinite(dv).all(-1)
        a = torch.where(move, a, torch.zeros_like(a))[:, None]
        upd = lambda v, dv: torch.where(move[:, None], v + a * dv, v)
        w, s1, s2, y1, y2 = upd(w, dw), upd(s1, ds1), upd(s2, ds2), upd(y1, dy1), upd(y2, dy2)
        t, lam = upd(t, dt), upd(lam, dlam)
    return cone_polish(H, g, lo, hi, u0, rho, w, s1 < y1, s2 < y2, t < lam), ok


def cone_polish(H, g, lo, hi, u0, rho, w, at_lo, at_hi, on):
    """`polish` for `cone_qp`: the interior point's active set made exact.
    The controls whose slack is below their multiplier sit on their bound,
    the stages whose cone slack is below its multiplier on their sphere
    (``on``), and the rest solve the QP with those as equalities, by Newton
    steps in the null space of the active constraints, each followed by a
    retraction onto the spheres along the stage's coordinates off the box;
    then, for at most ``POLISH_ROUNDS`` rounds, a bound or cone whose
    multiplier has the wrong sign leaves the set and one that the solution
    violates joins it, until the solution is feasible and its multipliers
    have the right sign. Lanes where that is not reached keep the interior
    point."""
    L, n = g.shape
    S, d = u0.shape[-2:]
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    eps = 1e-9 * (1.0 + g.abs().amax(-1, keepdim=True))
    tiny = torch.finfo(g.dtype).tiny
    stages = lambda v: v.view(L, S, d)
    wp = w
    for _ in range(POLISH_ROUNDS):
        act = at_lo | at_hi
        free = stages(~act).to(g.dtype)
        wp = torch.where(at_lo, lo, torch.where(at_hi, hi, wp))
        for k in range(NEWTON_STEPS + 1):
            u = u0 + stages(wp)
            fixed2 = (u * u * (1 - free)).sum(-1, keepdim=True)
            free2 = (u * u * free).sum(-1, keepdim=True)
            scale = ((rho ** 2 - fixed2).clamp(min=0) / free2.clamp(min=tiny)).sqrt()
            u = torch.where(on[..., None], u * (1 - free) + u * free * scale, u)
            wp = (u - u0).flatten(1)
            r = stages(H.mv(wp) + g)
            uf = u * free
            uf2 = (uf * uf).sum(-1, keepdim=True)
            held = on[..., None] & (uf2 > 0)
            nu = torch.where(held, -(r * uf).sum(-1, keepdim=True) / uf2.clamp(min=tiny),
                             torch.zeros_like(uf2))
            grad = r + nu * u  # the Lagrangian's gradient
            if k == NEWTON_STEPS:
                break
            nh = uf / uf2.clamp(min=tiny).sqrt()
            P = torch.diag_embed(free) - held[..., None].to(g.dtype) * (nh[..., :, None]
                                                                        * nh[..., None, :])
            K = H.plus_blocks(nu[..., None] * eye).congruent(P).plus_blocks(eye - P)
            solve, factored = K.factor()
            wp = wp + solve(-(P @ grad[..., None])[..., 0].flatten(1))
        gf = grad.flatten(1)
        norm = u.norm(dim=-1)
        good = (factored & (wp >= lo - eps).all(-1) & (wp <= hi + eps).all(-1)
                & (norm <= rho + eps).all(-1) & (~on | (nu[..., 0] >= -eps)).all(-1)
                & (~at_lo | (gf >= -eps)).all(-1) & (~at_hi | (gf <= eps)).all(-1))
        if bool(good.all()):
            break
        at_lo = (at_lo & (gf >= -eps)) | (~act & (wp < lo - eps))
        at_hi = (at_hi & (gf <= eps)) | (~act & (wp > hi + eps))
        on = (on & (nu[..., 0] >= -eps)) | (~on & (norm > rho + eps))
    return torch.where(good[:, None], wp.clamp(lo, hi), w)


def solve(step, x0, X_ref, U_ref, q, r, lo, hi, Nc, tol, max_it, qp_tol, U0=None,
          qp_max_iter=100, soc_r=None):
    """Solve a batch of lanes: x0 (L, M, xdim), X_ref (L, M, N, xdim),
    U_ref (L, M, N, udim); scalar weights q, r and box [lo, hi]; the first
    Nc controls shared by the M particles; with ``soc_r`` the cone
    ||u_{m,j}|| <= soc_r on every stage too (lo < 0 < hi then).

    Iterates from ``U0`` (U_ref where None; the shared controls take the
    particles' mean; projected onto the feasible set) until a lane's exact
    Newton step |dz|_inf and its scaled natural residual both fall under
    ``tol``, at most ``max_it`` times; each QP takes at most ``qp_max_iter``
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

    cone = soc_r is not None
    if cone and not lo < 0 < hi:
        raise ValueError(f"the cones need a box that holds the origin inside, got [{lo}, {hi}]")
    S = Nc + M * (N - Nc)  # z's stages: the shared ones, then each particle's free ones
    stages = lambda v: v.reshape(L, S, udim)
    z = to_z(U_ref if U0 is None else U0)
    z = project(stages(z), lo, hi, soc_r).flatten(1) if cone else z.clamp(lo, hi)
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
        if cone:  # one scale a stage, so that its step is a Euclidean projection
            zs = stages(z)
            zs_step = zs - stages(grad) / stages(dg).amax(-1, keepdim=True)
            kkt = (zs - project(zs_step, lo, hi, soc_r)).abs().amax((-2, -1))
        else:
            kkt = (z - (z - grad / dg).clamp(lo, hi)).abs().amax(-1)
        # the exact Hessian needs to be positive definite only on the
        # controls off their bounds: a proximal weight, which vanishes at the
        # fixed point, pins those at a bound that the gradient holds there;
        # one that the gradient moves inward stays free
        at_bound = (((z - lo).abs() < 1e-6) & (grad > 0)) | (((hi - z).abs() < 1e-6) & (grad < 0))
        H2 = Arrow.of_particles(torch.einsum("lmjan,lmjab,lmjbk->lmnk", G, W, G), nc) \
            .plus_diag(PIN * at_bound.to(dt))
        if cone:
            # a stage held on its cone by the gradient: its radial direction
            # pinned, and a share of the cone's curvature, its multiplier
            # times the identity, in the model, the multiplier fitted on the
            # coordinates off the box (exact at a KKT point)
            zs, gs = stages(z), stages(grad)
            nrm = zs.norm(dim=-1, keepdim=True)
            off = ((zs - lo).abs() >= 1e-6) & ((hi - zs).abs() >= 1e-6)
            lam = (-(gs * zs * off).sum(-1, keepdim=True)
                   / (zs * zs * off).sum(-1, keepdim=True).clamp(min=1e-12)).clamp(min=0)
            lam = torch.where((soc_r - nrm).abs() < 1e-6, LAM_SHARE * lam, torch.zeros_like(lam))
            n = zs / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
            nn = n[..., :, None] * n[..., None, :]
            H2 = H2.plus_blocks(PIN * (lam > 0).to(dt)[..., None] * nn
                                + lam[..., None] * torch.eye(udim, dtype=dt, device=dev))
        He = H + H2
        pd = He.factor()[1] & exact
        # the step's QP, in the step: min 1/2 dz'H dz + grad'dz within the
        # box (and each stage's ball, centred at -z), so the IPM's tolerance
        # is relative to the gradient alone
        H = He.where(pd, H)
        if cone:
            g_qp = grad + torch.where(pd[:, None], (lam * zs).flatten(1), torch.zeros_like(grad))
            dz, _ = cone_qp(H, g_qp, zlo - z, zhi - z, zs, soc_r, qp_tol, qp_max_iter)
        else:
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
