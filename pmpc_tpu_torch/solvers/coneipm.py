"""Second-order-cone primitives: the Jordan algebra of SOC(p) and the
Nesterov-Todd scaling.

Twin of ``pmpc_tpu/solvers/coneipm.py:48-152`` (`_soc_W`, `_soc_prod`,
`_soc_inv`, `_soc_step_len`). The JAX functions take one (p,) cone point and
are mapped with ``jax.vmap``; these take any leading axes, (..., p), and
work on the last one. A cone point u = (u0; u1) lies in the cone when
u0 >= ||u1||; its determinant is det(u) = u0^2 - ||u1||^2 and J =
diag(1, -1, ..., -1).

The dense cone program (``cone_qp_solve``, ``ConeLP``) and the host helpers
of that module are not ported yet (ROADMAP §1.8); the condensed and Riccati
IPMs use the four primitives for their per-stage control cones, and the two
helpers `_soc_shift` and `_soc_viol`, which both JAX cores write inline.
"""

from __future__ import annotations

import torch


def _jdiag(u: torch.Tensor) -> torch.Tensor:
    """The diagonal of J, (p,), in u's dtype and device."""
    J = torch.full((u.shape[-1],), -1.0, dtype=u.dtype, device=u.device)
    J[0] = 1.0
    return J


def _det(u: torch.Tensor) -> torch.Tensor:
    return u[..., 0] ** 2 - (u[..., 1:] ** 2).sum(-1)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def _soc_W(s: torch.Tensor, z: torch.Tensor):
    """NT scaling of cone points s, z (..., p): returns (W, W^-1, W^-2,
    lam = W z), the matrices (..., p, p).

    With w the NT point (its quadratic representation P(w) = 2 w w' -
    det(w) J satisfies P(w) z = s, det(w) = beta^2), the scaling is W =
    P(y), y the Jordan square root of w: the symmetric positive square root
    of P(w), with W z = W^-1 s = lam. The clamps at 1e-30, 1e-12 and 1e-20
    keep a point on the cone's wall finite."""
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
