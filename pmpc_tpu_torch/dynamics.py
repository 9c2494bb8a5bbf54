"""Linearized dynamics: rollout, condensation and linearization.

Twin of ``pmpc_tpu/dynamics.py``. Every function takes arbitrary leading batch
dims (``(..., N, xdim)``); the JAX scans are Python loops over N.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .utils import default_device, to_host


def _xlin(x0, X_prev):
    return torch.cat([x0[..., None, :], X_prev[..., :-1, :]], dim=-2)


def rollout(x0, f, fx, fu, X_prev, U_prev, U):
    """Roll out the affine (linearized) dynamics for controls ``U``.

    ``x_j = f_j + fx_j (x_{j-1} - xlin_j) + fu_j (u_j - U_prev_j)`` with
    ``xlin = [x0, X_prev[:-1]]``. Returns X (..., N, xdim), the states after
    each step."""
    xlin = _xlin(x0, X_prev)
    du = U - U_prev
    x, xs = x0, []
    for j in range(f.shape[-2]):
        x = f[..., j, :] + (fx[..., j, :, :] @ (x - xlin[..., j, :])[..., None])[..., 0] \
            + (fu[..., j, :, :] @ du[..., j, :][..., None])[..., 0]
        xs.append(x)
    return torch.stack(xs, dim=-2)


def rollout_feedback(x0, f, fx, fu, X_prev, U_prev, L, l):
    """Roll out affine state feedback ``u_j = l_j + L_j x_{j-1}`` (x_{-1} =
    x0), L (..., N, udim, xdim), l (..., N, udim). Returns (X, U)."""
    xlin = _xlin(x0, X_prev)
    x, xs, us = x0, [], []
    for j in range(f.shape[-2]):
        u = l[..., j, :] + (L[..., j, :, :] @ x[..., None])[..., 0]
        x = f[..., j, :] + (fx[..., j, :, :] @ (x - xlin[..., j, :])[..., None])[..., 0] \
            + (fu[..., j, :, :] @ (u - U_prev[..., j, :])[..., None])[..., 0]
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def rollout_residual(x0, f, fx, fu, X_prev, U_prev, X, U):
    """``x_j - (f_j + fx_j (x_{j-1} - xlin_{j-1}) + fu_j (u_j - U_prev_j))``
    for all j: how far (X, U) is from satisfying the linearized dynamics."""
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    return X - (f + mv(fx, _xlin(x0, X) - _xlin(x0, X_prev)) + mv(fu, U - U_prev))


def dynamics_violation(x0, f, fx, fu, X_prev, U_prev, X, U):
    """Per-step linearized dynamics violation norms. Returns (total (...,),
    per-step (..., N))."""
    viols = torch.linalg.vector_norm(
        rollout_residual(x0, f, fx, fu, X_prev, U_prev, X, U), dim=-1)
    return viols.sum(-1), viols


def shorten_horizon(N_new: int, *arrays, N: int = None):
    """Slice problem arrays to a shorter horizon: each keeps its first
    ``N_new`` entries along the horizon axis, axis -2 for (..., N, d)
    arrays, axis -3 for (..., N, d, d) matrix stacks. Pass the current
    horizon ``N`` to disambiguate when a square trailing block could be
    mistaken for a matrix stack (a (M, N, xdim) vector array with
    N == xdim). None passes through."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        matrix = a.ndim >= 3 and a.shape[-1] == a.shape[-2]
        if N is not None:
            matrix = matrix and a.shape[-3] == N
            if not matrix and a.shape[-2] != N:
                raise ValueError(f"array of shape {tuple(a.shape)} has horizon {N} "
                                 "on neither axis -2 nor -3")
        out.append(a[..., :N_new, :, :] if matrix else a[..., :N_new, :])
    return out


def condense(x0, f, fx, fu, X_prev, U_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense condensed dynamics map ``vec(X) = Ft @ vec(U - U_prev) + ft``.

    ``Ft`` is block lower-triangular with blocks
    ``Ft[j, l] = fx_j fx_{j-1} ... fx_{l+1} fu_l`` for ``l <= j``; ``ft`` is the
    rollout at ``U = U_prev``. An O(N) loop whose carry is the full
    ``(xdim, N*udim)`` sensitivity row: row_j = fx_j row_{j-1} + e_j (x) fu_j.

    Returns Ft (..., N*xdim, N*udim) and ft (..., N*xdim)."""
    N, xdim = f.shape[-2:]
    udim = fu.shape[-1]
    batch = f.shape[:-2]
    xlin = _xlin(x0, X_prev)
    row = torch.zeros(batch + (xdim, N * udim), dtype=f.dtype, device=f.device)
    x, rows, xs = x0, [], []
    for j in range(N):
        row = fx[..., j, :, :] @ row  # fresh tensor: safe to write into
        row[..., j * udim:(j + 1) * udim] += fu[..., j, :, :]
        x = f[..., j, :] + (fx[..., j, :, :] @ (x - xlin[..., j, :])[..., None])[..., 0]
        rows.append(row)
        xs.append(x)
    Ft = torch.stack(rows, dim=-3).reshape(batch + (N * xdim, N * udim))
    return Ft, torch.stack(xs, dim=-2).reshape(batch + (N * xdim,))


def linearize(dynamics: Callable, X: torch.Tensor, U: torch.Tensor,
              params=None):
    """``(f, fx, fu)`` of a single-step dynamics ``f(x, u)`` at every point.

    One forward-mode Jacobian over ``z = [x; u]``: a ``jvp`` of the dynamics
    mapped over the flattened leading dims, mapped in turn over the
    xdim + udim basis tangents. (``vmap(jacfwd(...))`` would be the direct
    twin, but forward mode on the per-sample 0-dim tensors promotes the
    tangents of ``python float * tensor`` to float64.)

    Args:
        dynamics: (x (xdim,), u (udim,)) -> (xdim,) next state; with
            ``params``, (x, u, p (P,)) -> (xdim,).
        X: (..., N, xdim) states entering each step.
        U: (..., N, udim) controls.
        params: optional (..., P) per-particle dynamics parameters (one row
            for the N steps of a particle): mapped with the points, not
            differentiated.

    Returns:
        f (..., N, xdim), fx (..., N, xdim, xdim), fu (..., N, xdim, udim)
    """
    xdim, udim = X.shape[-1], U.shape[-1]
    k = xdim + udim
    lead = X.shape[:-1]
    z = torch.cat([X, U], dim=-1).reshape(-1, k)
    if params is None:
        fn = torch.func.vmap(lambda zi: dynamics(zi[:xdim], zi[xdim:]))
    else:
        N = X.shape[-2]
        p = params[..., None, :].expand(params.shape[:-1] + (N, params.shape[-1])) \
            .reshape(z.shape[0], -1)
        fn_p = torch.func.vmap(lambda zi, pi: dynamics(zi[:xdim], zi[xdim:], pi))
        fn = lambda z_: fn_p(z_, p)
    basis = torch.eye(k, dtype=z.dtype, device=z.device)[:, None, :] \
        .expand(k, z.shape[0], k)
    y, Jt = torch.func.vmap(lambda t: torch.func.jvp(fn, (z,), (t,)),
                            out_dims=(None, 0))(basis)
    J = Jt.permute(1, 2, 0)  # (P, xdim, k)
    return (y.reshape(lead + (xdim,)),
            J[..., :xdim].reshape(lead + (xdim, xdim)),
            J[..., xdim:].reshape(lead + (xdim, udim)))


def make_f_fx_fu_fn(dynamics: Callable, device=None) -> Callable:
    """Wrap a torch single-step dynamics ``f(x (xdim,), u (udim,)) -> (xdim,)``
    into the reference-style callback ``f_fx_fu_fn(X, U) -> (f, fx, fu)`` of
    the host SCP loop: numpy in, numpy out.

    The points go to ``device`` (the card when None; `default_device` raises
    without one) in their own dtype, `linearize` runs there, and the three
    results come back to the host in ONE transfer. The wrapped step is kept
    as ``__wrapped_dynamics__``."""
    dev = default_device() if device is None else torch.device(device)

    def f_fx_fu_fn(X, U):
        Xt = torch.as_tensor(np.asarray(X), device=dev)
        Ut = torch.as_tensor(np.asarray(U), dtype=Xt.dtype, device=dev)
        return tuple(to_host(linearize(dynamics, Xt, Ut)))

    f_fx_fu_fn.__wrapped_dynamics__ = dynamics
    return f_fx_fu_fn
