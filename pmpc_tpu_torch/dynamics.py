"""Linearized dynamics: rollout, condensation and linearization.

Twin of ``pmpc_tpu/dynamics.py``. Every function takes arbitrary leading batch
dims (``(..., N, xdim)``); the JAX scans are Python loops over N.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


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
