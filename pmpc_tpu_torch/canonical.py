"""Canonical consensus QP matrices export (numpy).

Twin of ``pmpc_tpu/canonical.py``, copied so that the port never imports the
JAX package; parity with ``lqp_generate_problem_matrices``
(``PMPC.jl/src/main.jl:374-409`` / ``pmpc/scp_mpc.py:66-75``): builds the
dense canonical-form data

    min 0.5 z'Pz + q'z   s.t.  A z = b,   l <= G z <= u

over the consensus variable layout
``z = [u_cons (Nc*udim); u_free_1..M; x_1..M]``. Dense numpy output: the
reference returns sparse CSC with the same contents and row/column order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .utils import atleast_nd


def layout(N: int, xdim: int, udim: int, M: int, Nc: int):
    """Index helpers for the canonical consensus layout."""
    nc = Nc * udim
    nf = (N - Nc) * udim
    nu_total = nc + M * nf
    n = nu_total + M * N * xdim

    def u_idx(i: int, j: int) -> slice:
        if j < Nc:
            return slice(j * udim, (j + 1) * udim)
        s = nc + i * nf + (j - Nc) * udim
        return slice(s, s + udim)

    def x_idx(i: int, j: int) -> slice:
        s = nu_total + i * N * xdim + j * xdim
        return slice(s, s + xdim)

    return n, u_idx, x_idx


def build_Pq(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
    reg_x=0.0, reg_u=0.0, slew_reg=0.0, slew_reg0=0.0, slew_um1=None, Nc=-1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cost Hessian and linear term (parity with ``lqp_repr_Pq``)."""
    M, N, xdim = np.asarray(f).shape
    udim = np.asarray(fu).shape[-1]
    Nc = Nc if Nc >= 0 else N
    Q, R = np.asarray(Q, dtype=float), np.asarray(R, dtype=float)
    X_prev, U_prev = np.asarray(X_prev, dtype=float), np.asarray(U_prev, dtype=float)
    X_ref, U_ref = np.asarray(X_ref, dtype=float), np.asarray(U_ref, dtype=float)
    reg_x = np.broadcast_to(np.asarray(reg_x, dtype=float), (M,))
    reg_u = np.broadcast_to(np.asarray(reg_u, dtype=float), (M,))
    slew_reg = np.broadcast_to(np.asarray(slew_reg, dtype=float), (M,))
    slew_reg0 = np.broadcast_to(np.asarray(slew_reg0, dtype=float), (M,))
    slew_um1 = (np.zeros((M, udim)) if slew_um1 is None
                else np.broadcast_to(np.asarray(slew_um1, dtype=float), (M, udim)))

    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    P = np.zeros((n, n))
    q = np.zeros(n)
    Iu, Ix = np.eye(udim), np.eye(xdim)
    for i in range(M):
        for j in range(N):
            ui, xi = u_idx(i, j), x_idx(i, j)
            P[ui, ui] += R[i, j] + reg_u[i] * Iu
            q[ui] += -(R[i, j] @ U_ref[i, j] + reg_u[i] * U_prev[i, j])
            P[xi, xi] += Q[i, j] + reg_x[i] * Ix
            q[xi] += -(Q[i, j] @ X_ref[i, j] + reg_x[i] * X_prev[i, j])
        for j in range(N - 1):
            a, b_ = u_idx(i, j), u_idx(i, j + 1)
            P[a, a] += slew_reg[i] * Iu
            P[b_, b_] += slew_reg[i] * Iu
            P[a, b_] += -slew_reg[i] * Iu
            P[b_, a] += -slew_reg[i] * Iu
        u0 = u_idx(i, 0)
        P[u0, u0] += slew_reg0[i] * Iu
        q[u0] += -slew_reg0[i] * slew_um1[i]
    return P, q


def build_Ab(x0, f, fx, fu, X_prev, U_prev, Nc=-1) -> Tuple[np.ndarray, np.ndarray]:
    """Dynamics equality constraints (parity with ``lqp_repr_Ab``)."""
    x0 = np.asarray(x0, dtype=float)
    f, fx, fu = np.asarray(f, dtype=float), np.asarray(fx, dtype=float), np.asarray(fu, dtype=float)
    X_prev, U_prev = np.asarray(X_prev, dtype=float), np.asarray(U_prev, dtype=float)
    M, N, xdim = f.shape
    udim = fu.shape[-1]
    Nc = Nc if Nc >= 0 else N
    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    A = np.zeros((M * N * xdim, n))
    b = np.zeros(M * N * xdim)
    for i in range(M):
        for j in range(N):
            r = slice((i * N + j) * xdim, (i * N + j + 1) * xdim)
            A[r, u_idx(i, j)] = fu[i, j]
            A[r, x_idx(i, j)] = -np.eye(xdim)
            rhs = -f[i, j] + fu[i, j] @ U_prev[i, j]
            if j > 0:
                A[r, x_idx(i, j - 1)] = fx[i, j]
                rhs += fx[i, j] @ X_prev[i, j - 1]
            b[r] = rhs
    return A, b


def build_Glu(
    x0, f, fx, fu, x_l=None, x_u=None, u_l=None, u_u=None, Nc=-1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Box-bound selector rows (parity with ``lqp_repr_Gla``): l <= G z <= u.
    Consensus control rows use particle 0's bounds."""
    f, fu = np.asarray(f, dtype=float), np.asarray(fu, dtype=float)
    M, N, xdim = f.shape
    udim = fu.shape[-1]
    Nc = Nc if Nc >= 0 else N
    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    rows, lo, hi = [], [], []
    if u_l is not None and u_u is not None:
        u_l = np.asarray(u_l, dtype=float).reshape(M, N, udim)
        u_u = np.asarray(u_u, dtype=float).reshape(M, N, udim)
        for j in range(Nc):
            for r in range(udim):
                row = np.zeros(n)
                row[u_idx(0, j).start + r] = 1.0
                rows.append(row)
                lo.append(u_l[0, j, r]); hi.append(u_u[0, j, r])
        for i in range(M):
            for j in range(Nc, N):
                for r in range(udim):
                    row = np.zeros(n)
                    row[u_idx(i, j).start + r] = 1.0
                    rows.append(row)
                    lo.append(u_l[i, j, r]); hi.append(u_u[i, j, r])
    if x_l is not None and x_u is not None:
        x_l = np.asarray(x_l, dtype=float).reshape(M, N, xdim)
        x_u = np.asarray(x_u, dtype=float).reshape(M, N, xdim)
        for i in range(M):
            for j in range(N):
                for r in range(xdim):
                    row = np.zeros(n)
                    row[x_idx(i, j).start + r] = 1.0
                    rows.append(row)
                    lo.append(x_l[i, j, r]); hi.append(x_u[i, j, r])
    G = np.stack(rows) if rows else np.zeros((0, n))
    return G, np.asarray(lo), np.asarray(hi)


def lqp_generate_problem_matrices(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, **settings
):
    """Reference-compatible matrix export: returns (P, q, A, b, G, l, u)."""
    x0 = atleast_nd(np.asarray(x0), 2)
    f = atleast_nd(np.asarray(f), 3)
    fx, fu = atleast_nd(np.asarray(fx), 4), atleast_nd(np.asarray(fu), 4)
    X_prev, U_prev = atleast_nd(np.asarray(X_prev), 3), atleast_nd(np.asarray(U_prev), 3)
    Q, R = atleast_nd(np.asarray(Q), 4), atleast_nd(np.asarray(R), 4)
    X_ref, U_ref = atleast_nd(np.asarray(X_ref), 3), atleast_nd(np.asarray(U_ref), 3)
    Nc = int(settings.get("Nc", -1))
    weights = settings.get("weights", None)
    M = f.shape[0]
    reg_x = np.broadcast_to(np.asarray(settings.get("reg_x", 0.0), float), (M,))
    reg_u = np.broadcast_to(np.asarray(settings.get("reg_u", 0.0), float), (M,))
    slew_reg = np.broadcast_to(
        np.asarray(settings.get("slew_reg", 0.0), float), (M,))
    slew_reg0 = np.broadcast_to(
        np.asarray(settings.get("slew_reg0", 0.0), float), (M,))
    slew_um1 = settings.get("slew_um1", None)
    if weights is not None:
        # weights scale ALL per-particle cost terms — including reg and slew
        # (and, like the reference, the slew anchor) — exactly as the solver
        # does (reduced.assemble_condensed / main.jl:96-112); exporting only
        # weighted Q/R would describe a different QP than the one solved
        w = np.asarray(weights, dtype=float)
        w = w / w.sum()
        Q = Q * w[:, None, None, None]
        R = R * w[:, None, None, None]
        reg_x, reg_u = reg_x * w, reg_u * w
        slew_reg, slew_reg0 = slew_reg * w, slew_reg0 * w
        if slew_um1 is not None and bool(
                settings.get("weights_scale_slew_target", True)):
            slew_um1 = np.asarray(slew_um1, float) * w[:, None]
    P, q = build_Pq(
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
        reg_x=reg_x, reg_u=reg_u,
        slew_reg=slew_reg,
        slew_reg0=slew_reg0,
        slew_um1=slew_um1, Nc=Nc,
    )
    A, b = build_Ab(x0, f, fx, fu, X_prev, U_prev, Nc=Nc)
    G, lo, hi = build_Glu(
        x0, f, fx, fu,
        x_l=settings.get("lx", None), x_u=settings.get("ux", None),
        u_l=settings.get("lu", None), u_u=settings.get("uu", None), Nc=Nc,
    )
    return P, q, A, b, G, lo, hi
