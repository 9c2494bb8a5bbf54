"""k-worst-particle (CVaR) consensus objective: the host-side piece.

Twin of ``pmpc_tpu/solvers/cvar.py``. The epigraph program

    min (1+eps) sum_i y_i + (1-eps) k t
    s.t. y_i >= 0,  J_i(z) <= y_i + t,   (eps = COST_ANCHOR_EPS = 1e-3)

is assembled and solved by `solvers.compose` (`CvarParts`,
`build_cone_program`); this module keeps the per-particle cost constants,
which decide WHICH particles are worst, so J_i must include its constant
term, evaluated at U = 0.
"""

from __future__ import annotations

import numpy as np

from .compose import COST_ANCHOR_EPS  # noqa: F401  (re-export, main.jl:221)


def particle_constants(g, X_prev, U_prev, Q, R, X_ref, U_ref,
                       reg_x, reg_u, slew_reg0, slew_um1) -> np.ndarray:
    """c_i = J_i at U = 0 (so that J_i(z) = 0.5 z'H_i z + q_i'z + c_i
    exactly), numpy.

    g: (M, NX) condensed state offset (x at U = 0); the rest are the raw
    (M, N, ...) problem arrays."""
    M, N, xdim = np.shape(X_prev)
    g = np.asarray(g).reshape(M, N, xdim)
    dX = g - np.asarray(X_ref)
    c = 0.5 * np.einsum("mni,mnij,mnj->m", dX, np.asarray(Q), dX)
    c += 0.5 * np.asarray(reg_x) * np.sum((g - np.asarray(X_prev)) ** 2, axis=(1, 2))
    Ur = np.asarray(U_ref)
    c += 0.5 * np.einsum("mni,mnij,mnj->m", Ur, np.asarray(R), Ur)
    c += 0.5 * np.asarray(reg_u) * np.sum(np.asarray(U_prev) ** 2, axis=(1, 2))
    c += 0.5 * np.asarray(slew_reg0) * np.sum(np.asarray(slew_um1) ** 2, axis=-1)
    return c
