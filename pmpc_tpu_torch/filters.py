"""Fixed-point iteration filters for the host SCP loop (numpy).

Twin of ``pmpc_tpu/filters.py``, copied so that the port never imports the
JAX package. Each filter maps the recent history of SCP update residuals
``Fs`` (one flat vector per retained iterate) to combination weights over
those iterates, summing to 1: Anderson acceleration (``AA``), uniform
smoothing (``smooth``) and inverse-residual selection (``select``), the
reference's convergence filters (``pmpc/scp_mpc.py:37-62``).
"""

from __future__ import annotations

from typing import List

import numpy as np


def _history_matrix(Fs: List[np.ndarray]) -> np.ndarray:
    """Stack the residual history into columns: (dim, k)."""
    return np.column_stack([np.ravel(f) for f in Fs])


def AA_method(Fs: List[np.ndarray]) -> np.ndarray:
    """Anderson acceleration (Type II).

    Solves the Tikhonov-regularized least-squares problem

        min_theta || r_k + D theta ||^2 + eps ||theta||^2,
        D[:, j] = r_j - r_k   (j < k),

    via an augmented least-squares system (equivalent to the ridge normal
    equations but without forming D'D), then returns the affine combination
    weights [theta; 1 - sum(theta)].
    """
    F = _history_matrix(Fs)
    r_k = F[:, -1]
    D = F[:, :-1] - r_k[:, None]
    k = D.shape[1]
    eps = 1e-10
    A_aug = np.vstack([D, np.sqrt(eps) * np.eye(k)])
    b_aug = np.concatenate([-r_k, np.zeros(k)])
    theta = np.linalg.lstsq(A_aug, b_aug, rcond=None)[0]
    return np.append(theta, 1.0 - theta.sum())


def smooth_method(Fs: List[np.ndarray]) -> np.ndarray:
    """Uniform averaging over the retained window."""
    k = len(Fs)
    return np.full(k, 1.0 / k)


def select_method(Fs: List[np.ndarray]) -> np.ndarray:
    """Inverse-squared-residual weights.

    This is the closed-form solution of

        min_w  sum_i w_i^2 ||F_i||^2   s.t.  sum_i w_i = 1,

    i.e. w_i proportional to 1/||F_i||^2 — nearly all weight lands on the
    smallest-residual iterates. A zero-residual iterate takes all the weight.
    """
    norms2 = np.array([float(np.vdot(f, f)) for f in Fs])
    if np.any(norms2 == 0.0):
        w = (norms2 == 0.0).astype(float)
        return w / w.sum()
    inv = 1.0 / norms2
    return inv / inv.sum()


FILTER_MAP = dict(smooth=smooth_method, select=select_method, AA=AA_method)
