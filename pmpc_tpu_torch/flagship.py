"""The headline program and the accuracy-probe configuration, in torch.

Twins of ``__graft_entry__._flagship``/``_dubins``, ``bench._stack_varied``
and ``benchmarks/accuracy_probe.build``: the same numpy seeds, so both
packages build the same instances.
"""

from __future__ import annotations

import numpy as np
import torch

from .torch_scp import SCPData, build_scp_solver, make_scp_data

# the headline build (bench.py): a solve counts when the SCP residual <= 1e-3
HEADLINE_KW = dict(max_it=25, res_tol=1e-3, accel="AA", ipm_iters=8)


def dubins(x, u, p=(1.0, 1.0, 0.3)):
    """Closed-form unicycle step, x=(px,py,v,th), u=(accel, turn),
    p=(v_scale, w_scale, T). Stable at small turn rates: the exact integrals
    switch to a Taylor series at |h| < 0.1 (no 1/w^2 cancellation, so the
    Jacobians stay accurate in f32)."""
    v_scale, w_scale, T = p
    a = v_scale * u[..., 0]
    w = w_scale * -u[..., 1]
    px, py, v, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    h = T * w  # total turn over the step
    small = h.abs() < 0.1
    hs = torch.where(small, torch.ones_like(h), h)  # safe denominator
    h2 = h * h
    h3 = h2 * h
    sin_th, cos_th = torch.sin(th), torch.cos(th)
    sin_thh, cos_thh = torch.sin(th + h), torch.cos(th + h)
    C1 = torch.where(small,
                     cos_th - 0.5 * h * sin_th - (h2 / 6.0) * cos_th + (h3 / 24.0) * sin_th,
                     (sin_thh - sin_th) / hs)
    S1 = torch.where(small,
                     sin_th + 0.5 * h * cos_th - (h2 / 6.0) * sin_th - (h3 / 24.0) * cos_th,
                     -(cos_thh - cos_th) / hs)
    C2 = torch.where(small,
                     0.5 * cos_th - (h / 3.0) * sin_th - (h2 / 8.0) * cos_th + (h3 / 30.0) * sin_th,
                     (h * sin_thh + cos_thh - cos_th) / (hs * hs))
    S2 = torch.where(small,
                     0.5 * sin_th + (h / 3.0) * cos_th - (h2 / 8.0) * sin_th - (h3 / 30.0) * cos_th,
                     (-h * cos_thh + sin_thh - sin_th) / (hs * hs))
    px_new = px + T * v * C1 + T * T * a * C2
    py_new = py + T * v * S1 + T * T * a * S2
    return torch.stack([px_new, py_new, v + T * a, th + h], dim=-1)


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _instance(M, N, xdim, udim, dtype, device) -> SCPData:
    """The flagship/probe instance (one (M, ...) problem), from seed 0."""
    nd = _np_dtype(dtype)
    rng = np.random.default_rng(0)
    x0 = (np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))).astype(nd)
    Q = np.tile(np.eye(xdim, dtype=nd), (M, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(nd), (M, N, 1, 1))
    return make_scp_data(x0, Q, R, reg_x=1.0, reg_u=0.1,
                         u_l=-np.ones((M, N, udim), nd),
                         u_u=np.ones((M, N, udim), nd),
                         dtype=dtype, device=device)


def flagship(M=32, N=30, xdim=4, udim=2, Nc=5, max_it=8, dtype=torch.float32,
             res_tol=1e-5, ipm_iters=15, device="cpu", **build_kw):
    """(solver, data): the headline Dubins-car problem, data (M, ...);
    batch it with `stack_varied`."""
    solver = build_scp_solver(
        dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=max_it,
        res_tol=res_tol, has_u_bounds=True, ipm_iters=ipm_iters, **build_kw)
    return solver, _instance(M, N, xdim, udim, dtype, device)


def stack_varied(data: SCPData, B: int) -> SCPData:
    """Broadcast one instance to a (B, M, ...) batch with x0 varied from
    seed 1 (the same numbers as ``bench._stack_varied``)."""
    stack = SCPData(*(None if a is None else a.expand((B,) + a.shape).clone()
                      for a in data))
    x0 = stack.x0.cpu().numpy()
    rng = np.random.default_rng(1)
    x0 = x0 + 0.05 * rng.normal(size=x0.shape).astype(x0.dtype)
    return stack._replace(x0=torch.from_numpy(x0).to(stack.x0.device))


def probe(dtype=torch.float64, device="cpu"):
    """(solver, data (1, M, ...)): the ``benchmarks/accuracy_probe.py`` config
    (M=8, N=30, Nc=5, no acceleration), whose f64 answer is
    ``benchmarks/accuracy_ref_u64.npy``."""
    M, N, xdim, udim = 8, 30, 4, 2
    solver = build_scp_solver(
        dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=5, max_it=60,
        res_tol=1e-5, has_u_bounds=True, ipm_iters=25,
        ipm_tol_exp=-9 if dtype == torch.float64 else -6)
    data = _instance(M, N, xdim, udim, dtype, device)
    return solver, SCPData(*(None if a is None else a[None] for a in data))
