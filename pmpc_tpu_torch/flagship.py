"""The headline program, the accuracy-probe configuration, the BASELINE.json
measurement configs 1-5, the long-horizon configuration and the batched cone
programs, in torch.

Twins of ``__graft_entry__._flagship``/``_dubins``, ``bench._stack_varied``,
``benchmarks/accuracy_probe.build``, ``benchmarks/configs.py``,
``benchmarks/long_horizon_bench.py`` and the batched cells of
``benchmarks/bench_cvar_extras.py``: the same numpy seeds, so both packages
build the same instances. Every function here puts its data on the card
unless the caller names a device (``device=None`` reaches
`utils.default_device` through `make_scp_data`); the cone batches are
problem dicts of numpy arrays for `conebatch.solve_problems_cone`, which
takes the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .torch_scp import SCPData, build_scp_solver, make_scp_data

# the headline build (bench.py): a solve counts when the SCP residual <= 1e-3
HEADLINE_KW = dict(max_it=25, res_tol=1e-3, accel="AA", ipm_iters=8)
# benchmarks/configs.py: the same convention for configs 1-4; the pod-scale
# config 5 counts at 2.5e-3 under a 40-iteration cap (its f32 residual floor
# on the TPU sat near 2e-3)
CONFIG_KW = dict(max_it=25, res_tol=1e-3, accel="AA")
PODSCALE_KW = dict(CONFIG_KW, max_it=40, res_tol=2.5e-3, ipm_iters=12)
# benchmarks/long_horizon_bench.py: one single-particle problem through the
# O(N) route, control boxes + state boxes + slew; the tolerance is out of
# reach on purpose, so a call runs exactly ``max_it`` SCP iterations
LONG_HORIZON_KW = dict(res_tol=1e-9, has_u_bounds=True, has_x_bounds=True,
                       has_slew=True, method="riccati", ipm_iters=8)


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


def _instance(x0, N, udim, dtype, device, bounded=True, u_soc_r=None) -> SCPData:
    """One (M, ...) Dubins problem from its numpy x0 (M, xdim): identity Q,
    R = 1e-2 I, box controls +-1 when ``bounded``, the cone ||u_j|| <=
    ``u_soc_r`` on every stage when that is given."""
    nd = x0.dtype
    M, xdim = x0.shape
    Q = np.tile(np.eye(xdim, dtype=nd), (M, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(nd), (M, N, 1, 1))
    box = dict(u_l=-np.ones((M, N, udim), nd), u_u=np.ones((M, N, udim), nd)) \
        if bounded else {}
    if u_soc_r is not None:
        box["u_soc_r"] = np.full((M, N), u_soc_r, nd)
    return make_scp_data(x0, Q, R, reg_x=1.0, reg_u=0.1, dtype=dtype,
                         device=device, **box)


def _x0_seed0(M, xdim, dtype):
    """The flagship/probe x0: ones plus seed-0 noise, rounded once."""
    rng = np.random.default_rng(0)
    return (np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))) \
        .astype(_np_dtype(dtype))


def flagship(M=32, N=30, xdim=4, udim=2, Nc=5, max_it=8, dtype=torch.float32,
             res_tol=1e-5, ipm_iters=15, device=None, u_soc_r=None, **build_kw):
    """(solver, data): the headline Dubins-car problem, data (M, ...);
    batch it with `stack_varied`. ``method="riccati"`` (as any other option
    of `build_scp_solver`) sends the same instance through the O(N) route.
    ``u_soc_r``: add the cone ||u_j|| <= u_soc_r on every stage (not part
    of the headline program: the cone-constrained variant of its shape)."""
    solver = build_scp_solver(
        dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=max_it,
        res_tol=res_tol, has_u_bounds=True, ipm_iters=ipm_iters,
        has_u_soc=u_soc_r is not None, **build_kw)
    return solver, _instance(_x0_seed0(M, xdim, dtype), N, udim, dtype, device,
                             u_soc_r=u_soc_r)


def stack_varied(data: SCPData, B: int, scale: float = 0.05) -> SCPData:
    """Broadcast one instance to a (B, M, ...) batch with x0 varied from
    seed 1: ``scale=0.05`` gives the numbers of ``bench._stack_varied``,
    ``scale=0.02`` those of ``benchmarks/configs.bench_solver``."""
    stack = SCPData(*(None if a is None else a.expand((B,) + a.shape).clone()
                      for a in data))
    x0 = stack.x0.cpu().numpy()
    rng = np.random.default_rng(1)
    x0 = x0 + scale * rng.normal(size=x0.shape).astype(x0.dtype)
    return stack._replace(x0=torch.from_numpy(x0).to(stack.x0.device))


def podscale(dtype=torch.float32, device=None, bounded=True, M=64, **build_kw):
    """(solver, data (M, ...)): BASELINE.json config 5, the pod-scale shape
    (``benchmarks/configs.py``: M=64, N=50, Nc=5, box controls, x0 = ones;
    nf = 90). Batch it with ``stack_varied(data, B, scale=0.02)``.
    ``bounded=False`` drops the control box: the subproblem is then the
    unconstrained solve at the same shape. ``method="riccati"`` sends the
    same instance through the O(N) route."""
    N, xdim, udim = 50, 4, 2
    kw = dict(PODSCALE_KW, **build_kw)
    if not bounded:
        kw.pop("ipm_iters")
    solver = build_scp_solver(dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=5,
                              has_u_bounds=bounded, **kw)
    x0 = np.ones((M, xdim), _np_dtype(dtype))
    return solver, _instance(x0, N, udim, dtype, device, bounded=bounded)


def long_horizon(N, dtype=torch.float32, device=None, max_it=4, **build_kw):
    """(solver, data (M=1, ...)): the long-horizon configuration of
    ``benchmarks/long_horizon_bench.py`` (N = 140 and 280 there): one
    Dubins car, x0 = ones, box controls +-1, state boxes +-6, slew
    regularization 0.1, through ``method="riccati"`` (`LONG_HORIZON_KW`).
    The bench times ``max_it=4`` and ``max_it=12`` and reports
    (t12 - t4) / 8 as the time of one SCP iteration."""
    xdim, udim, M = 4, 2, 1
    nd = _np_dtype(dtype)
    solver = build_scp_solver(dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=0,
                              max_it=max_it, **dict(LONG_HORIZON_KW, **build_kw))
    data = make_scp_data(
        np.ones((M, xdim), nd), np.tile(np.eye(xdim, dtype=nd), (M, N, 1, 1)),
        np.tile((1e-2 * np.eye(udim)).astype(nd), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1, slew_reg=0.1,
        u_l=-np.ones((M, N, udim), nd), u_u=np.ones((M, N, udim), nd),
        x_l=-np.full((M, N, xdim), 6.0, nd), x_u=np.full((M, N, xdim), 6.0, nd),
        dtype=dtype, device=device)
    return solver, data


def obstacle_lin_cost(X_prev, U_prev, data):
    """Config 4's nonconvex cost: the gradient of a log-barrier around the
    obstacle at (0.5, 0.5), pushing the positions away from it."""
    obs = torch.tensor([0.5, 0.5], dtype=X_prev.dtype, device=X_prev.device)
    diff = X_prev[..., :2] - obs
    d2 = (diff * diff).sum(-1, keepdim=True) + 0.1
    cx = torch.cat([-0.5 * 2.0 * diff / d2, torch.zeros_like(X_prev[..., 2:])], -1)
    return cx, None


SOC_R3 = 0.9  # config 3's thrust cone ||u_j|| <= 0.9


def baseline_config(k: int, dtype=torch.float32, device=None, **build_kw):
    """(solver, data (M, ...), B): BASELINE.json config ``k`` in {1, 2, 3, 4}
    as ``benchmarks/configs.py`` builds it, with the batch size it runs at
    (``stack_varied(data, B, scale=0.02)``). 1: single-system quadratic MPC,
    N=20; 2: consensus over M=10 particles sharing the first control; 3:
    config 1 with box controls +-1 and the cone ||u_j|| <= 0.9 on every
    stage (the IPM's cone path); 4: config 1 with the obstacle cost
    (`obstacle_lin_cost`). 1, 2 and 4 are unbounded."""
    N, xdim, udim = 20, 4, 2
    if k not in (1, 2, 3, 4):
        raise ValueError(f"baseline_config takes k in (1, 2, 3, 4), got {k} "
                         "(5: `podscale`)")
    M, Nc, B = (10, 1, 128) if k == 2 else (1, 0, 512)
    nd = _np_dtype(dtype)
    x0 = np.ones((M, xdim), nd)
    if k == 2:  # the noise is rounded before it is added, as configs.py does
        x0 = x0 + 0.05 * np.random.default_rng(0).normal(size=(M, xdim)).astype(nd)
    kw = dict(CONFIG_KW, **build_kw)
    if k == 4:
        kw["lin_cost_fn"] = obstacle_lin_cost
    if k == 3:
        kw.update(has_u_bounds=True, has_u_soc=True)
    solver = build_scp_solver(dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, **kw)
    return solver, _instance(x0, N, udim, dtype, device, bounded=k == 3,
                             u_soc_r=SOC_R3 if k == 3 else None), B


def probe(dtype=torch.float64, device=None):
    """(solver, data (1, M, ...)): the ``benchmarks/accuracy_probe.py`` config
    (M=8, N=30, Nc=5, no acceleration), whose f64 answer is
    ``benchmarks/accuracy_ref_u64.npy``."""
    M, N, xdim, udim = 8, 30, 4, 2
    solver = build_scp_solver(
        dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=5, max_it=60,
        res_tol=1e-5, has_u_bounds=True, ipm_iters=25,
        ipm_tol_exp=-9 if dtype == torch.float64 else -6)
    data = _instance(_x0_seed0(M, xdim, dtype), N, udim, dtype, device)
    return solver, SCPData(*(None if a is None else a[None] for a in data))


def _cone_problem(seed, M, N, max_it, res_tol, **extra):
    """One problem dict of the batched cone cells: the Dubins car under
    ``dynamics``, M particles with x0 = ones + 0.05 N(0, 1) from ``seed``, Q =
    I, R = 1e-2 I (``bench_cvar_extras.py:120-128``)."""
    xdim, udim = 4, 2
    rng = np.random.default_rng(seed)
    return dict(dynamics=dubins, Q=np.tile(np.eye(xdim), (M, N, 1, 1)),
                R=np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
                x0=np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim)),
                max_it=max_it, res_tol=res_tol, **extra)


def cvar_batch(B=64, M=4, N=20, k=3, max_it=40, res_tol=1e-3, **settings):
    """``bench_cvar_extras.py``'s converging batched CVaR cell
    (``batched_cvar_k3_fullcons_B64_M4_tol1e-3``, ``:165-178``): B problems,
    problem i from seed i, the k-worst objective over M particles with full
    consensus (Nc = N), no bounds. Its program has nv = N udim + M + 1 (45 at
    the defaults: K2) and M epigraph cones of size N udim + 2 (the J-gram)."""
    return [_cone_problem(i, M, N, max_it, res_tol, solver_settings=dict(k=k, **settings))
            for i in range(B)]


KEEP_IN_C, KEEP_IN_R = (1.2, 1.2), 1.0  # the extras cell's keep-in disk: binds late
SOFT_PX, SOFT_COST = 0.2, 10.0  # px_N - s <= SOFT_PX, s >= 0, cost SOFT_COST s


def keep_in_extras(M, N, Nc, xdim=4, udim=2):
    """One ``extra_cstrs`` tuple over the full layout [u_cons; u_free; x]:
    a keep-in cone ||(px, py) - KEEP_IN_C|| <= KEEP_IN_R on every particle's
    position at every stage (M N cones of size 3 that touch states, so the
    stage-cone detection declines them), and a soft bound on particle 0's
    px at stage N through one auxiliary slack s of cost SOFT_COST: the rows
    px_N - s <= SOFT_PX and -s <= 0."""
    nu = Nc * udim + M * (N - Nc) * udim
    n_full = nu + M * N * xdim
    rows = 2 + 3 * M * N
    G, h, G_r = np.zeros((rows, n_full)), np.zeros(rows), np.zeros((rows, 1))
    G[0, nu + (N - 1) * xdim], h[0] = 1.0, SOFT_PX
    G_r[0, 0] = G_r[1, 0] = -1.0
    for i in range(M):
        for j in range(N):
            r0, x = 2 + 3 * (i * N + j), nu + (i * N + j) * xdim
            h[r0:r0 + 3] = (KEEP_IN_R, -KEEP_IN_C[0], -KEEP_IN_C[1])
            G[r0 + 1, x], G[r0 + 2, x + 1] = -1.0, -1.0
    return (2, [3] * (M * N), 0, G, G_r, h, np.zeros(n_full), np.array([SOFT_COST]))


def extras_batch(B=64, M=2, N=20, Nc=5, squareplus=False, max_it=40, res_tol=1e-3,
                 **settings):
    """The composed extras cell: B problems as `cvar_batch` seeds them, box
    controls +-1, consensus over the first Nc stages. By default the
    `keep_in_extras` tuple and the terminal cross cost Hf = 0.1 I over the
    stacked final states: nv = Nc udim + M (N - Nc) udim + 1 (71 at the
    defaults: K4). ``squareplus=True`` instead smooths the boxes
    (``smooth_cstr="squareplus"``) under the cones ||u_j|| <= 0.9: a
    composed program of nv = 3 (Nc udim + M (N - Nc) udim) (210: past every
    hand kernel)."""
    box = dict(u_l=-np.ones((M, N, 2)), u_u=np.ones((M, N, 2)))
    if squareplus:
        ss = dict(Nc=Nc, smooth_cstr="squareplus", u_soc_r=np.full((M, N), SOC_R3))
    else:
        ss = dict(Nc=Nc, extra_cstrs=[keep_in_extras(M, N, Nc)], Hf=0.1 * np.eye(M * 4))
    return [_cone_problem(i, M, N, max_it, res_tol, solver_settings=dict(ss, **settings),
                          **box) for i in range(B)]
