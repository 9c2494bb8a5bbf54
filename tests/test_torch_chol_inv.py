"""Inverse-Cholesky kernels K1-K4 (`pmpc_tpu_torch.ops.chol_inv`).

The plain PyTorch versions are held against the TPU kernels (Pallas, in
interpret mode) and against numpy in f64. The CUDA kernel is held against the
plain version on the card; those cases carry the `cuda` marker and skip
without one. The kernel's algorithm (one right-looking sweep over panels of
NB columns that builds the factor and its inverse together) is walked step by
step in torch here, `_panel_inv_chol`, and held against the plain versions on
the CPU: it pins the panel arithmetic, the ragged last panel and the NaN
contract where no card is needed. JAX is imported inside the interpret-mode fixture only, so the
CUDA cases also run where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_chol_inv.py
"""

import numpy as np
import pytest
import torch

from pmpc_tpu_torch.ops import chol_inv

torch.set_num_threads(1)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The Pallas kernels through the interpreter, set up exactly as
    tests/test_pallas_chol.py does."""
    import jax
    from pmpc_tpu.ops import pallas_chol

    monkeypatch.setattr(pallas_chol, "INTERPRET", True)
    monkeypatch.setattr(pallas_chol, "_FACTOR_CACHE", {})
    monkeypatch.setattr(pallas_chol, "_FACTOR_DIAG_CACHE", {})
    yield pallas_chol
    jax.clear_caches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _spd(rng, B, n, dtype=np.float64):
    G = rng.normal(size=(B, n, n)) / np.sqrt(n)
    return (G @ np.swapaxes(G, -1, -2) + np.eye(n)).astype(dtype)


def _ref_inv_chol(A):
    return np.linalg.inv(np.linalg.cholesky(np.asarray(A, np.float64)))


@pytest.mark.parametrize("n", [10, 12])
def test_plain_matches_pallas_interpret(pallas_interpret, n):
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    A = _spd(rng, 5, n, np.float32)
    w = rng.uniform(0.1, 2.0, size=(5, n)).astype(np.float32)
    ref2 = np.asarray(pallas_interpret.pallas_inv_cholesky(
        jnp.asarray(A), jitter=1e-3))
    ref1 = np.asarray(pallas_interpret.pallas_inv_cholesky_diag(
        jnp.asarray(A), jnp.asarray(w), jitter=1e-3))
    out2 = chol_inv.inv_cholesky(torch.from_numpy(A), 1e-3).numpy()
    out1 = chol_inv.inv_cholesky_diag(
        torch.from_numpy(A), torch.from_numpy(w), 1e-3).numpy()
    assert np.max(np.abs(out2 - ref2)) < 5e-5
    assert np.max(np.abs(out1 - ref1)) < 5e-5


@pytest.mark.parametrize("n", [12, 72])
def test_plain_matches_big_pallas_interpret(pallas_interpret, monkeypatch, n):
    """The single-buffer in-place TPU kernels (K3/K4), forced as
    tests/test_pallas_chol.py forces them; n=12 also covers their identity
    padding to a multiple of 8, n=72 is a size only they take."""
    import jax.numpy as jnp

    monkeypatch.setattr(pallas_interpret, "_fits_small", lambda n: False)
    rng = np.random.default_rng(100 + n)
    A = _spd(rng, 3, n, np.float32)
    w = rng.uniform(0.1, 2.0, size=(3, n)).astype(np.float32)
    ref4 = np.asarray(pallas_interpret.pallas_inv_cholesky(
        jnp.asarray(A), jitter=1e-3))
    ref3 = np.asarray(pallas_interpret.pallas_inv_cholesky_diag(
        jnp.asarray(A), jnp.asarray(w), jitter=1e-3))
    out4 = chol_inv.inv_cholesky(torch.from_numpy(A), 1e-3).numpy()
    out3 = chol_inv.inv_cholesky_diag(
        torch.from_numpy(A), torch.from_numpy(w), 1e-3).numpy()
    assert np.max(np.abs(out4 - ref4)) < 5e-5
    assert np.max(np.abs(out3 - ref3)) < 5e-5


@pytest.mark.parametrize("n", [50, 90])
def test_plain_matches_numpy_f64(n):
    rng = np.random.default_rng(0)
    A = _spd(rng, 4, n)
    w = rng.uniform(0.1, 2.0, size=(4, n))
    out = chol_inv.inv_cholesky_diag(torch.from_numpy(A), torch.from_numpy(w),
                                     1e-7).numpy()
    ref = _ref_inv_chol(A + np.stack([np.diag(wi + 1e-7) for wi in w]))
    assert np.max(np.abs(out - ref)) < 1e-10
    assert np.all(np.triu(out, 1) == 0.0)  # explicit zeros above the diagonal
    out2 = chol_inv.inv_cholesky(torch.from_numpy(A)).numpy()
    assert np.max(np.abs(out2 - _ref_inv_chol(A))) < 1e-10


def test_jitter_applied():
    rng = np.random.default_rng(3)
    A = _spd(rng, 2, 8)
    out = chol_inv.inv_cholesky(torch.from_numpy(A), 0.5).numpy()
    assert np.max(np.abs(out - _ref_inv_chol(A + 0.5 * np.eye(8)))) < 1e-12
    assert np.max(np.abs(out - _ref_inv_chol(A))) > 1e-3


def test_non_spd_gives_nan_and_does_not_leak():
    rng = np.random.default_rng(4)
    A = _spd(rng, 3, 9)
    A[1] = -np.eye(9)
    out = chol_inv.inv_cholesky(torch.from_numpy(A)).numpy()
    assert np.isnan(out[1]).all()
    for b in (0, 2):
        assert np.max(np.abs(out[b] - _ref_inv_chol(A[b]))) < 1e-12


def test_cpu_calls_are_not_launches():
    chol_inv.reset_launch_counts()
    A = torch.from_numpy(_spd(np.random.default_rng(5), 2, 6))
    chol_inv.inv_cholesky(A)
    chol_inv.inv_cholesky_diag(A, torch.ones(2, 6, dtype=A.dtype))
    A = torch.from_numpy(_spd(np.random.default_rng(5), 2, 70))
    chol_inv.inv_cholesky(A)
    chol_inv.inv_cholesky_diag(A, torch.ones(2, 70, dtype=A.dtype))
    assert chol_inv.LAUNCHES == {
        "inv_cholesky": 0, "inv_cholesky_diag": 0,
        "inv_cholesky_big": 0, "inv_cholesky_diag_big": 0}
    assert not chol_inv.SHAPES  # the record of launched shapes stays empty too


# -- the kernel's panel algorithm, step by step on the CPU ---------------------

def _panel_inv_chol(A, nb):
    """L^{-1} of the (B, n, n) blocks A as csrc/chol_inv.cu computes it. For
    each panel k of `nb` columns: F1 factor the diagonal block as
    M diag(p) M' (M unit lower triangular, p the pivots: its entries are
    true divisions u / p, and no square root between two pivots), so L_kk = M diag(sqrt p),
    and keep rs = 1 / sqrt(p); I1 finish row block k of the inverse by
    forward substitution against M and scaling by rs (W[k, k] = I gives
    X_kk); F2 panel solve by the same substitution; F3 trailing update; I2
    update of the inverse's running sums W, which take the place of L below
    the diagonal. A block with a pivot that is not > 0 comes back all NaN."""
    B, n, _ = A.shape
    a = torch.tril(A).clone()  # only the lower triangle is read
    spd = torch.ones(B, dtype=torch.bool)
    eye = torch.eye(nb, dtype=A.dtype)
    nan = torch.full((B,), float("nan"), dtype=A.dtype)
    for k0 in range(0, n, nb):
        kb = min(nb, n - k0)
        base = k0 + nb
        # F1: a ragged last block is completed by identity rows
        D = eye.repeat(B, 1, 1)
        D[:, :kb, :kb] = torch.tril(a[:, k0:k0 + kb, k0:k0 + kb])
        p = torch.zeros(B, nb, dtype=A.dtype)
        for j in range(nb):
            piv = D[:, j, j].clone()
            spd &= piv > 0
            p[:, j] = torch.where(piv > 0, piv, nan)
            u = D[:, :, j].clone()
            D[:, :, j] = u / p[:, j, None]
            for c in range(j + 1, nb):
                D[:, c:, c] -= D[:, c:, j] * u[:, c, None]
        rs = 1 / torch.sqrt(p)

        def substitute(W):
            """L_kk^{-1} W: rows y_i = W_i - sum_{c<i} M_ic y_c, scaled by rs."""
            Y = []
            for i in range(nb):
                acc = W[:, i, :]
                for c in range(i):
                    acc = acc - D[:, i, c, None] * Y[c]
                Y.append(acc)
            return torch.stack(Y, 1) * rs[:, :, None]

        # I1: X[k, :k0] = L_kk^{-1} W[k, :k0]; X_kk = L_kk^{-1} I
        W = torch.zeros(B, nb, k0 + nb, dtype=A.dtype)
        W[:, :kb, :k0] = a[:, k0:k0 + kb, :k0]
        W[:, :, k0:] = eye
        a[:, k0:k0 + kb, :k0 + kb] = substitute(W)[:, :kb, :k0 + kb]
        if base >= n:
            break
        L21 = substitute(a[:, base:, k0:base].mT).mT              # F2
        a[:, base:, base:] -= torch.tril(L21 @ L21.mT)            # F3
        a[:, base:, :k0] -= L21 @ a[:, k0:base, :k0]              # I2
        a[:, base:, k0:base] = -(L21 @ a[:, k0:base, k0:base])
    out = torch.tril(a)
    out[~spd] = float("nan")
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("nb", [4, 8])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 33, 50, 64, 65, 90, 96])
def test_panel_algorithm_matches_plain(n, nb, dtype, tol):
    rng = np.random.default_rng(1000 + n)
    A = torch.from_numpy(_spd(rng, 3, n)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, size=(3, n))).to(dtype)
    out2 = _panel_inv_chol(A + 1e-7 * torch.eye(n, dtype=dtype), nb)
    out1 = _panel_inv_chol(A + torch.diag_embed(w + 1e-7), nb)
    assert _rel_err(out2, chol_inv.inv_cholesky_plain(A, 1e-7)) < tol
    assert _rel_err(out1, chol_inv.inv_cholesky_diag_plain(A, w, 1e-7)) < tol
    assert (torch.triu(out1, 1) == 0).all() and (torch.triu(out2, 1) == 0).all()


@pytest.mark.parametrize("nb", [4, 8])
@pytest.mark.parametrize("bad", ["pivot", "nan_entry", "nan_last_row"])
def test_panel_algorithm_nan_contract(nb, bad):
    """The bad pivot shows up in the middle of a panel (column 11 of 20, not
    a panel's first), or only through a NaN below the diagonal."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(_spd(rng, 3, 20))
    if bad == "pivot":
        A[1, 11, 11] = -5.0
    elif bad == "nan_entry":
        A[1, 13, 6] = float("nan")
    else:
        A[1, 19, 18] = float("nan")
    out = _panel_inv_chol(A, nb)
    ref = chol_inv.inv_cholesky_plain(A)
    assert torch.isnan(out[1]).all() and torch.isnan(ref[1]).all()
    keep = [0, 2]
    assert torch.isfinite(out[keep]).all()
    assert _rel_err(out[keep], ref[keep]) < 1e-10


def test_panel_algorithm_conditioning():
    """Weights over twelve orders of magnitude, as the IPM's late iterations
    give them: the panel order's residual stays within four times the plain
    version's (another summation order, not another algorithm)."""
    rng = np.random.default_rng(8)
    for n in (50, 90):
        A = torch.from_numpy(_spd(rng, 8, n)).float()
        w = torch.from_numpy(10.0 ** rng.uniform(-6, 6, size=(8, n))).float()
        K = A.double() + torch.diag_embed(w.double())
        res = [_factor_residual(M, K) for M in (
            _panel_inv_chol(A + torch.diag_embed(w), 8),
            chol_inv.inv_cholesky_diag_plain(A, w))]
        assert res[0] <= 4 * res[1]


def _factor_residual(Minv, K):
    """|Minv K Minv' - I|_max with the products in f64."""
    M = Minv.double()
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (M @ K @ M.mT - eye).abs().max().item()


# -- blocks past the kernels' limit ---------------------------------------------

def test_block_chol_inv_cholesky_matches_jax_n120():
    """n = 120 is past the kernels (n <= 96) in both packages: the JAX package
    sends it to `block_chol.inv_cholesky`, and so does the port."""
    import jax.numpy as jnp
    from pmpc_tpu.ops import block_chol as jblock
    from pmpc_tpu_torch.ops import block_chol, linalg

    rng = np.random.default_rng(120)
    A = _spd(rng, 3, 120)
    w = rng.uniform(0.1, 2.0, size=(3, 120))
    ref = np.asarray(jblock.inv_cholesky(jnp.asarray(A), jitter=1e-7))
    assert ref.dtype == np.float64
    out = block_chol.inv_cholesky(torch.from_numpy(A), 1e-7)
    assert np.max(np.abs(out.numpy() - ref)) < 1e-10
    assert torch.equal(linalg.spd_factor(torch.from_numpy(A), 1e-7), out)
    refd = np.asarray(jblock.inv_cholesky(
        jnp.asarray(A + np.stack([np.diag(wi) for wi in w])), jitter=1e-7))
    outd = linalg.spd_factor_diag(torch.from_numpy(A), torch.from_numpy(w), 1e-7)
    assert np.max(np.abs(outd.numpy() - refd)) < 1e-10
    bad = torch.from_numpy(A.copy())
    bad[1] = -torch.eye(120, dtype=torch.float64)
    Minv = linalg.spd_factor(bad)
    assert torch.isnan(Minv[1]).all() and torch.isfinite(Minv[[0, 2]]).all()


# -- on the card ---------------------------------------------------------------

def _rel_err(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("B,n", [(2048, 50), (64, 10), (37, 1), (5, 7),
                                 (33, 33), (9, 64), (37, 65), (2048, 90),
                                 (37, 96), (37, 8), (37, 9), (37, 63),
                                 (37, 95)])
def test_kernel_matches_plain(cuda, dtype, tol, B, n):
    rng = np.random.default_rng(n)
    A = torch.from_numpy(_spd(rng, B, n)).to(cuda, dtype)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, size=(B, n))).to(cuda, dtype)
    chol_inv.reset_launch_counts()
    out1 = chol_inv.inv_cholesky_diag(A, w, 1e-7)
    out2 = chol_inv.inv_cholesky(A, 1e-7)
    torch.cuda.synchronize()
    big = "_big" if n > 64 else ""  # K3/K4 past n = 64, counted apart
    assert {k for k, v in chol_inv.LAUNCHES.items() if v} == {
        "inv_cholesky" + big, "inv_cholesky_diag" + big}
    assert sum(chol_inv.LAUNCHES.values()) == 2
    assert _rel_err(out1, chol_inv.inv_cholesky_diag_plain(A, w, 1e-7)) < tol
    assert _rel_err(out2, chol_inv.inv_cholesky_plain(A, 1e-7)) < tol
    assert (torch.triu(out1, 1) == 0).all() and (torch.triu(out2, 1) == 0).all()


@pytest.mark.cuda
def test_kernel_nan_contract(cuda):
    rng = np.random.default_rng(6)
    A = torch.from_numpy(_spd(rng, 4, 12)).to(cuda, torch.float32)
    A[2] = -torch.eye(12, device=cuda)
    out = chol_inv.inv_cholesky(A)
    ref = chol_inv.inv_cholesky_plain(A)
    assert torch.isnan(out[2]).all()
    keep = [0, 1, 3]
    assert torch.isfinite(out[keep]).all()
    assert _rel_err(out[keep], ref[keep]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 90])
@pytest.mark.parametrize("bad", ["pivot", "nan_entry", "nan_weight"])
def test_kernel_nan_contract_inside_a_panel(cuda, n, bad):
    rng = np.random.default_rng(n)
    A = torch.from_numpy(_spd(rng, 4, n)).to(cuda, torch.float32)
    w = torch.ones(4, n, device=cuda)
    if bad == "pivot":
        A[2, 11, 11] = -5.0
    elif bad == "nan_entry":
        A[2, n - 1, n - 2] = float("nan")
    else:
        w[2, 13] = float("nan")
    out = chol_inv.inv_cholesky_diag(A, w)
    ref = chol_inv.inv_cholesky_diag_plain(A, w)
    assert torch.isnan(out[2]).all()
    keep = [0, 1, 3]
    assert torch.isfinite(out[keep]).all()
    assert _rel_err(out[keep], ref[keep]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 90])
def test_kernel_conditioning(cuda, n):
    """Weights log-uniform over [1e-6, 1e6]: the kernel's residual within
    four times the plain version's (another summation order, not another
    algorithm)."""
    rng = np.random.default_rng(n)
    A = torch.from_numpy(_spd(rng, 256, n)).to(cuda, torch.float32)
    w = torch.from_numpy(10.0 ** rng.uniform(-6, 6, size=(256, n))).to(
        cuda, torch.float32)
    K = A.double() + torch.diag_embed(w.double())
    res = _factor_residual(chol_inv.inv_cholesky_diag(A, w), K)
    ref = _factor_residual(chol_inv.inv_cholesky_diag_plain(A, w), K)
    assert res <= 4 * ref


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    A = torch.eye(97, device=cuda).expand(2, 97, 97).contiguous()
    with pytest.raises(NotImplementedError, match="block_chol"):
        chol_inv.inv_cholesky(A)
    with pytest.raises(NotImplementedError):
        chol_inv.inv_cholesky(A[:, :8, :8].contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        chol_inv.inv_cholesky(A[:, :8, :8])
