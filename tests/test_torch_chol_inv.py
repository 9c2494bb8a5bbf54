"""Inverse-Cholesky kernels K1-K4 (`pmpc_tpu_torch.ops.chol_inv`).

The plain PyTorch versions are held against the TPU kernels (Pallas, in
interpret mode) and against numpy in f64. The CUDA kernel is held against the
plain version on the card; those cases carry the `cuda` marker and skip
without one. JAX is imported inside the interpret-mode fixture only, so the
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


# -- on the card ---------------------------------------------------------------

def _rel_err(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("B,n", [(2048, 50), (64, 10), (37, 1), (5, 7),
                                 (33, 33), (9, 64), (37, 65), (2048, 90),
                                 (37, 96)])
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
def test_kernel_rejects_what_it_does_not_take(cuda):
    A = torch.eye(97, device=cuda).expand(2, 97, 97).contiguous()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chol_inv.inv_cholesky(A)
    with pytest.raises(NotImplementedError):
        chol_inv.inv_cholesky(A[:, :8, :8].contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        chol_inv.inv_cholesky(A[:, :8, :8])
