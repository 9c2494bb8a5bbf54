"""ctypes bindings for the native host-side runtime (libpmpc_native).

The port's own copy of ``pmpc_tpu/native.py`` (importing that module would
import JAX through ``pmpc_tpu/__init__.py``). Role parity with the
reference's native bridge (``PMPC.jl/pmpcjl/module.cpp`` flat f64 ABI +
``pmpc/import_pmpcjl.py`` library loading): ``native/pmpc_native.cpp`` is
compiled on demand by ``native/Makefile`` into the port's own
build directory (``pmpc_tpu_torch/_build/native/``, never over
``native/libpmpc_native.so``, which the JAX package's binding builds) and
loaded with ctypes; `load` returns None when no compiler is available, and
callers keep their pure-Python paths. Concurrent processes build under an
``fcntl`` lock into a temporary name that is renamed into place, so no
process loads a half-written library. A host library: it has no device
path.

Exports:
- `build_canonical(...)`: native canonical consensus-QP assembly (the
  output of `pmpc_tpu_torch.canonical`), for host-side serving paths,
- `admm_box_qp(...)`: dense ADMM box-QP solver (the OSQP-role CPU
  fallback and cross-check backend),
- `AdmmSolver`: the same solver kept alive across solves.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_SRC = os.path.join(_NATIVE_DIR, "pmpc_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libpmpc_native.so")

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i64p = ctypes.POINTER(ctypes.c_int64)


def _stale() -> bool:
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))


def _build() -> bool:
    """Compile the library when it is missing or older than its source, with
    ``native/Makefile`` itself (its CXX and CXXFLAGS, environment overrides
    included) run in a fresh directory under the build directory that
    links to the source. The compile holds an exclusive lock and the
    result is renamed into place: a process that finds the library finds it
    whole."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(_LIB_PATH + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _stale():
                tmp = tempfile.mkdtemp(dir=_BUILD_DIR)
                try:
                    os.symlink(_SRC, os.path.join(tmp, "pmpc_native.cpp"))
                    subprocess.run(["make", "-s", "-C", tmp, "-f",
                                    os.path.join(_NATIVE_DIR, "Makefile"), "libpmpc_native.so"],
                                   check=True, capture_output=True, timeout=120)
                    os.replace(os.path.join(tmp, "libpmpc_native.so"), _LIB_PATH)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
    except (OSError, subprocess.SubprocessError):
        pass
    return os.path.exists(_LIB_PATH)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    # always check the source's time: a STALE library is rebuilt when the C++
    # source changed (a missing-only check once served a pre-fix binary to
    # the whole test suite)
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    lib.pmpc_build_canonical.restype = i64
    lib.pmpc_build_canonical.argtypes = [i64] * 5 + [_f64p] * 15 + [_f64p] * 4
    lib.pmpc_admm_box_qp.restype = i64
    lib.pmpc_admm_box_qp.argtypes = [
        i64, i64, _f64p, _f64p, _f64p, _f64p, _f64p, _f64p,
        f64, f64, i64, f64, _f64p, _i64p,
    ]
    lib.pmpc_admm_create.restype = i64
    lib.pmpc_admm_create.argtypes = [i64, i64] + [_f64p] * 6 + [f64, f64]
    for name, extra in (
        ("pmpc_admm_destroy", []),
        ("pmpc_admm_set_q", [_f64p]),
        ("pmpc_admm_set_P", [_f64p]),
        ("pmpc_admm_set_b", [_f64p]),
        ("pmpc_admm_set_bounds", [_f64p, _f64p]),
        ("pmpc_admm_prox_setup", [_f64p]),
        ("pmpc_admm_prox_reset", []),
        ("pmpc_admm_cold_start", []),
    ):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [i64] + extra
    for name in ("pmpc_admm_solve", "pmpc_admm_prox"):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [i64] + ([_f64p] if name.endswith("prox") else []) \
            + [i64, f64, _f64p, _i64p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def _require_lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable (a C++ compiler missing?)")
    return lib


def _ok(ret: int, what: str) -> None:
    """Raise when a native call returned a nonzero status (checked with
    ``if``, not ``assert``: the call must run under ``python -O`` too)."""
    if ret != 0:
        raise RuntimeError(f"native {what} failed ({ret})")


def build_canonical(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
    reg_x, reg_u, slew_reg, slew_reg0, slew_um1, Nc: int = -1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native canonical assembly: returns (P, q, A, b). Inputs (M, ...) f64."""
    lib = _require_lib()
    c = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    x0, f, fx, fu = c(x0), c(f), c(fx), c(fu)
    X_prev, U_prev, Q, R, X_ref, U_ref = map(c, (X_prev, U_prev, Q, R, X_ref, U_ref))
    M, N, xdim = f.shape
    udim = fu.shape[-1]
    reg_x = c(np.broadcast_to(reg_x, (M,)))
    reg_u = c(np.broadcast_to(reg_u, (M,)))
    slew_reg = c(np.broadcast_to(slew_reg, (M,)))
    slew_reg0 = c(np.broadcast_to(slew_reg0, (M,)))
    slew_um1 = c(np.broadcast_to(slew_um1, (M, udim)))
    Ncv = N if Nc < 0 else Nc
    n = Ncv * udim + M * (N - Ncv) * udim + M * N * xdim
    meq = M * N * xdim
    P = np.zeros((n, n)); q = np.zeros(n)
    A = np.zeros((meq, n)); b = np.zeros(meq)
    ret = lib.pmpc_build_canonical(
        M, N, xdim, udim, Nc,
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
        reg_x, reg_u, slew_reg, slew_reg0, slew_um1,
        P, q, A, b,
    )
    _ok(ret, "build_canonical")
    return P, q, A, b


def admm_box_qp(
    P, q, A, b, lo, hi,
    rho: float = 1.0, sigma: float = 1e-6,
    max_iter: int = 4000, eps: float = 1e-9,
) -> Tuple[np.ndarray, int, int]:
    """Native dense ADMM box QP. Returns (z, status, iters)."""
    lib = _require_lib()
    c = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    P, q, A, b, lo, hi = map(c, (P, q, A, b, lo, hi))
    n, meq = P.shape[0], A.shape[0]
    z = np.zeros(n)
    iters = ctypes.c_int64(0)
    status = lib.pmpc_admm_box_qp(
        n, meq, P, q, A, b, lo, hi,
        float(rho), float(sigma), int(max_iter), float(eps),
        z, ctypes.byref(iters),
    )
    return z, int(status), int(iters.value)


class AdmmSolver:
    """Persistent native ADMM solver with the reference OSQP adapter's
    incremental-update and proximal-operator API
    (``PMPC.jl/src/osqp_solver.jl:83-207``): ``set_q`` is free, ``set_P``
    refactors, ``prox_setup(mask)`` adds diag(mask) to P (one refactor) and
    ``prox(bias)`` then evaluates proximal points reusing that factorization.
    The internal iterates persist across solves (warm starting)."""

    def __init__(self, P, q, A, b, lo, hi, rho: float = 1.0, sigma: float = 1e-6):
        self._h = -1
        self._lib = _require_lib()
        c = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float64))
        P, q, A, b, lo, hi = map(c, (P, q, A, b, lo, hi))
        self.n, self.meq = P.shape[0], A.shape[0]
        self._h = int(self._lib.pmpc_admm_create(
            self.n, self.meq, P, q, A, b, lo, hi, float(rho), float(sigma)))
        if self._h < 0:
            raise RuntimeError("ADMM setup failed (KKT not positive definite)")

    def _arr(self, a, shape):
        out = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
        if out.shape != shape:
            raise ValueError(f"expected shape {shape}, got {out.shape}")
        return out

    def set_q(self, q):
        _ok(self._lib.pmpc_admm_set_q(self._h, self._arr(q, (self.n,))), "admm_set_q")

    def set_P(self, P):
        _ok(self._lib.pmpc_admm_set_P(self._h, self._arr(P, (self.n, self.n))), "admm_set_P")

    def set_b(self, b):
        _ok(self._lib.pmpc_admm_set_b(self._h, self._arr(b, (self.meq,))), "admm_set_b")

    def set_bounds(self, lo, hi):
        _ok(self._lib.pmpc_admm_set_bounds(
            self._h, self._arr(lo, (self.n,)), self._arr(hi, (self.n,))), "admm_set_bounds")

    def prox_setup(self, mask):
        _ok(self._lib.pmpc_admm_prox_setup(
            self._h, self._arr(mask, (self.n,))), "admm_prox_setup")

    def prox(self, bias, max_iter: int = 4000, eps: float = 1e-9):
        """argmin f0(z) + 0.5 z'diag(mask)z + bias'z (after prox_setup)."""
        z = np.zeros(self.n)
        iters = ctypes.c_int64(0)
        status = self._lib.pmpc_admm_prox(
            self._h, self._arr(bias, (self.n,)), int(max_iter), float(eps),
            z, ctypes.byref(iters))
        if status < 0:
            raise RuntimeError("prox before prox_setup?")
        return z, int(status), int(iters.value)

    def prox_point(self, v, mask, max_iter: int = 4000, eps: float = 1e-9):
        """prox_{f0, mask}(v) = argmin f0(z) + 0.5 ||z - v||^2_diag(mask)."""
        return self.prox(-np.asarray(mask, float) * np.asarray(v, float),
                         max_iter=max_iter, eps=eps)

    def prox_reset(self):
        _ok(self._lib.pmpc_admm_prox_reset(self._h), "admm_prox_reset")

    def cold_start(self):
        _ok(self._lib.pmpc_admm_cold_start(self._h), "admm_cold_start")

    def solve(self, max_iter: int = 4000, eps: float = 1e-9):
        z = np.zeros(self.n)
        iters = ctypes.c_int64(0)
        status = self._lib.pmpc_admm_solve(
            self._h, int(max_iter), float(eps), z, ctypes.byref(iters))
        return z, int(status), int(iters.value)

    def close(self):
        if self._h >= 0:
            self._lib.pmpc_admm_destroy(self._h)
            self._h = -1

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
