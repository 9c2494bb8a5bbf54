"""Typed optimal-control problem container with dimension inference and
particle tiling (numpy).

Twin of ``pmpc_tpu/problem.py``, copied so that the port never imports the
JAX package; behaviour of the reference ``pmpc/problem_struct.py:10-155``:

- dimensions ``N/xdim/udim`` are inferred from whichever arrays are provided,
  using the same field->dims map,
- defaults: ``Q=I``, ``R=0.1 I``, ``x0=0``, zero references, ``X_prev`` tiled
  from ``x0``, ``reg_x=reg_u=1.0``, ``max_it=30``, ``res_tol=1e-6``,
  ``verbose=True``,
- every array field is shape-checked on assignment and tiled up to
  ``(M, ...)`` when ``M`` is set,
- ``Problem`` is a ``Mapping`` so ``solve(**problem)`` works; ``Nc`` travels
  via ``solver_settings``. Its ``f_fx_fu_fn`` is the port's callback
  (`dynamics.make_f_fx_fu_fn` over a torch step function).
"""

from __future__ import annotations

from collections.abc import Mapping
from copy import copy
from typing import Dict, Tuple
from warnings import warn

import numpy as np

# field name -> symbolic trailing dims (leading particle dim M is optional everywhere)
DIM_MAP: Dict[str, Tuple[str, ...]] = {
    "Q": ("N", "xdim", "xdim"),
    "R": ("N", "udim", "udim"),
    "X_ref": ("N", "xdim"),
    "U_ref": ("N", "udim"),
    "X_prev": ("N", "xdim"),
    "U_prev": ("N", "udim"),
    "u_l": ("N", "udim"),
    "u_u": ("N", "udim"),
    "x_l": ("N", "xdim"),
    "x_u": ("N", "xdim"),
    "x0": ("xdim",),
}

_ARRAY_FIELDS = tuple(DIM_MAP.keys())


class Problem(Mapping):
    """An optimal-control problem spec with most fields defaulted.

    Examples:
        >>> p = Problem(N=20, xdim=4, udim=2)
        >>> p.x0 = np.ones(4)
        >>> p.f_fx_fu_fn = make_f_fx_fu_fn(step, device="cpu")
        >>> X, U, data = pmpc_tpu_torch.solve(**p, device="cpu")
    """

    def __init__(self, **kw):
        object.__setattr__(self, "_dims", self._infer_dims(**kw))
        object.__setattr__(self, "M", kw.get("M", None))
        self._set_defaults()
        for k, v in kw.items():
            if k in ("N", "xdim", "udim", "M"):
                continue
            if k.startswith("_"):
                warn(f"Cannot set private attribute {k}")
                continue
            setattr(self, k, v)
        self._tile_for_M()
        if not hasattr(self, "Nc"):
            self.Nc = 0

    # -- dimension bookkeeping -------------------------------------------------
    @staticmethod
    def _infer_dims(**kw) -> Dict[str, int]:
        dims = {k: int(v) for k, v in kw.items() if k in ("N", "xdim", "udim")}
        for field, names in DIM_MAP.items():
            if field in kw and kw[field] is not None:
                shape = np.asarray(kw[field]).shape
                # trailing dims of the value line up with the symbolic names
                for i in range(1, len(names) + 1):
                    if i <= len(shape):
                        dims.setdefault(names[-i], int(shape[-i]))
        for k in ("N", "xdim", "udim"):
            if k not in dims:
                raise ValueError(f"Missing dimension {k}")
        return dims

    @property
    def dims(self) -> Dict[str, int]:
        return copy(self._dims)

    @property
    def N(self) -> int:
        return self._dims["N"]

    @property
    def xdim(self) -> int:
        return self._dims["xdim"]

    @property
    def udim(self) -> int:
        return self._dims["udim"]

    # -- field assignment with shape checking ----------------------------------
    def __setattr__(self, k, v):
        if k in DIM_MAP:
            v = self._check_and_tile(k, v)
        object.__setattr__(self, k, v)
        if getattr(self, "_defaults_done", False):
            if k == "X_prev":
                object.__setattr__(self, "_xprev_user", True)
            elif k == "x0" and v is not None \
                    and not getattr(self, "_xprev_user", False):
                # reference parity (problem_struct.py:88-99): the default
                # X_prev is x0 tiled over the horizon, so setting x0 AFTER
                # construction must refresh it — the first linearization
                # then hovers at x0 instead of the all-zeros trajectory
                N = self._dims["N"]
                xp = np.repeat(np.asarray(v)[..., None, :], N, axis=-2)
                object.__setattr__(self, "X_prev", xp)

    def _check_and_tile(self, k, v):
        if v is None:
            return None
        v = np.asarray(v)
        correct = tuple(self._dims[name] for name in DIM_MAP[k])
        if self.M is not None:
            correct = (self.M,) + correct
        if v.shape != correct[-v.ndim :]:
            raise AssertionError(
                f"{k} has the wrong shape: got {v.shape}, expected trailing {correct[-v.ndim:]}"
            )
        return np.tile(v, correct[: -v.ndim] + (1,) * v.ndim)

    def _set_defaults(self):
        N, xdim, udim = self._dims["N"], self._dims["xdim"], self._dims["udim"]
        self.Q = np.tile(np.eye(xdim), (N, 1, 1))
        self.R = np.tile(1e-1 * np.eye(udim), (N, 1, 1))
        self.x0 = np.zeros(xdim)
        self.X_ref = np.zeros((N, xdim))
        self.U_ref = np.zeros((N, udim))
        # same as tiling the (zero) default x0 over the horizon
        self.X_prev = np.zeros((N, xdim))
        self.U_prev = np.zeros((N, udim))
        self.u_l, self.u_u, self.x_l, self.x_u = None, None, None, None
        self.solver_settings: Dict = dict()
        self.reg_x, self.reg_u = 1e0, 1e0
        self.max_it, self.res_tol, self.verbose = 30, 1e-6, True
        self.slew_rate = None
        self.P = None
        object.__setattr__(self, "_xprev_user", False)
        object.__setattr__(self, "_defaults_done", True)

    def _tile_for_M(self):
        if self.M is None:
            return
        for k in _ARRAY_FIELDS:
            v = getattr(self, k, None)
            if v is None:
                continue
            ndim = len(DIM_MAP[k])
            assert v.ndim in (ndim, ndim + 1)
            if v.ndim == ndim:
                object.__setattr__(self, k, np.tile(v, (self.M,) + (1,) * v.ndim))
        if getattr(self, "P", None) is not None:
            p = np.asarray(self.P)
            object.__setattr__(self, "P", p)

    # -- Mapping protocol ------------------------------------------------------
    def to_dict(self) -> Dict:
        keys = list(DIM_MAP.keys()) + [
            "solver_settings",
            "reg_x",
            "reg_u",
            "max_it",
            "res_tol",
            "verbose",
            "slew_rate",
            "P",
        ]
        problem = {k: getattr(self, k, None) for k in keys}
        if self.M is not None:
            ss = problem["solver_settings"]
            if "Nc" in ss and ss["Nc"] != self.Nc:
                warn(
                    "Nc specified in solver_settings, but Problem specifies Nc via a property."
                    f" We will use Nc = {self.Nc} from the Problem."
                )
            ss["Nc"] = self.Nc
        if hasattr(self, "f_fx_fu_fn"):
            problem["f_fx_fu_fn"] = self.f_fx_fu_fn
        else:
            warn("No dynamics function specified, please set `prob.f_fx_fu_fn`")
        for k in ("lin_cost_fn", "extra_cstrs_fns"):
            if hasattr(self, k):
                problem[k] = getattr(self, k)
        return problem

    def __iter__(self):
        return iter(self.to_dict().keys())

    def __getitem__(self, k):
        return self.to_dict()[k]

    def __len__(self):
        return len(self.to_dict())

    def __repr__(self):
        return f"Problem({self._dims}, M={self.M})"
