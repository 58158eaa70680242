"""Data scaling with automatic Box-Cox skew removal and Gaussian-CDF maps.

Port of ``scfgp_tpu/data/scaler.py``, which re-implements the reference's
five scaling algorithms (``reference: SCFGP/Scaler.py:15-21``):

  * ``min-max``         affine map to [0, 1]                  (Scaler.py:43-45)
  * ``normal``          z-score                               (Scaler.py:46-48)
  * ``inv-normal``      Gaussian CDF of the z-score           (Scaler.py:49-51)
  * ``auto-normal``     min-max -> per-column Box-Cox, lambda by SLSQP
                        skewness minimisation -> z-score       (Scaler.py:52-74)
  * ``auto-inv-normal`` the same, ending in a Gaussian CDF     (Scaler.py:75-97)

Constant columns are dropped at fit time (``Scaler.py:40-41``).  The fit is
host-side NumPy/SciPy in float64; the transforms are torch functions of the
fitted state and run on the device of their input (``Scaler.to`` moves the
state).  ``compat_reference=True`` reproduces the reference's ``inv-normal``
backward transform, which is not the inverse of its forward
(``Scaler.py:106`` vs ``:125``).  ``native=True`` fits the Box-Cox lambdas
with the C++ fitter (``data/native.py``), and with SciPy where that library
cannot be built, as in the JAX package (``scfgp_tpu/data/scaler.py:126-129``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from scipy.optimize import minimize
from scipy.stats import skew

ALGOS = ("min-max", "normal", "inv-normal", "auto-normal", "auto-inv-normal")


def _boxcox(x, lm):
    """Signed Box-Cox transform, reference form (``Scaler.py:56``); works on
    NumPy arrays and on tensors."""
    if isinstance(x, torch.Tensor):
        return (torch.sign(x) * torch.abs(x) ** lm - 1.0) / lm
    return (np.sign(x) * np.abs(x) ** lm - 1.0) / lm


def _inv_boxcox(x, lm):
    """Inverse of the signed Box-Cox transform (``Scaler.py:128``)."""
    z = x * lm + 1.0
    return torch.sign(z) * torch.abs(z) ** (1.0 / lm)


def _fit_boxcox_lambdas(tX: np.ndarray) -> np.ndarray:
    """Per-column skewness-minimising Box-Cox lambda via SLSQP
    (``Scaler.py:56-70``): lambda = softplus(raw), raw in [-5, 5]; columns
    with fewer than 10 distinct values keep lambda = 1."""
    lams = np.zeros(tX.shape[1])
    for d in range(tX.shape[1]):
        Xd = tX[:, d]
        if np.unique(Xd).shape[0] < 10:
            lams[d] = 1.0
            continue
        t_lm = lambda lm: np.log(np.exp(lm[0]) + 1.0)
        bc = lambda lm: (np.sign(Xd) * np.abs(Xd) ** t_lm(lm) - 1.0) / t_lm(lm)
        obj = lambda lm: skew(bc(lm), bias=False) ** 2
        res = minimize(obj, [0.0], method="SLSQP", bounds=[(-5, 5)],
                       options={"ftol": 1e-8, "maxiter": 100, "disp": False})
        lams[d] = t_lm(res["x"])
    return lams


def _as_2d(X) -> torch.Tensor:
    X = torch.as_tensor(X)
    if not X.is_floating_point():
        X = X.to(torch.float64)
    return X[:, None] if X.dim() == 1 else X


@dataclass
class Scaler:
    """Fit on the host once; transform on the device of the input."""

    algo: str
    compat_reference: bool = False
    native: bool = False
    cols: Optional[np.ndarray] = None          # surviving column indices
    state: dict = field(default_factory=dict)  # tensors keyed by name

    def __post_init__(self):
        algo = self.algo.lower()
        if algo not in ALGOS:
            raise ValueError(f"Invalid scaling algorithm {self.algo!r}")
        self.algo = algo

    def to(self, device) -> "Scaler":
        """Move the fitted state to ``device``; returns self."""
        self.state = {k: v.to(device) for k, v in self.state.items()}
        return self

    # -- fitting (host, float64) --------------------------------------------

    def fit(self, X) -> "Scaler":
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[:, None]
        const = np.all(X == X[0, :], axis=0)
        self.cols = np.where(~const)[0]
        tX = X[:, self.cols]
        s = {}
        if self.algo == "min-max":
            s["min"] = tX.min(axis=0)
            s["max"] = tX.max(axis=0)
        elif self.algo in ("normal", "inv-normal"):
            s["mu"] = tX.mean(axis=0)
            s["std"] = tX.std(axis=0)
        else:  # auto-normal / auto-inv-normal
            s["min"] = tX.min(axis=0)
            s["max"] = tX.max(axis=0)
            u = (tX - s["min"]) / (s["max"] - s["min"])
            lams = None
            if self.native:
                from .native import fit_boxcox_lambdas_native
                lams = fit_boxcox_lambdas_native(u)
            s["boxcox"] = lams if lams is not None else _fit_boxcox_lambdas(u)
            bu = _boxcox(u, s["boxcox"][None, :])
            s["mu"] = bu.mean(axis=0)
            s["std"] = bu.std(axis=0)
        self.state = {k: torch.as_tensor(v) for k, v in s.items()}
        return self

    # -- transforms (torch, on the input's device) ---------------------------

    def forward_transform(self, X) -> torch.Tensor:
        X = _as_2d(X)
        tX = X[:, torch.as_tensor(self.cols, device=X.device)]
        s = self.state
        if self.algo == "min-max":
            return (tX - s["min"]) / (s["max"] - s["min"])
        if self.algo == "normal":
            return (tX - s["mu"]) / s["std"]
        if self.algo == "inv-normal":
            return torch.special.ndtr((tX - s["mu"]) / s["std"])
        u = (tX - s["min"]) / (s["max"] - s["min"])
        bu = _boxcox(u, s["boxcox"][None, :])
        if self.algo == "auto-normal":
            return (bu - s["mu"]) / s["std"]
        # auto-inv-normal: norm.cdf(bu, mu, std)  (Scaler.py:116)
        return torch.special.ndtr((bu - s["mu"]) / s["std"])

    def backward_transform(self, X) -> torch.Tensor:
        X = _as_2d(X)
        if len(self.cols) != X.shape[1]:
            raise ValueError(f"Backward Transform Error: {X.shape[1]} "
                             f"columns, scaler has {len(self.cols)}")
        return backward_transform_stateless(self.algo, self.state, X,
                                            self.compat_reference)

    # -- persistence ---------------------------------------------------------

    def to_state_dict(self) -> dict:
        return {
            "algo": self.algo,
            "compat_reference": self.compat_reference,
            "cols": np.asarray(self.cols),
            "state": {k: v.cpu().numpy() for k, v in self.state.items()},
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "Scaler":
        sc = cls(d["algo"], compat_reference=d.get("compat_reference", False))
        sc.cols = np.asarray(d["cols"])
        sc.state = {k: torch.tensor(np.asarray(v))
                    for k, v in d["state"].items()}
        return sc


def backward_transform_stateless(algo: str, state: dict, X,
                                 compat_reference: bool = False):
    """Backward transform from the state tensors (``Scaler.py:118-135``);
    the same math as ``Scaler.backward_transform`` without the object."""
    s = state
    if algo == "min-max":
        return X * (s["max"] - s["min"]) + s["min"]
    if algo == "normal":
        return X * s["std"] + s["mu"]
    if algo == "inv-normal":
        if compat_reference:
            # Reference bug (Scaler.py:125): NOT the inverse of forward.
            return (torch.special.ndtri(X) - s["mu"]) / s["std"]
        return s["mu"] + s["std"] * torch.special.ndtri(X)
    if algo == "auto-normal":
        bu = X * s["std"] + s["mu"]
    else:  # auto-inv-normal: norm.ppf(X, mu, std)  (Scaler.py:134)
        bu = s["mu"] + s["std"] * torch.special.ndtri(X)
    u = _inv_boxcox(bu, s["boxcox"][None, :])
    return u * (s["max"] - s["min"]) + s["min"]
