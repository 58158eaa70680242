"""Exact ARD-RBF Gaussian process, the floor-verification baseline.

Port of ``scfgp_tpu/baselines/exact_gp.py:27-136``: a plain O(N³) GP with
an ARD squared-exponential kernel whose hyperparameters (per-dimension log
length-scales, signal, noise) are fitted by 200 steps of adam on the exact
negative log marginal likelihood.  It is not part of the SCFGP model (the
reference has no exact GP); it certifies that the surrogates' Bayes floors
(``data/datasets.py::surrogate_floor``) are reachable by a real predictor.

Float64 throughout, as under the JAX tests' x64, on an explicit torch
device; the N x N Cholesky and triangular solves are torch's (XLA's in the
JAX package, outside any Pallas kernel), and the gradient is autograd's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class GPParams(NamedTuple):
    log_ls: torch.Tensor  # (D,) ARD log length-scales
    log_sf: torch.Tensor  # ()  log signal std
    log_sn: torch.Tensor  # ()  log noise std


def _sqdist(Xa, Xb, ls):
    A = Xa / ls[None, :]
    B = Xb / ls[None, :]
    d = (torch.sum(A * A, 1)[:, None] + torch.sum(B * B, 1)[None, :]
         - 2.0 * A @ B.T)
    return torch.clamp(d, min=0.0)


def _kernel(Xa, Xb, p: GPParams):
    ls = torch.exp(p.log_ls)
    sf2 = torch.exp(2.0 * p.log_sf)
    return sf2 * torch.exp(-0.5 * _sqdist(Xa, Xb, ls))


def _chol_K(p: GPParams, X):
    n = X.shape[0]
    K = _kernel(X, X, p) + (torch.exp(2.0 * p.log_sn) + 1e-6) * torch.eye(
        n, dtype=X.dtype, device=X.device)
    # No error check (and no host sync): a matrix that is not positive
    # definite gives a non-finite loss, as JAX's cholesky does.
    return torch.linalg.cholesky_ex(K).L


def _nlml(p: GPParams, X, y):
    n = X.shape[0]
    L = _chol_K(p, X)
    a = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return (0.5 * torch.sum(a * a) + torch.sum(torch.log(torch.diagonal(L)))
            + 0.5 * n * math.log(2.0 * math.pi))


def _fit(X, y, steps: int = 200, lr: float = 0.05, init_log_ls: float = 0.0):
    """``steps`` adam steps from the JAX package's init; returns the params
    and the loss before each step, (steps,)."""
    D = X.shape[1]
    kw = dict(dtype=X.dtype, device=X.device)
    p = GPParams(log_ls=torch.full((D,), init_log_ls, **kw),
                 log_sf=torch.zeros((), **kw),
                 log_sn=torch.tensor(-1.0, **kw))
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses = []
    for t in range(1, steps + 1):
        leaves = [t_.detach().requires_grad_() for t_ in p]
        with torch.enable_grad():
            loss = _nlml(GPParams(*leaves), X, y)
            g = torch.autograd.grad(loss, leaves)
        m = [0.9 * m_ + 0.1 * g_ for m_, g_ in zip(m, g)]
        v = [0.999 * v_ + 0.001 * g_ * g_ for v_, g_ in zip(v, g)]
        a_t = lr * math.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        p = GPParams(*(p_ - a_t * m_ / (torch.sqrt(v_) + 1e-8)
                       for p_, m_, v_ in zip(p, m, v)))
        losses.append(loss.detach())
    return p, torch.stack(losses)


@torch.no_grad()
def _predict(p: GPParams, X, y, Xs):
    L = _chol_K(p, X)
    Ks = _kernel(X, Xs, p)
    a = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    mu = V.T @ a
    var = (torch.exp(2.0 * p.log_sf) - torch.sum(V * V, dim=0)
           + torch.exp(2.0 * p.log_sn))
    return mu, torch.sqrt(torch.clamp(var, min=1e-12))


class ExactGP:
    """z-scored exact ARD-RBF GP: ``fit(X, y)``, then ``predict(Xs)`` in
    original units.  Deliberately minimal: a measurement instrument, not a
    model family of this package."""

    def __init__(self, steps: int = 200, lr: float = 0.05, device="cuda"):
        self.steps, self.lr = steps, lr
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExactGP(device=%r): CUDA is not available "
                               "on this machine" % str(device))

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64).reshape(-1)
        self._xm, self._xs = X.mean(0), X.std(0) + 1e-12
        self._ym, self._ys = y.mean(), y.std() + 1e-12
        self._X = self._tensor((X - self._xm) / self._xs)
        self._y = self._tensor((y - self._ym) / self._ys)
        # Two length-scale inits (unit and wide): the ML-II surface has
        # local optima; keep the lower final NLML.
        best = None
        for ls0 in (0.0, 1.5):
            p, hist = _fit(self._X, self._y, self.steps, self.lr, ls0)
            if best is None or float(hist[-1]) < best[1]:
                best = ((p, hist), float(hist[-1]))
        self.params, self.nlml_history = best[0]
        return self

    def predict(self, Xs):
        Xs = self._tensor((np.asarray(Xs, np.float64) - self._xm) / self._xs)
        mu, std = _predict(self.params, self._X, self._y, Xs)
        return (mu.cpu().numpy() * self._ys + self._ym,
                std.cpu().numpy() * self._ys)


def exact_gp_fit_predict(Xt, yt, Xv, steps: int = 200, lr: float = 0.05,
                         device="cuda"):
    """One-shot helper: (mu, std) at ``Xv`` in original units."""
    gp = ExactGP(steps=steps, lr=lr, device=device).fit(Xt, yt)
    return gp.predict(Xv)
