"""Gauss-Hermite quadrature of the expected negative log-likelihood.

Port of ``scfgp_tpu/ops/quadrature.py:19-43``.  The reference computes the
expected NLL with a 30-node Gauss-Hermite rule (``reference:
SCFGP/SCFGP.py:118-124``); the objective uses its exact closed form
(``models/objective.py::expected_nll_rows``).  This module keeps the
literal rule for the golden parity tests; no default path calls it.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def hermgauss(n: int = 30):
    """Nodes and probabilist-normalised weights (w / sqrt(pi)), NumPy
    host constants, as the JAX package takes them."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return x, w / np.sqrt(np.pi)


def expected_nll_rows_gh(mu_f: torch.Tensor, var_f: torch.Tensor,
                         y: torch.Tensor, noise, n_nodes: int = 30):
    """``E_{f~N(mu, var)}[nll(f, y)]`` per row through an (N, n_nodes)
    node tensor, the reference's quadrature term by term.  Equal to the
    closed form up to quadrature round-off: the integrand is quadratic in
    f, so a rule of two or more nodes is exact in real arithmetic."""
    x, w = hermgauss(n_nodes)
    x = torch.as_tensor(x, dtype=mu_f.dtype, device=mu_f.device)[None, :]
    w = torch.as_tensor(w, dtype=mu_f.dtype, device=mu_f.device)[None, :]
    y = y.reshape(-1, 1)
    mu = mu_f.reshape(-1, 1)
    var = var_f.reshape(-1, 1)
    dsp = noise * (var + 1.0)
    herm_f = torch.sqrt(2.0 * var) * x + mu
    nlk = ((0.5 * herm_f ** 2 - y * herm_f) / dsp
           + 0.5 * (torch.log(2.0 * math.pi * dsp) + y ** 2 / dsp))
    return torch.sum(w * nlk, dim=1)
