"""Feature-axis tensor parallelism: the objective on a 2-D (data, feature)
mesh.

Port of ``scfgp_tpu/parallel/tp.py``.  Rows of (X, y) are split over
``data`` (as in ``dp.py``) and the S+M projection columns over
``feature``, so every O(N K) and O(N K²) tensor (Phi, the Gram, the
latent-moment products; K = 2(S+M)) is computed in column strips.  On the
rank at (d, f), with c = (S+M) / n_feature columns of its own:

  1. the strip ``s·[cos T | sin T]`` of its columns, T = X_d Fcat[:, f c:
     (f+1) c] + pcat[f c:(f+1) c]: exactly the feature map on (Floc, ploc),
     so it runs through ``ops/phi.py::FourierFeatures`` (K1f, and K1b in
     the backward, on the card);
  2. the full-width Phi rows gathered over ``feature`` (column order
     ``[cos_1..cos_{S+M} | sin_1..sin_{S+M}]``, as the reference's), then
     its (K, 2c) block-columns ``Phiᵀ (w Phi_strip)`` scattered into a zero
     (K, K) buffer and all-reduced over both axes into the Gram;
  3. the posterior solve, replicated;
  4. the latent moments: ``mu_f`` from the strip against its slices of
     alpha, summed over ``feature``; ``var_f = rowsum((Phi Liᵀ)²)`` over
     its 2c-column block of Liᵀ (any column partition sums the same
     squares), summed over ``feature``;
  5. the row sums (expected NLL, yᵀy, n), all-reduced over ``data`` only:
     they are the same on every rank of a ``feature`` group.

Every collective is differentiable (``ops/collectives.py``: the gather's
backward a reduce-scatter, an all-reduce's an all-reduce), and the cost,
the same on every rank of the mesh, is differentiated with the mesh as
its replicas, so the gradient is the single-device one to rounding.

Requires ``(S + M) % n_feature == 0`` (feature padding would change the
model: M enters the feature scale and the nlml, ``SCFGP.py:102,125``).
"""

from __future__ import annotations

import torch

from ..models.objective import (LossAux, SufficientStats, expected_nll_rows,
                                kl_penalty, softplus, solve_posterior,
                                value_and_grad)
from ..models.params import SCFGPParams, derive_frequencies, feature_scale
from ..ops.collectives import all_gather, psum
from ..ops.phi import FourierFeatures
from ..opt.optimizers import Transform, tree_add
from .mesh import DATA_AXIS, FEATURE_AXIS, Mesh, shard_rows


def _loss_local(params: SCFGPParams, X, y, w, *, n_feature: int,
                f_idx: int, data_group, feature_group):
    """This rank's part of the objective (module docstring, steps 1-5)."""
    y = y.reshape(-1)
    w = w.reshape(-1).to(X.dtype)
    SM = params.S + params.M
    if SM % n_feature:
        raise ValueError(f"S+M={SM} must be divisible by the feature-axis "
                         f"size {n_feature}")
    c = SM // n_feature
    off = f_idx * c
    K = 2 * SM
    sig2_n = torch.exp(2.0 * params.a)
    noise = softplus(params.c)
    d = derive_frequencies(params)

    # 1. this rank's strip [cos T | sin T] (N_d, 2c), through K1f/K1b.
    strip = FourierFeatures.apply(X, d.Fcat[:, off:off + c].contiguous(),
                                  d.pcat[off:off + c].contiguous(),
                                  feature_scale(params))
    cos_s, sin_s = strip[:, :c], strip[:, c:]

    # 2. Gram block-columns.
    Phi = torch.cat([all_gather(cos_s, feature_group, dim=1),
                     all_gather(sin_s, feature_group, dim=1)], dim=1)
    blocks = Phi.mT @ (strip * w[:, None])                  # (K, 2c)
    zero = Phi.new_zeros((K, off))
    A_part = torch.cat([zero, blocks[:, :c], Phi.new_zeros((K, SM - c)),
                        blocks[:, c:], Phi.new_zeros((K, SM - off - c))],
                       dim=1)
    wy = w * y
    py = torch.cat([Phi.new_zeros(off), cos_s.mT @ wy,
                    Phi.new_zeros(SM - c), sin_s.mT @ wy,
                    Phi.new_zeros(SM - off - c)])
    stats = SufficientStats(
        phiTphi=psum(psum(A_part, feature_group), data_group),
        phiTy=psum(psum(py, feature_group), data_group),
        yTy=psum(torch.sum(w * y * y), data_group),
        n=psum(torch.sum(w), data_group))

    # 3. replicated posterior solve.
    post = solve_posterior(stats, sig2_n)

    # 4. latent moments, split over features.
    mu_f = psum(cos_s @ post.alpha[off:off + c]
                + sin_s @ post.alpha[SM + off:SM + off + c], feature_group)
    PV = Phi @ post.Li.mT[:, 2 * off:2 * off + 2 * c]
    var_f = psum(torch.sum(PV * PV, dim=1), feature_group)

    # 5. nlml, penalty, cost (reference SCFGP.py:113-128).
    enll_sum = psum(torch.sum(expected_nll_rows(mu_f, var_f, y, noise) * w),
                    data_group)
    nlml = (2.0 * torch.sum(post.log_diag_L)
            + 2.0 * enll_sum
            + (stats.yTy - torch.sum(post.beta * post.beta)) / sig2_n
            + 2.0 * (stats.n - params.M) * params.a)
    penalty = kl_penalty(params)
    cost = (nlml + penalty) / stats.n
    return cost, LossAux(post=post, nlml=nlml, penalty=penalty)


def tp_loss(mesh: Mesh, data_axis: str = DATA_AXIS,
            feature_axis: str = FEATURE_AXIS):
    """``f(params, X, y, w) -> (cost, aux)`` over this rank's rows (split
    over ``data``, the same on every rank of a ``feature`` group), the
    outputs the same on every rank; differentiable."""
    data_group = mesh.group(data_axis)
    feature_group = mesh.group(feature_axis)
    n_feature, f_idx = mesh.shape[feature_axis], mesh.index(feature_axis)

    def f(params, X, y, w):
        return _loss_local(params, X, y, w, n_feature=n_feature, f_idx=f_idx,
                           data_group=data_group,
                           feature_group=feature_group)
    return f


def tp_loss_and_grad(mesh: Mesh, params, X, y, w,
                     data_axis: str = DATA_AXIS,
                     feature_axis: str = FEATURE_AXIS):
    """``((cost, aux), grads)`` of ``tp_loss``: the global gradient, the
    same on every rank of the mesh."""
    f = tp_loss(mesh, data_axis, feature_axis)
    return value_and_grad(f, params, X, y, w, replicas=mesh.world)


def make_tp_train_step(tx: Transform, mesh: Mesh,
                       data_axis: str = DATA_AXIS,
                       feature_axis: str = FEATURE_AXIS):
    """``step(params, opt_state, X, y, w) -> (params, opt_state, cost)``:
    the 2-D-parallel loss, gradient and optimizer update."""
    def step(params, opt_state, X, y, w):
        (cost, _), grads = tp_loss_and_grad(mesh, params, X, y, w,
                                            data_axis, feature_axis)
        delta, opt_state = tx.update(grads, opt_state, params)
        return tree_add(params, delta), opt_state, cost
    return step


def shard_rows_2d(mesh: Mesh, X, y, w=None, data_axis: str = DATA_AXIS,
                  device="cuda"):
    """This rank's rows: split over ``data``, the same on every rank of a
    ``feature`` group (``mesh.py::shard_rows`` along ``data_axis``)."""
    return shard_rows(mesh, X, y, w, axis_name=data_axis, device=device)
