"""Blockwise streaming objective: N is never materialised at once.

Port of ``scfgp_tpu/ops/streaming.py:34-143``.  ``loss_fn`` materialises
Phi (N x 2(S+M)); at the N=1e6, D=256 configuration that is 2 GB, and with
its autograd residuals several times that.  This module computes the same
objective as two passes over row blocks (every N-dependent term is a row
sum, ``reference: SCFGP/SCFGP.py:104,108,122-126``):

  pass 1:  stats = sum over blocks of stats(Phi(X_b), y_b)   (the Gram)
  solve :  the posterior from the 2K x 2K system
  pass 2:  enll  = sum over blocks of enll(Phi(X_b), y_b; posterior)

Each block's Phi lives only inside its block, in both passes and in the
backward: a block body runs under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint``), so the backward recomputes it instead of
keeping it, or it goes through ``SufficientStatsFn``, which saves no Phi.
Peak memory is then O(block_size x 2K) whatever N.

The JAX package's TPU and mesh levers (``axis_name``, ``feature_impl``,
``mm_precision``) are not carried, as in the port's ``loss_fn``; data
parallel streaming waits for the port of ``parallel/``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.objective import (SufficientStats, LossAux, expected_nll_rows,
                                kl_penalty, latent_moments, softplus,
                                solve_posterior, sufficient_stats,
                                value_and_grad)
from ..models.params import SCFGPParams, derive_frequencies, feature_scale
from .gram import SufficientStatsFn
from .phi import FourierFeatures

# stats_impl: "gemm" builds each block's Phi and takes its Gram by a matrix
# product (the JAX package's "xla"); "kernel" takes the Phi-free K2
# (the JAX package's "pallas").
STATS_IMPLS = ("gemm", "kernel")


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def loss_fn_streaming(p: SCFGPParams, X: torch.Tensor, y: torch.Tensor,
                      w: Optional[torch.Tensor] = None,
                      block_size: int = 4096, stats_impl: str = "gemm",
                      basis_fn=None):
    """``loss_fn`` with O(block_size) memory: ``(cost, LossAux)``.

    ``stats_impl="gemm"`` (the JAX package's ``"xla"``, the default) forms
    each block's Phi and its Gram by a matrix product; ``"kernel"`` (its
    ``"pallas"``) takes pass 1 through the Phi-free K2 (``ops/gram.py``),
    so no Phi exists in pass 1 even per block.  ``basis_fn`` appends fixed
    composite-model columns per block, as in ``loss_fn``; it needs
    ``"gemm"``, since K2 has no slot for extra columns."""
    if stats_impl not in STATS_IMPLS:
        raise ValueError(f"stats_impl must be one of {STATS_IMPLS}, got "
                         f"{stats_impl!r}")
    if block_size < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    y = y.reshape(-1)
    if w is not None:
        w = w.reshape(-1).to(X.dtype)
    sig2_n = torch.exp(2.0 * p.a)
    noise = softplus(p.c)
    # The JAX package pads the last block with zero-weight rows
    # (streaming.py:34-45); a shorter last block gives the same sums and
    # copies nothing (X may be gigabytes).
    blocks = [slice(i, i + block_size) for i in range(0, X.shape[0],
                                                      block_size)]

    def rows(b):
        return X[b], y[b], None if w is None else w[b]

    # The frequencies are derived once, outside the blocks: the same values
    # as the JAX package's per-block derivation, for fewer host launches.
    d = derive_frequencies(p)
    scale = feature_scale(p)

    def features(Xi):
        Phi = FourierFeatures.apply(Xi, d.Fcat, d.pcat, scale)
        if basis_fn is None:
            return Phi
        return torch.cat([Phi, basis_fn(Xi).to(Phi.dtype)], dim=1)

    if stats_impl == "kernel":
        if basis_fn is not None:
            raise NotImplementedError(
                "basis_fn requires stats_impl='gemm' (the Phi-free Gram "
                "kernel has no extra-column slot)")

        def stats_block(Xi, yi, wi):
            return SufficientStatsFn.apply(Xi, yi, wi, d.Fcat, d.pcat, scale)
    else:
        def stats_block(Xi, yi, wi):
            return _checkpointed(
                lambda Xi, yi, wi: tuple(sufficient_stats(features(Xi), yi,
                                                          wi)), Xi, yi, wi)

    # Pass 1, summed in block order as the JAX package's scan sums.
    stats = None
    for b in blocks:
        s = SufficientStats(*stats_block(*rows(b)))
        stats = s if stats is None else SufficientStats(
            *(a + c for a, c in zip(stats, s)))
    post = solve_posterior(stats, sig2_n)

    def enll_block(Xi, yi, wi):
        mu_f, var_f = latent_moments(features(Xi), post)
        e = expected_nll_rows(mu_f, var_f, yi, noise)
        return torch.sum(e if wi is None else e * wi)

    enll_sum = 0.0
    for b in blocks:
        enll_sum = enll_sum + _checkpointed(enll_block, *rows(b))

    nlml = (2.0 * torch.sum(post.log_diag_L)
            + 2.0 * enll_sum
            + (stats.yTy - torch.sum(post.beta * post.beta)) / sig2_n
            + 2.0 * (stats.n - p.M) * p.a)
    penalty = kl_penalty(p)
    cost = (nlml + penalty) / stats.n
    return cost, LossAux(post=post, nlml=nlml, penalty=penalty)


def loss_and_grad_streaming(p: SCFGPParams, X: torch.Tensor,
                            y: torch.Tensor, w: Optional[torch.Tensor] = None,
                            **kwargs):
    """``((cost, LossAux), grads)`` of ``loss_fn_streaming``: the step of
    ``experiments/tpu_streaming_1m.py:49-57`` without the optimizer."""
    return value_and_grad(loss_fn_streaming, p, X, y, w=w, **kwargs)
