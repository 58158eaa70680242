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

Trials: params with a leading trial axis B (the chains of a sampler,
``bayes/predictive.py``) give cost (B,), each trial's value and gradient
its own 1-trial call's, as ``models/objective.py::loss_fn``.  X (N, D), y
and w stay shared: each block is copied to a contiguous (B, rows, D) inside
its checkpointed body (K1f and K1b refuse a stride-0 X), so the backward's
recompute makes the copy again and nothing of size N x B is kept.  One
batched block is one K1f (K1b) launch whatever B, so a batched streaming
gradient launches them as often as a 1-trial one.  The ``"kernel"`` route
takes no trial axis: K2f and K2b have none (ROADMAP.md Queue 2).

``mm_precision`` (``ops/dispatch.py``) sets the arithmetic of each
block's Gram on the ``"gemm"`` route and of each block's Φ·L⁻ᵀ on both
routes, with their backward GEMMs, as in ``loss_fn``
(``scfgp_tpu/ops/streaming.py:55-68``); K2f and K2b keep their own
arithmetic.  The JAX package's ``feature_impl`` is not carried: the
feature map is K1f and K1b on the card.  ``axis_name`` (a process
group) is: each rank streams its own rows, and pass 1's statistics and pass 2's row sums are
all-reduced over the group (``scfgp_tpu/ops/streaming.py:109-135``), on
either route.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.objective import (EPSILON, SufficientStats, LossAux,
                                expected_nll_rows, kl_penalty,
                                latent_moments, psum_stats, softplus,
                                solve_posterior, sufficient_stats,
                                value_and_grad)
from .collectives import psum
from ..models.params import SCFGPParams, derive_frequencies, feature_scale
from .gram import SufficientStatsFn
from .phi import FourierFeatures
from ..utils.profiling import setup_span, span

# stats_impl: "gemm" builds each block's Phi and takes its Gram by a matrix
# product (the JAX package's "xla"); "kernel" takes the Phi-free K2
# (the JAX package's "pallas").
STATS_IMPLS = ("gemm", "kernel")


def _checkpointed(fn, *args):
    # The process's first call imports what checkpointing needs (seconds).
    with setup_span("scfgp.setup.first_checkpoint", once=True):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)


class _Stream:
    """The row blocks of (X, y, w) and each block's features for params
    ``p``, per trial when ``p`` has a leading trial axis."""

    def __init__(self, p, X, y, w, block_size, stats_impl, basis_fn,
                 mm_precision=None):
        if stats_impl not in STATS_IMPLS:
            raise ValueError(f"stats_impl must be one of {STATS_IMPLS}, got "
                             f"{stats_impl!r}")
        if block_size < 1:
            raise ValueError(f"block_size must be positive, got "
                             f"{block_size}")
        if X.dim() != 2:
            raise ValueError(f"X must be (N, D), shared by the trials; got "
                             f"{tuple(X.shape)}")
        self.lead = tuple(p.a.shape)
        if self.lead and stats_impl == "kernel":
            raise NotImplementedError(
                "stats_impl='kernel' takes no trial axis: K2f and K2b have "
                "none (ROADMAP.md Queue 2); use stats_impl='gemm'")
        if stats_impl == "kernel" and basis_fn is not None:
            raise NotImplementedError(
                "basis_fn requires stats_impl='gemm' (the Phi-free Gram "
                "kernel has no extra-column slot)")
        self.X, self.y = X, y.reshape(-1)
        self.w = None if w is None else w.reshape(-1).to(X.dtype)
        self.basis_fn, self.stats_impl = basis_fn, stats_impl
        self.mm_precision = mm_precision
        # The JAX package pads the last block with zero-weight rows
        # (streaming.py:34-45); a shorter last block gives the same sums
        # and copies nothing (X may be gigabytes).
        self.blocks = [slice(i, i + block_size)
                       for i in range(0, X.shape[0], block_size)]
        # The frequencies are derived once, outside the blocks: the same
        # values as the JAX package's per-block derivation, for fewer host
        # launches.
        self.d = derive_frequencies(p)
        self.scale = feature_scale(p)

    def rows(self, b):
        return self.X[b], self.y[b], None if self.w is None else self.w[b]

    def trial(self, t):
        """A block's (rows,) or (rows, D) tensor for every trial: a view of
        y or w; X's block copied, since the kernels refuse a stride-0 X."""
        if not self.lead or t is None:
            return t
        if t.dim() == 2:
            with span("scfgp.stream.trial_copy",
                      bytes=math.prod(self.lead) * t.numel()
                      * t.element_size()):
                return t.expand(*self.lead, *t.shape).contiguous()
        return t.expand(*self.lead, -1)

    def span(self, what):
        """A span of this stream's pass or solve, with its route and
        size."""
        return span(f"scfgp.stream.{what}", route=self.stats_impl,
                    rows=self.X.shape[0], blocks=len(self.blocks))

    def features(self, Xi):
        """Phi of the 2-D block ``Xi``, (rows, 2K) or (B, rows, 2K)."""
        Phi = FourierFeatures.apply(self.trial(Xi), self.d.Fcat, self.d.pcat,
                                    self.scale)
        if self.basis_fn is None:
            return Phi
        basis = self.basis_fn(Xi).to(Phi.dtype)
        return torch.cat([Phi, basis.expand(*Phi.shape[:-1], -1)], dim=-1)

    def stats(self) -> SufficientStats:
        """Pass 1, summed in block order as the JAX package's scan sums."""
        if self.stats_impl == "kernel":
            def stats_block(Xi, yi, wi):
                return SufficientStatsFn.apply(Xi, yi, wi, self.d.Fcat,
                                               self.d.pcat, self.scale)
        else:
            def stats_block(Xi, yi, wi):
                return _checkpointed(
                    lambda Xi, yi, wi: tuple(sufficient_stats(
                        self.features(Xi), self.trial(yi), self.trial(wi),
                        mm_precision=self.mm_precision)),
                    Xi, yi, wi)
        stats = None
        for b in self.blocks:
            s = SufficientStats(*stats_block(*self.rows(b)))
            stats = s if stats is None else SufficientStats(
                *(a + c for a, c in zip(stats, s)))
        return stats


def streaming_posterior(p: SCFGPParams, X: torch.Tensor, y: torch.Tensor,
                        w: Optional[torch.Tensor] = None,
                        block_size: int = 4096, stats_impl: str = "gemm",
                        basis_fn=None):
    """``(stats, post)``: pass 1 and the solve of ``loss_fn_streaming``,
    the posterior a prediction needs, without pass 2."""
    st = _Stream(p, X, y, w, block_size, stats_impl, basis_fn)
    with st.span("pass1"):
        stats = st.stats()
    with st.span("solve"):
        return stats, solve_posterior(stats, torch.exp(2.0 * p.a))


def loss_fn_streaming(p: SCFGPParams, X: torch.Tensor, y: torch.Tensor,
                      w: Optional[torch.Tensor] = None,
                      block_size: int = 4096, stats_impl: str = "gemm",
                      basis_fn=None, residual_fit: bool = False,
                      axis_name=None, mm_precision=None):
    """``loss_fn`` with O(block_size) memory: ``(cost, LossAux)``.

    ``stats_impl="gemm"`` (the JAX package's ``"xla"``, the default) forms
    each block's Phi and its Gram by a matrix product; ``"kernel"`` (its
    ``"pallas"``) takes pass 1 through the Phi-free K2 (``ops/gram.py``),
    so no Phi exists in pass 1 even per block.  ``basis_fn`` appends fixed
    composite-model columns per block, as in ``loss_fn``; it needs
    ``"gemm"``, since K2 has no slot for extra columns.  ``residual_fit``
    takes the data-fit term as ``(Σ w (μ_f - y)² + (σ² + ε)‖α‖²) / σ²``,
    its rows summed in pass 2 (``objective.py::loss_from_phi``).  Params
    with a trial axis B give cost (B,) (module docstring).  With
    ``axis_name`` (a process group, such as ``mesh.group("data")``) ``X``,
    ``y`` and ``w`` are this rank's rows and every row sum is all-reduced over
    the group, as in ``loss_fn``.  ``mm_precision``: the arithmetic of pass
    1's Gram on the ``"gemm"`` route and of pass 2's Φ·L⁻ᵀ on both routes
    (``ops/dispatch.py``; the JAX package's takes no ``mm_dtype`` here)."""
    st = _Stream(p, X, y, w, block_size, stats_impl, basis_fn, mm_precision)
    sig2_n = torch.exp(2.0 * p.a)
    noise = softplus(p.c)
    with st.span("pass1"):
        stats = st.stats()
        if axis_name is not None:
            stats = psum_stats(stats, axis_name)
    with st.span("solve"):
        post = solve_posterior(stats, sig2_n)

    def enll_block(Xi, yi, wi):
        mu_f, var_f = latent_moments(st.features(Xi), post,
                                     mm_precision=mm_precision)
        yi, wi = st.trial(yi), st.trial(wi)
        e = expected_nll_rows(mu_f, var_f, yi, noise)
        r2 = (mu_f - yi) ** 2 if residual_fit else None
        if wi is not None:
            e = e * wi
            r2 = None if r2 is None else wi * r2
        return (torch.sum(e, dim=-1),
                torch.sum(r2, dim=-1) if residual_fit else e.new_zeros(()))

    enll_sum = r2_sum = 0.0
    with st.span("pass2"):
        for b in st.blocks:
            e, r2 = _checkpointed(enll_block, *st.rows(b))
            enll_sum, r2_sum = enll_sum + e, r2_sum + r2
        if axis_name is not None:
            enll_sum = psum(enll_sum, axis_name)
            if residual_fit:
                r2_sum = psum(r2_sum, axis_name)

    if residual_fit:
        fit = r2_sum + (sig2_n + EPSILON) * torch.sum(
            post.alpha * post.alpha, dim=-1)
    else:
        fit = stats.yTy - torch.sum(post.beta * post.beta, dim=-1)
    nlml = (2.0 * torch.sum(post.log_diag_L, dim=-1)
            + 2.0 * enll_sum
            + fit / sig2_n
            + 2.0 * (stats.n - p.M) * p.a)
    penalty = kl_penalty(p)
    cost = (nlml + penalty) / stats.n
    return cost, LossAux(post=post, nlml=nlml, penalty=penalty)


def loss_and_grad_streaming(p: SCFGPParams, X: torch.Tensor,
                            y: torch.Tensor, w: Optional[torch.Tensor] = None,
                            **kwargs):
    """``((cost, LossAux), grads)`` of ``loss_fn_streaming``: the step of
    ``experiments/tpu_streaming_1m.py:49-57`` without the optimizer; with
    ``axis_name`` the global gradient on every rank; ``mm_precision`` as
    there."""
    return value_and_grad(loss_fn_streaming, p, X, y, w=w, **kwargs)
