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
backward.  A block is a ``torch.autograd.Function`` with a backward
written by hand (the JAX package's ``jax.checkpoint`` does this by
rerunning the block), or ``SufficientStatsFn`` (pass 1 on the
``"kernel"`` route).  A block saves its rows of X, y and w (views), the
feature map's inputs Fcat, pcat and s, and in pass 2 the posterior's Li and
α and the noise: never Phi, never Φ·L⁻ᵀ.  Its backward recomputes Phi by
one feature-map forward (K1f on the card) and goes straight to the
cotangent of Phi, which one feature-map backward (K1b) takes:

  pass 1 ("gemm"):  dPhi = w ⊙ (Phi (C̄ + C̄ᵀ) + y p̄ᵀ), from the
                    cotangents C̄ of ΦᵀΦ and p̄ of Φᵀy: one row-sized
                    product (K2b's algebra, ``ops/gram.py``); the Gram is
                    not formed again;
  pass 2:           A = Phi Liᵀ formed again (the variance needs it); with
                    each row's v = ‖A‖², μ = Phi α and the closed-form
                    derivatives of the expected NLL, g (of v) and h (of
                    μ): dA = 2g ⊙ A, dLi = dAᵀ Phi, dPhi = dA Li + h αᵀ,
                    dα = Phiᵀ h, and the noise's sum: three row-sized
                    products.

Peak memory is then O(block_size x 2K) whatever N.  The variance keeps
the Li form: Liᵀ Li would square the system's condition number in
float32.

Trials: params with a leading trial axis B (the chains of a sampler,
``bayes/predictive.py``) give cost (B,), each trial's value and gradient
its own 1-trial call's, as ``models/objective.py::loss_fn``.  X (N, D), y
and w stay shared: each block is copied to a contiguous (B, rows, D) for
the feature map (K1f and K1b refuse a stride-0 X), in the forward and
again in the backward's recompute, so nothing of size N x B is kept.
One batched block is one K1f (K1b) launch whatever B, so a batched
streaming gradient launches them as often as a 1-trial one.  The
``"kernel"`` route takes no trial axis: K2f and K2b have none (ROADMAP.md
Queue 2).

``mm_precision`` (``ops/dispatch.py``) sets the arithmetic of each
block's Gram on the ``"gemm"`` route and of each block's Φ·L⁻ᵀ on both
routes, and of the row-sized products of their backwards, as in
``loss_fn`` (``scfgp_tpu/ops/streaming.py:55-68``); the rank-one terms
and the GEMVs take the process-wide setting, as autograd's do there; K2f
and K2b keep their own arithmetic.  The JAX package's ``feature_impl``
is not carried: the feature map is K1f and K1b on the card.
``axis_name`` (a process group) is: each rank streams its own rows, and
pass 1's statistics and pass 2's row sums are all-reduced over the group
(``scfgp_tpu/ops/streaming.py:109-135``), outside the blocks, on either
route.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..models.objective import (EPSILON, SufficientStats, LossAux, _gemm,
                                _mv, _trial, expected_nll_rows, kl_penalty,
                                psum_stats, softplus, solve_posterior,
                                sufficient_stats, value_and_grad)
from .collectives import psum
from .dispatch import matmul_tf32, uses_tf32
from ..models.params import SCFGPParams, derive_frequencies, feature_scale
from .gram import SufficientStatsFn
from .phi import FourierFeatures, phi_bwd, phi_fwd_op
from ..utils.profiling import span

# stats_impl: "gemm" builds each block's Phi and takes its Gram by a matrix
# product (the JAX package's "xla"); "kernel" takes the Phi-free K2
# (the JAX package's "pallas").
STATS_IMPLS = ("gemm", "kernel")


def _precision(mm_precision):
    """The scope of a row-sized product of the backward: the TF32 switch
    of ``models/objective.py::_PrecisionDot`` for an explicit precision,
    else the process-wide setting."""
    if mm_precision is None:
        return contextlib.nullcontext()
    return matmul_tf32(uses_tf32(mm_precision))


def _add_outer_(G, u, v):
    """``G += u vᵀ`` in place, per trial with a leading trial axis."""
    if G.dim() == 2:
        return G.addr_(u, v)
    return G.baddbmm_(u.unsqueeze(-1), v.unsqueeze(-2))


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
        """A block's rows of X, y and w, and the feature map's inputs."""
        return (self.X[b], self.y[b], None if self.w is None else self.w[b],
                self.d.Fcat, self.d.pcat, self.scale)

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

    def block_backward(self, pass_, Xi):
        """The span of one block's hand-written backward."""
        return span("scfgp.stream.block_backward", pass_=pass_,
                    route=self.stats_impl, trials=math.prod(self.lead),
                    rows=Xi.shape[0])

    def features(self, Xt, Xi, Fcat, pcat, scale, feature_map):
        """Phi (rows, 2K) or (B, rows, 2K) of the block ``Xi`` from its
        trial copy ``Xt`` by ``feature_map``, with the ``basis_fn``
        columns."""
        Phi = feature_map(Xt, Fcat, pcat, scale)
        if self.basis_fn is None:
            return Phi
        basis = self.basis_fn(Xi).to(Phi.dtype)
        return torch.cat([Phi, basis.expand(*Phi.shape[:-1], -1)], dim=-1)

    def stats_block(self, Xi, yi, wi, Fcat, pcat, scale):
        """Pass 1's block on the "gemm" route, differentiable by autograd:
        the forward of ``_StatsBlock``."""
        Phi = self.features(self.trial(Xi), Xi, Fcat, pcat, scale,
                            FourierFeatures.apply)
        return tuple(sufficient_stats(Phi, self.trial(yi), self.trial(wi),
                                      mm_precision=self.mm_precision))

    def enll_block(self, Xi, yi, wi, Fcat, pcat, scale, Li, alpha, noise,
                   residual_fit):
        """Pass 2's block, differentiable by autograd: the forward of
        ``_EnllBlock``, ``(Σ w e, Σ w r²)`` over its rows (the second 0
        without ``residual_fit``)."""
        Phi = self.features(self.trial(Xi), Xi, Fcat, pcat, scale,
                            FourierFeatures.apply)
        # latent_moments, from the posterior's Li and α.
        PhiLiT = _gemm(Phi, Li.mT, mm_precision=self.mm_precision)
        mu_f, var_f = _mv(Phi, alpha), torch.sum(PhiLiT * PhiLiT, dim=-1)
        yi, wi = self.trial(yi), self.trial(wi)
        e = expected_nll_rows(mu_f, var_f, yi, noise)
        r2 = (mu_f - yi) ** 2 if residual_fit else None
        if wi is not None:
            e = e * wi
            r2 = None if r2 is None else wi * r2
        return (torch.sum(e, dim=-1),
                torch.sum(r2, dim=-1) if residual_fit else e.new_zeros(()))

    def stats(self) -> SufficientStats:
        """Pass 1, summed in block order as the JAX package's scan sums."""
        if self.stats_impl == "kernel":
            stats_block = SufficientStatsFn.apply
        else:
            def stats_block(*rows):
                return _StatsBlock.apply(self, *rows)
        stats = None
        for b in self.blocks:
            s = SufficientStats(*stats_block(*self.rows(b)))
            stats = s if stats is None else SufficientStats(
                *(a + c for a, c in zip(stats, s)))
        return stats


class _StatsBlock(torch.autograd.Function):
    """Pass 1's block on the "gemm" route: ``_Stream.stats_block``'s
    numbers; the backward recomputes Phi and takes its cotangent in one
    product (module docstring).  X, y and w are data: no gradient; nor
    yᵀy and n, which do not depend on the params."""

    @staticmethod
    def forward(ctx, st, Xi, yi, wi, Fcat, pcat, scale):
        ctx.st = st
        ctx.save_for_backward(Xi, yi, wi, Fcat, pcat, scale)
        stats = st.stats_block(Xi, yi, wi, Fcat, pcat, scale)
        ctx.mark_non_differentiable(*stats[2:])
        return stats

    @staticmethod
    @once_differentiable
    def backward(ctx, cbar, pbar, _ybar, _nbar):
        st = ctx.st
        Xi, yi, wi, Fcat, pcat, scale = ctx.saved_tensors
        k2 = 2 * Fcat.shape[-1]
        with st.block_backward(1, Xi):
            Xt = st.trial(Xi)
            Phi = st.features(Xt, Xi, Fcat, pcat, scale, phi_fwd_op)
            # The basis columns get no cotangent: only Phi's own 2K.
            with _precision(st.mm_precision):
                G = Phi @ (cbar + cbar.mT)[..., :k2]
            del Phi
            _add_outer_(G, st.trial(yi), pbar[..., :k2])
            if wi is not None:
                G.mul_(st.trial(wi).unsqueeze(-1))
            dF, dp, ds = phi_bwd(Xt, Fcat, pcat, scale, G)
        return None, None, None, None, dF, dp, ds.reshape(scale.shape)


class _EnllBlock(torch.autograd.Function):
    """Pass 2's block on either route: ``_Stream.enll_block``'s numbers;
    the backward recomputes Phi and Φ·L⁻ᵀ, and forms the rows' cotangents
    in closed form from those of the two sums (module docstring)."""

    @staticmethod
    def forward(ctx, st, residual_fit, Xi, yi, wi, Fcat, pcat, scale, Li,
                alpha, noise):
        ctx.st, ctx.residual_fit = st, residual_fit
        ctx.save_for_backward(Xi, yi, wi, Fcat, pcat, scale, Li, alpha,
                              noise)
        return st.enll_block(Xi, yi, wi, Fcat, pcat, scale, Li, alpha,
                             noise, residual_fit)

    @staticmethod
    @once_differentiable
    def backward(ctx, ebar, rbar):
        st = ctx.st
        Xi, yi, wi, Fcat, pcat, scale, Li, alpha, noise = ctx.saved_tensors
        k2 = 2 * Fcat.shape[-1]
        with st.block_backward(2, Xi):
            Xt, yt, wt = st.trial(Xi), st.trial(yi), st.trial(wi)
            Phi = st.features(Xt, Xi, Fcat, pcat, scale, phi_fwd_op)
            with _precision(st.mm_precision):
                A = Phi @ Li.mT
            v = torch.linalg.vector_norm(A, dim=-1).square()
            r = _mv(Phi, alpha) - yt
            # e = (r²/2 + v/2) / dsp + log(2π dsp) / 2, dsp = noise (v + 1):
            # ∂e/∂v = 1/(2 dsp) + (1/2 - q)/(v + 1), ∂e/∂μ = r / dsp and
            # ∂e/∂noise = (1/2 - q) / noise, with q the first term.
            dsp = _trial(noise) * (v + 1.0)
            q = (0.5 * r * r + 0.5 * v) / dsp
            eb = _trial(ebar) if wt is None else _trial(ebar) * wt
            g = eb * (0.5 / dsp + (0.5 - q) / (v + 1.0))
            h = eb * r / dsp
            if ctx.residual_fit:
                h = h + 2.0 * _trial(rbar) * (r if wt is None else wt * r)
            dnoise = torch.sum(eb * (0.5 - q), dim=-1) / noise
            dA = A.mul_((2.0 * g).unsqueeze(-1))
            with _precision(st.mm_precision):
                dLi = dA.mT @ Phi
                dPhi = dA @ Li[..., :k2]
            del A, dA
            _add_outer_(dPhi, h, alpha[..., :k2])
            dalpha = _mv(Phi.mT, h)
            del Phi
            dF, dp, ds = phi_bwd(Xt, Fcat, pcat, scale, dPhi)
        return (None, None, None, None, None, dF, dp, ds.reshape(scale.shape),
                dLi, dalpha, dnoise.reshape(noise.shape))


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

    enll_sum = r2_sum = 0.0
    with st.span("pass2"):
        for b in st.blocks:
            e, r2 = _EnllBlock.apply(st, residual_fit, *st.rows(b), post.Li,
                                     post.alpha, noise)
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
