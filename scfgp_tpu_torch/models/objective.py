"""SCFGP objective and its gradient: features, sufficient stats, posterior,
NLML.

Port of ``scfgp_tpu/models/objective.py:53-108, 174-243, 246-403``,
which re-derives the reference's Theano graph (``reference:
SCFGP/SCFGP.py:92-148``) as plain functions of tensors.  The same two
departures from the reference graph hold here:

1. the per-row expected NLL is the closed form of the reference's 30-node
   Gauss-Hermite rule (exact: the integrand is quadratic in f), and
2. ``Li = L⁻¹`` is materialised once by a triangular solve against the
   identity, so every N-sized quantity is a GEMM against ``Li``.

The feature map is ``ops/phi.py::FourierFeatures``: the CUDA kernels K1f
and K1b for a tensor on the card, their plain PyTorch versions for a tensor
on the CPU.  ``chol_and_inverse`` carries the JAX package's all-GEMM
backward, and ``loss_and_grad`` is ``jax.value_and_grad(loss_fn,
has_aux=True)``.  The reference quirks stay: the feature scale uses M, not S+M
(``SCFGP.py:102``), and the nlml carries ``2 (N - M) a``
(``SCFGP.py:125-126``).

Precision (``ops/dispatch.py``): the two O(N K²) GEMMs, the Gram ΦᵀΦ
(``sufficient_stats``) and Φ·L⁻ᵀ (``latent_moments``), and their backward
GEMMs go through ``_gemm``, which takes the JAX package's ``mm_dtype``
(bf16 operands, float32 products and sums: ``_ReducedDot``) and
``mm_precision`` (TF32 on the card for "default", IEEE otherwise:
``_PrecisionDot``); ``solve_posterior(mm_dtype=)`` scales the jitter to
the Gram's rounding, as ``scfgp_tpu/models/objective.py:246-270`` does.
Everything else stays IEEE float32.

Data parallelism: with ``axis_name`` (a process group, such as
``mesh.group("data")`` of a mesh of ``parallel/mesh.py``) ``loss_fn`` takes this rank's rows and
all-reduces the sufficient statistics and the expected-NLL row sum
(``scfgp_tpu/models/objective.py:361-372``) through the differentiable
collectives of ``ops/collectives.py``; ``value_and_grad`` then gives the
exact global gradient on every rank.

Trials: every function here also takes params, X and y (and a posterior)
with a leading trial axis B, the trials of a batched sweep
(``models/model.py::fit_fast_batch``; ``jax.vmap`` over ``loss_fn`` in the
JAX package).  Sums run per trial and a batched loss returns cost (B,);
trials share nothing, so the gradient of ``cost.sum()`` is each trial's
own gradient.  Scalars of a trial broadcast over its rows through
``_trial``, never against the row axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops.cholesky import chol_inverse_bwd, cholesky_inverse_ref
from ..ops.collectives import all_reduce_sum, axis_size, psum
from ..ops.dispatch import matmul_tf32, uses_tf32
from ..ops.phi import FourierFeatures
from ..utils.profiling import span
from .params import SCFGPParams, derive_frequencies, feature_scale

EPSILON = 1e-6  # jitter added to sig2_n, reference SCFGP.py:93,105


class SufficientStats(NamedTuple):
    """Row-sum statistics of the data; with per-row weights ``w`` (1 for real
    rows, 0 for padding) every field is a sum over rows
    (reference terms ``SCFGP.py:104,108,126``)."""

    phiTphi: torch.Tensor  # (2K, 2K) = Phiᵀ diag(w) Phi
    phiTy: torch.Tensor    # (2K,)    = Phiᵀ (w * y)
    yTy: torch.Tensor      # ()       = sum(w * y²)
    n: torch.Tensor        # ()       = sum(w)


class Posterior(NamedTuple):
    """Weight-space posterior of the 2K x 2K system (K = S + M); field
    order is the checkpoint's."""

    L: torch.Tensor           # chol(Phiᵀ Phi + (sig2_n + eps) I), lower
    Li: torch.Tensor          # L⁻¹
    alpha: torch.Tensor       # L⁻ᵀ L⁻¹ Phiᵀ y
    beta: torch.Tensor        # L⁻¹ Phiᵀ y
    log_diag_L: torch.Tensor  # log diag(L)


class LossAux(NamedTuple):
    post: Posterior
    nlml: torch.Tensor
    penalty: torch.Tensor


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ), the overflow-safe form ``jax.nn.softplus`` uses."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _trial(t: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """A per-trial value, () or (B,), with ``dims`` trailing axes of size 1
    so that it broadcasts over one trial's rows (or matrix)."""
    return t.reshape(t.shape + (1,) * dims)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` for a matrix and a vector, per trial with a trial axis."""
    if v.dim() == 1:
        return A @ v
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def fourier_features(p: SCFGPParams, X: torch.Tensor) -> torch.Tensor:
    """Feature map Phi (N, 2(S+M)) (``SCFGP.py:99-102``): one fused
    projection ``X @ [l_F | F]`` with mean-centred phases and scale
    ``sig_f * sqrt(2/M)``."""
    d = derive_frequencies(p)
    return FourierFeatures.apply(X, d.Fcat, d.pcat, feature_scale(p))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of reduced-precision operands as float32: on the card one
    cuBLAS tensor-core GEMM with float32 output (``aten::mm.dtype``,
    ``aten::bmm.dtype``; a missing overload raises), on the CPU the plain
    version, the operands upcast first (each product of two bf16 values is
    exact in float32, so it is the same function summed in another
    order).  A leading trial axis, the same on both operands, is a batched
    GEMM."""
    if not a.is_cuda:
        return a.float() @ b.float()
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


class _ReducedDot(torch.autograd.Function):
    """``a @ b`` with ``dtype`` operands and float32 products and sums, in
    the forward GEMM and both backward GEMMs; the result and the gradients
    in the operands' dtype (``_rp_dot`` with its custom VJP,
    ``scfgp_tpu/models/objective.py:112-139``).  The operands are saved
    already cast, and the cotangent is cast before the backward GEMMs."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        a16, b16 = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(a16, b16)
        ctx.dtype = dtype
        return _bmm_f32(a16, b16).to(a.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(ctx.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _bmm_f32(g16, b16.mT).to(g.dtype)
        if ctx.needs_input_grad[1]:
            db = _bmm_f32(a16.mT, g16).to(g.dtype)
        return da, db, None


class _PrecisionDot(torch.autograd.Function):
    """``a @ b`` with TF32 on (``tf32``) or off for this GEMM and for its two
    backward GEMMs, each direction setting the switch around its own GEMMs
    and restoring it after (``ops/dispatch.py::matmul_tf32``): the backward
    runs on autograd's thread, outside any scope around the forward call.
    The counterpart of the JAX dot's ``precision`` attribute, which its
    transpose rule carries into the backward."""

    @staticmethod
    def forward(ctx, a, b, tf32):
        ctx.save_for_backward(a, b)
        ctx.tf32 = tf32
        with matmul_tf32(tf32):
            return a @ b

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with matmul_tf32(ctx.tf32):
            if ctx.needs_input_grad[0]:
                da = g @ b.mT
            if ctx.needs_input_grad[1]:
                db = a.mT @ g
        return da, db, None


def _gemm(a: torch.Tensor, b: torch.Tensor, mm_dtype=None,
          mm_precision=None) -> torch.Tensor:
    """One of the objective's O(N K²) GEMMs under the precision policy
    (``scfgp_tpu/models/objective.py:142-171``; ``ops/dispatch.py``):
    ``mm_dtype`` operands with float32 sums (``_ReducedDot``; the
    precision then has no say, as in the JAX package), else TF32 for
    ``mm_precision="default"`` and IEEE for "high" and "highest"
    (``_PrecisionDot``), else the plain product under the process-wide
    setting."""
    if mm_dtype is not None:
        return _ReducedDot.apply(a, b, mm_dtype)
    if mm_precision is None:
        return a @ b
    return _PrecisionDot.apply(a, b, uses_tf32(mm_precision))


def sufficient_stats(Phi: torch.Tensor, y: torch.Tensor,
                     w: Optional[torch.Tensor] = None, mm_dtype=None,
                     mm_precision=None) -> SufficientStats:
    """Accumulate the row-sum statistics, optionally weighted so that
    zero-weight padding rows change nothing; per trial for Phi (B, N, 2K)
    and y (B, N).  The Gram under ``mm_dtype``/``mm_precision``
    (``_gemm``)."""
    y = y.reshape(Phi.shape[:-1])
    if w is None:
        return SufficientStats(
            phiTphi=_gemm(Phi.mT, Phi, mm_dtype, mm_precision),
            phiTy=_mv(Phi.mT, y),
            yTy=torch.sum(y * y, dim=-1),
            n=torch.full(Phi.shape[:-2], Phi.shape[-2], dtype=Phi.dtype,
                         device=Phi.device))
    w = w.reshape(Phi.shape[:-1]).to(Phi.dtype)
    return SufficientStats(phiTphi=_gemm(Phi.mT, Phi * w.unsqueeze(-1),
                                         mm_dtype, mm_precision),
                           phiTy=_mv(Phi.mT, w * y),
                           yTy=torch.sum(w * y * y, dim=-1),
                           n=torch.sum(w, dim=-1))


def psum_stats(stats: SufficientStats, axis_name) -> SufficientStats:
    """The statistics summed over the ranks of ``axis_name``
    (``scfgp_tpu/models/objective.py:194-196``): one all-reduce of the
    four fields, differentiable."""
    sizes = [t.numel() for t in stats]
    flat = psum(torch.cat([t.reshape(-1) for t in stats]), axis_name)
    return SufficientStats(*(part.view(t.shape) for part, t in zip(
        torch.split(flat, sizes), stats)))


class _CholInverse(torch.autograd.Function):
    """``(L, Li)`` by torch's pair (``ops/cholesky.py::cholesky_inverse_ref``:
    NaN where ``A`` is not positive definite, as JAX's cholesky gives, which
    the training loops treat as a step that did not improve), with the
    all-GEMM backward ``chol_inverse_bwd`` of
    ``scfgp_tpu/models/objective.py:199-243`` (Murray 2016, eq. 8)."""

    @staticmethod
    def forward(ctx, A):
        L, Li = cholesky_inverse_ref(A)
        ctx.save_for_backward(L, Li)
        return L, Li

    @staticmethod
    def backward(ctx, gL, gLi):
        return chol_inverse_bwd(*ctx.saved_tensors, gL, gLi)


def chol_and_inverse(A: torch.Tensor):
    """``(L, Li) = (chol(A), L⁻¹)``: Cholesky, then a triangular solve
    against the identity, as the JAX package leaves both to XLA;
    differentiable through ``_CholInverse``'s all-GEMM backward."""
    return _CholInverse.apply(A)


def solve_posterior(stats: SufficientStats, sig2_n: torch.Tensor,
                    epsilon: float = EPSILON, mm_dtype=None) -> Posterior:
    """Cholesky-solve the 2K x 2K normal equations (``SCFGP.py:105-110``),
    per trial with a trial axis.

    With ``mm_dtype`` the Gram was summed from reduced-precision operands,
    so its entries carry about eps(mm_dtype) of the diagonal in rounding,
    more than the fixed jitter covers once the noise is small: the jitter
    grows by ``eps(mm_dtype) trace(ΦᵀΦ) / 2K``, per trial
    (``scfgp_tpu/models/objective.py:246-270``)."""
    n2k = stats.phiTphi.shape[-1]
    eye = torch.eye(n2k, dtype=stats.phiTphi.dtype,
                    device=stats.phiTphi.device)
    jitter = sig2_n + epsilon
    if mm_dtype is not None:
        jitter = jitter + torch.finfo(mm_dtype).eps * torch.diagonal(
            stats.phiTphi, dim1=-2, dim2=-1).sum(-1) / n2k
    L, Li = chol_and_inverse(stats.phiTphi + _trial(jitter, 2) * eye)
    beta = _mv(Li, stats.phiTy)
    alpha = _mv(Li.mT, beta)
    return Posterior(L=L, Li=Li, alpha=alpha, beta=beta,
                     log_diag_L=torch.log(torch.diagonal(L, dim1=-2,
                                                         dim2=-1)))


def latent_moments(Phi: torch.Tensor, post: Posterior, mm_dtype=None,
                   mm_precision=None):
    """Per-row posterior mean and variance of the latent f
    (``SCFGP.py:111-112``): ``var_f = rowsum((Phi Liᵀ)²)``, its GEMM under
    ``mm_dtype``/``mm_precision`` (``_gemm``)."""
    PhiLiT = _gemm(Phi, post.Li.mT, mm_dtype, mm_precision)
    return _mv(Phi, post.alpha), torch.sum(PhiLiT * PhiLiT, dim=-1)


def expected_nll_rows(mu_f, var_f, y, noise):
    """Closed form of the reference's Gauss-Hermite expected NLL
    (``SCFGP.py:113,118-124``), per row; ``noise`` () or (B,) a trial."""
    y = y.reshape(mu_f.shape)
    dsp = _trial(noise) * (var_f + 1.0)
    r = mu_f - y
    return (0.5 * r * r + 0.5 * var_f) / dsp + 0.5 * torch.log(
        2.0 * math.pi * dsp)


def kl_penalty(p: SCFGPParams) -> torch.Tensor:
    """KL-style regulariser on the frequency matrices
    (``SCFGP.py:94,114-117,127``); std is the population std, as in NumPy."""
    F = p.l_F @ p.r_F.mT

    def kl(mu, sig):
        return sig + mu * mu - torch.log(sig)

    mu_l = torch.sum(p.l_F.mean(dim=-1), dim=-1)
    sig_l = torch.sum(p.l_F.std(dim=-1, correction=0), dim=-1)
    mu_w = torch.sum(F.mean(dim=-1), dim=-1)
    sig_w = torch.sum(F.std(dim=-1, correction=0), dim=-1)
    return (kl(mu_w, sig_w) * p.M + kl(mu_l, sig_l) * p.S) / (p.S + p.M)


def feature_block(p: SCFGPParams, X: torch.Tensor,
                  basis_fn=None) -> torch.Tensor:
    """Phi of ``X``, with the FIXED columns ``basis_fn(X)`` appended for
    composite models (e.g. trend + periodic).  ``basis_fn`` takes one
    (N, D) array; with a trial axis it is applied per trial and stacked."""
    Phi = fourier_features(p, X)
    if basis_fn is None:
        return Phi
    basis = (basis_fn(X) if X.dim() == 2
             else torch.stack([basis_fn(x) for x in X]))
    return torch.cat([Phi, basis.to(Phi.dtype)], dim=-1)


def loss_from_phi(p: SCFGPParams, Phi: torch.Tensor, y: torch.Tensor,
                  w: Optional[torch.Tensor] = None,
                  residual_fit: bool = False, axis_name=None, mm_dtype=None,
                  mm_precision=None):
    """``loss_fn`` given the feature block ``Phi`` of the training rows.

    The data-fit term ``(yᵀy - βᵀβ) / σ²`` is the reference's
    (``SCFGP.py:126``; the cancellation the JAX package notes at
    ``scfgp_tpu/models/objective.py:34-36``).  ``residual_fit=True`` takes the same quantity
    as ``(‖y - Φα‖² + (σ² + ε)‖α‖²) / σ²``: equal in exact arithmetic
    (``βᵀβ = yᵀΦα`` and ``Aα = Φᵀy``), but a difference of two sums of
    size ``yᵀy`` no longer divides by a small σ².  In float32 on an H100 at
    kin8nm width the reference's form is off by ~0.5 nat where σ² ~ 1e-3,
    noise that stalls HMC; the residual form is ~1e-2 (PERF.md).
    Its error is also second order in α's, since α minimises it.
    ``axis_name``: the rows are this rank's, and every row sum is
    all-reduced over that group (module docstring).  ``mm_dtype`` and
    ``mm_precision``: the arithmetic of the two O(N K²) GEMMs
    (``ops/dispatch.py``)."""
    y = y.reshape(Phi.shape[:-1])
    sig2_n = torch.exp(2.0 * p.a)
    noise = softplus(p.c)
    stats = sufficient_stats(Phi, y, w, mm_dtype, mm_precision)
    if axis_name is not None:
        stats = psum_stats(stats, axis_name)
    post = solve_posterior(stats, sig2_n, mm_dtype=mm_dtype)
    mu_f, var_f = latent_moments(Phi, post, mm_dtype, mm_precision)
    enll_rows = expected_nll_rows(mu_f, var_f, y, noise)
    if w is not None:
        w = w.reshape(y.shape).to(enll_rows.dtype)
        enll_rows = enll_rows * w
    enll_sum = torch.sum(enll_rows, dim=-1)
    if axis_name is not None:
        enll_sum = psum(enll_sum, axis_name)
    if residual_fit:
        r2 = (mu_f - y) ** 2 if w is None else w * (mu_f - y) ** 2
        r2_sum = torch.sum(r2, dim=-1)
        if axis_name is not None:
            r2_sum = psum(r2_sum, axis_name)
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


def loss_fn(p: SCFGPParams, X: torch.Tensor, y: torch.Tensor,
            w: Optional[torch.Tensor] = None, basis_fn=None,
            residual_fit: bool = False, axis_name=None, mm_dtype=None,
            mm_precision=None):
    """SCFGP objective ``cost = (nlml + penalty) / N`` (``SCFGP.py:92-128``
    term by term).  Returns ``(cost, LossAux)``.  ``residual_fit``: see
    ``loss_from_phi``.  With ``axis_name`` (a process group, such as
    ``mesh.group("data")``) ``X``, ``y`` and ``w`` are this rank's rows, and the
    statistics and the expected-NLL sum are all-reduced over the group, so
    the cost is the full batch's on every rank.  ``mm_dtype`` and
    ``mm_precision``: the arithmetic of the Gram and Φ·L⁻ᵀ GEMMs
    (``ops/dispatch.py``; None and None, the default, is IEEE float32)."""
    return loss_from_phi(p, feature_block(p, X, basis_fn), y, w,
                         residual_fit, axis_name, mm_dtype, mm_precision)


def predict_from_phi(p: SCFGPParams, post: Posterior, Phis: torch.Tensor):
    """``predict_f`` given the feature block ``Phis`` of the query rows."""
    noise = softplus(p.c)
    PhiLiT = Phis @ post.Li.mT
    std = torch.sqrt(_trial(noise)
                     * (1.0 + torch.sum(PhiLiT * PhiLiT, dim=-1)))
    return _mv(Phis, post.alpha), std


def predict_f(p: SCFGPParams, post: Posterior, Xs: torch.Tensor,
              basis_fn=None):
    """Predictive mean and std of the scaled target (``SCFGP.py:138-148``):
    ``mu* = Phi* alpha``, ``std* = sqrt(noise (1 + rowsum((Phi* Liᵀ)²)))``."""
    return predict_from_phi(p, post, feature_block(p, Xs, basis_fn))


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A fresh leaf of ``t`` to differentiate against (a tensor made under
    ``inference_mode``, as serving makes them, is copied first)."""
    t = t.detach()
    return (t.clone() if t.is_inference() else t).requires_grad_()


def value_and_grad(loss, p: SCFGPParams, *args, replicas=None, **kwargs):
    """``((cost, LossAux), grads)`` of ``loss(p, *args, **kwargs)``, with
    ``grads`` an ``SCFGPParams`` of d cost / d p:
    ``jax.value_and_grad(loss, has_aux=True)``.  The gradient is taken by
    ``torch.autograd.grad`` on leaf copies of the params, so nothing
    accumulates in ``.grad``; every output is detached.  A batched cost
    (B,) is differentiated through its sum: each trial's gradient is its
    own, since trials share nothing.

    ``replicas`` (default: the ``axis_name`` keyword, if any): the group
    over which the cost is replicated.  The cost is divided by the group's
    size before the backward and the gradient all-reduced over it after,
    so every rank gets the exact global gradient
    (``ops/collectives.py``)."""
    if replicas is None:
        replicas = kwargs.get("axis_name")
    with span("scfgp.grad"):
        leaves = SCFGPParams(*map(_leaf, p))
        with torch.enable_grad():
            with span("scfgp.grad.forward"):
                cost, aux = loss(leaves, *args, **kwargs)
                total = cost.sum()
                if replicas is not None:
                    total = total / axis_size(replicas)
            with span("scfgp.grad.backward"):
                grads = torch.autograd.grad(total, leaves)
        if replicas is not None:
            grads = all_reduce_sum(grads, replicas)
        aux = LossAux(post=Posterior(*(t.detach() for t in aux.post)),
                      nlml=aux.nlml.detach(), penalty=aux.penalty.detach())
    return (cost.detach(), aux), SCFGPParams(*grads)


def loss_and_grad(p: SCFGPParams, X: torch.Tensor, y: torch.Tensor,
                  w: Optional[torch.Tensor] = None, basis_fn=None,
                  axis_name=None, mm_dtype=None, mm_precision=None):
    """``value_and_grad`` of ``loss_fn``
    (``scfgp_tpu/models/objective.py:403``); with ``axis_name`` the
    data-parallel loss and the global gradient, on every rank."""
    return value_and_grad(loss_fn, p, X, y, w=w, basis_fn=basis_fn,
                          axis_name=axis_name, mm_dtype=mm_dtype,
                          mm_precision=mm_precision)
