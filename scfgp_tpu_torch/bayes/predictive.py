"""Log posterior over the flat hyperparameter vector, and the posterior-
predictive mixture over draws.

Port of ``scfgp_tpu/bayes/predictive.py:23-200``.  Every sampler needs the
value and gradient of the log posterior for all C chains at once; the JAX
package builds it as ``jax.vmap(jax.value_and_grad(logpost))``.  Here the
log posterior takes the chains as the leading axis of θ (C, P), unpacked
into the trial layout ``loss_fn`` takes (``models/params.py::
unpack_params``), so one batched loss serves every chain and its gradient
is that of ``cost.sum()``: chains share nothing, as the trials of a batched
sweep do (``models/objective.py::value_and_grad``).  On the card the
feature map is K1f and its gradient K1b, one launch each a batched
gradient whatever C (the trial axis of ``ops/phi.py``).

K1f and K1b take a contiguous X, so the data are copied to (C, N, D) and
(C, N) once per batch size the log posterior sees (``_Data``), not once
per gradient.

The mixture takes chunks of draws as the trial axis under ``no_grad``,
keeping running sums (law of total variance, biased variance), so its peak
memory is that of one chunk's Φ, (chunk, N, 2K).

``streaming_block > 0`` takes both through the O(block)-memory objective
(``ops/streaming.py``) with the chains (draws) as its trial axis, for N
whose Φ would not fit in memory: X stays (N, D), each block is copied per
chain inside the block, and a batched gradient is still one K1f and one
K1b launch a block pass whatever C.
"""

from __future__ import annotations

import torch

from ..models.objective import loss_fn, predict_f, softplus
from ..models.params import reduced_dim, unpack_params
from ..ops.streaming import loss_fn_streaming, streaming_posterior
from ..utils.profiling import span


class _Data:
    """X (N, D) and y (N,), and their contiguous copies (B, N, D), (B, N)
    for each batch size B asked for: K1f and K1b refuse an expanded X."""

    def __init__(self, X, y):
        self.X, self.y = X, y.reshape(-1)
        self._copies = {}

    def of(self, lead):
        if not lead:
            return self.X, self.y
        if lead not in self._copies:
            self._copies[lead] = (
                self.X.expand(*lead, *self.X.shape).contiguous(),
                self.y.expand(*lead, *self.y.shape).contiguous())
        return self._copies[lead]


def make_logposterior(X, y, D, S, M, temperature: float = 1.0,
                      include_phases: bool = False, phases=None,
                      streaming_block: int = 0, basis_fn=None,
                      n_scale: int | None = None, mm_dtype=None,
                      mm_precision=None):
    """log p(θ | data) up to a constant: ``-0.5 * n * cost / temperature``
    (the reference's cost is (nlml + penalty)/N, ``reference:
    SCFGP/SCFGP.py:125-128``).

    Returns ``logpost(theta)``: θ (P,) gives a scalar, θ (C, P) one value a
    chain (C,); differentiable by autograd (``batched_value_and_grad``).
    The phases are pure gauge, so by default θ is the reduced vector
    ``[a, b, c, l_F, r_F]`` of dimension ``reduced_dim(D, S, M)`` with the
    phases pinned at ``phases`` (default zeros); ``include_phases=True``
    keeps the full reference layout.  The data-fit term is taken from the
    residuals (``loss_fn(residual_fit=True)``): the same function, without
    the float32 cancellation that makes the reference's form too noisy for
    HMC on the card.  ``n_scale`` replaces the N of
    ``-0.5 * N * cost``: the full data size for a minibatch estimator
    (``bayes/sgld.py``).  ``streaming_block > 0`` takes the cost from
    ``loss_fn_streaming`` in blocks of that many rows (the residual form
    summed in its pass 2), the chains as its trial axis.

    ``mm_dtype`` and ``mm_precision`` (``ops/dispatch.py``) set the
    arithmetic of the posterior's two O(N K²) GEMMs, so the chain samples
    the posterior of that arithmetic (``scfgp_tpu/bayes/predictive.py:
    57-70``): ``mm_precision`` dense and streaming, ``mm_dtype`` dense only
    (ignored with ``streaming_block``, as in the JAX package).
    ``SCFGP.fit_bayes`` passes only settings given explicitly."""
    n = X.shape[0] if n_scale is None else int(n_scale)
    if streaming_block:
        def cost_of(p):
            return loss_fn_streaming(p, X, y, block_size=int(streaming_block),
                                     basis_fn=basis_fn, residual_fit=True,
                                     mm_precision=mm_precision)[0]
    else:
        data = _Data(X, y)

        def cost_of(p):
            Xc, yc = data.of(tuple(p.a.shape))
            return loss_fn(p, Xc, yc, basis_fn=basis_fn, residual_fit=True,
                           mm_dtype=mm_dtype, mm_precision=mm_precision)[0]
    if phases is None:
        pinned = torch.zeros(S + M, dtype=X.dtype, device=X.device)
    else:
        pinned = torch.cat([torch.as_tensor(t, device=X.device).reshape(-1)
                            for t in phases])

    def logpost(theta):
        if not include_phases:
            pin = pinned.to(theta.dtype).expand(*theta.shape[:-1], S + M)
            theta = torch.cat([theta, pin], dim=-1)
        return -0.5 * n * cost_of(unpack_params(theta, D, S, M)) / temperature

    return logpost


def batched_value_and_grad(logdensity_fn):
    """``(C, P) -> (ld (C,), grad (C, P))`` of a log density batched over
    its leading axis: ``jax.vmap(jax.value_and_grad(logdensity_fn))``.
    The gradient is that of ``ld.sum()``, each chain's own since chains
    share nothing; both outputs are detached."""

    def value_and_grad(q):
        with span("scfgp.grad"):
            q = q.detach().requires_grad_()
            with torch.enable_grad():
                with span("scfgp.grad.forward"):
                    ld = logdensity_fn(q)
                with span("scfgp.grad.backward"):
                    g, = torch.autograd.grad(ld.sum(), q)
        return ld.detach(), g

    return value_and_grad


def logdensity_in_chunks(logdensity_fn, thetas, chunk: int):
    """Values of ``logdensity_fn`` at (n, P) positions, ``chunk`` rows a
    call, without gradients: (n,)."""
    with torch.no_grad():
        return torch.cat([logdensity_fn(thetas[i:i + chunk])
                          for i in range(0, thetas.shape[0], chunk)])


def predictive_mixture(thetas, X, y, Xs, D, S, M, basis_fn=None,
                       chunk: int = 8, streaming_block: int = 0,
                       recalibrate: bool = False):
    """Posterior-predictive mean and std at ``Xs`` mixing over the draws
    ``thetas`` (num_draws, P), in the scaled target space:

        mu* = mean_s mu_s,   var* = mean_s var_s + var_s(mu_s)  (biased)

    ``chunk`` draws at a time are one batched solve and prediction; the last
    chunk is padded with weight-0 copies of the last draw.
    ``recalibrate=True`` replaces each draw's ``softplus(c)`` by ``mean(train
    resid²) / (1 + mean(train var_f))`` before its variance enters the
    mixture (``scfgp_tpu/bayes/predictive.py:159-169``).
    ``streaming_block > 0`` solves each chunk's posteriors by the streaming
    pass 1 (``ops/streaming.py::streaming_posterior``) with the chunk as its
    trial axis, in blocks of that many rows; it does not take
    ``recalibrate``, whose train-set moments would need Φ of all rows."""
    if recalibrate and streaming_block:
        raise ValueError("recalibrate=True is not supported with "
                         "streaming_block (train-set moments would "
                         "materialize Phi); recalibrate on a subsample "
                         "instead")
    thetas = torch.as_tensor(thetas, device=X.device)
    if thetas.shape[-1] == reduced_dim(D, S, M):
        # Phase-free draws: phases are gauge, any value predicts the same.
        thetas = torch.cat([thetas, thetas.new_zeros(thetas.shape[0],
                                                     S + M)], dim=1)
    n_draws = thetas.shape[0]
    chunk = max(1, min(int(chunk), n_draws))
    pad_n = (-n_draws) % chunk
    w = torch.cat([thetas.new_ones(n_draws), thetas.new_zeros(pad_n)])
    if pad_n:
        thetas = torch.cat([thetas, thetas[-1:].expand(pad_n, -1)])
    if not streaming_block:
        Xc, yc = _Data(X, y).of((chunk,))
    Xsc = Xs.expand(chunk, *Xs.shape).contiguous()
    s_mu = s_mu2 = s_var = thetas.new_zeros(Xs.shape[0])
    with torch.no_grad():
        for i in range(0, thetas.shape[0], chunk):
            p = unpack_params(thetas[i:i + chunk], D, S, M)
            wgt = w[i:i + chunk, None]
            if streaming_block:
                _, post = streaming_posterior(p, X, y,
                                              block_size=int(streaming_block),
                                              basis_fn=basis_fn)
            else:
                post = loss_fn(p, Xc, yc, basis_fn=basis_fn)[1].post
            mus, stds = predict_f(p, post, Xsc, basis_fn=basis_fn)
            if recalibrate:
                sp = softplus(p.c)[:, None]
                mu_tr, std_tr = predict_f(p, post, Xc, basis_fn=basis_fn)
                var_f_tr = std_tr * std_tr / sp - 1.0
                resid2 = torch.mean((yc - mu_tr) ** 2, dim=-1)
                sp_new = resid2 / (1.0 + torch.mean(var_f_tr, dim=-1))
                stds = torch.sqrt((stds * stds / sp) * sp_new[:, None])
            s_mu = s_mu + torch.sum(mus * wgt, dim=0)
            s_mu2 = s_mu2 + torch.sum(mus * mus * wgt, dim=0)
            s_var = s_var + torch.sum(stds * stds * wgt, dim=0)
    mu = s_mu / n_draws
    var = s_var / n_draws + torch.clamp(s_mu2 / n_draws - mu * mu, min=0.0)
    return mu, torch.sqrt(var)
