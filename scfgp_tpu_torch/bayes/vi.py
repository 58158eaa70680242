"""Mean-field Gaussian variational inference over SCFGP hyperparameters.

Port of ``scfgp_tpu/bayes/vi.py:24-104``.  Maximizes the reparameterized
ELBO ``E_{eps~N(0,I)}[logpost(mu + sigma*eps)] + H(q)``, with ``H(q) =
sum(log_sigma) + P/2 log(2 pi e)``, by the port's adam on (mu, log_sigma);
the Monte-Carlo samples of a step are one batched log posterior (trials =
samples).  Random inputs: the standard normals (num_mc_samples, P) of each
step, then those of the draws, (num_samples * C, P).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..opt.optimizers import adam, tree_add
from .hmc import as_draws
from .predictive import logdensity_in_chunks


class VIResult(NamedTuple):
    mu: torch.Tensor
    log_sigma: torch.Tensor
    elbo_history: torch.Tensor


def fit_vi(logdensity_fn: Callable, init_position: torch.Tensor, rng,
           num_steps: int = 500, num_mc_samples: int = 8,
           learning_rate: float = 0.01,
           init_log_sigma: float = -3.0) -> VIResult:
    """Fit q(θ) = N(mu, diag(sigma²)) to exp(logdensity);
    ``logdensity_fn``: (n, P) -> (n,), differentiable by autograd."""
    P = init_position.shape[0]
    draws = as_draws(rng, init_position)
    params = (init_position.detach(),
              torch.full((P,), init_log_sigma, dtype=init_position.dtype,
                         device=init_position.device))
    tx = adam(learning_rate=learning_rate, beta1=0.9, beta2=0.999,
              epsilon=1e-8)
    opt_state = tx.init(params)
    entropy_const = 0.5 * P * (1.0 + math.log(2 * math.pi))
    elbos = init_position.new_empty((num_steps,))
    for i in range(num_steps):
        eps = draws.normal((num_mc_samples, P))
        leaves = tuple(t.detach().requires_grad_() for t in params)
        with torch.enable_grad():
            mu, log_sigma = leaves
            theta = mu[None, :] + torch.exp(log_sigma)[None, :] * eps
            expected_ld = torch.mean(logdensity_fn(theta))
            entropy = torch.sum(log_sigma) + entropy_const
            loss = -(expected_ld + entropy)
            grads = torch.autograd.grad(loss, leaves)
        delta, opt_state = tx.update(grads, opt_state, params)
        params = tree_add(params, delta)
        elbos[i] = -loss.detach()
    return VIResult(mu=params[0], log_sigma=params[1], elbo_history=elbos)


def vi_sample(result: VIResult, rng, num_samples: int) -> torch.Tensor:
    """Draws (num_samples, P) from the fitted mean-field Gaussian."""
    eps = as_draws(rng, result.mu).normal((num_samples, result.mu.shape[0]))
    return result.mu[None, :] + torch.exp(result.log_sigma)[None, :] * eps


class VISamplerResult(NamedTuple):
    """``fit_vi`` + ``vi_sample`` in the chain-sampler convention, so that
    ``SCFGP.fit_bayes(sampler='vi')`` sits beside HMC, NUTS, tempering."""

    samples: torch.Tensor       # (num_samples, C, P)
    logdensities: torch.Tensor  # (num_samples, C)
    accept_rate: torch.Tensor   # () 1: independent draws
    elbo: torch.Tensor          # () final ELBO
    mu: torch.Tensor            # (P,)
    log_sigma: torch.Tensor     # (P,)


def vi_posterior_sample(logdensity_fn: Callable, init_positions: torch.Tensor,
                        rng, num_warmup: int = 500, num_samples: int = 500,
                        learning_rate: float = 0.01,
                        init_log_sigma: float = -3.0,
                        chunk: int = 64) -> VISamplerResult:
    """Optimize the ELBO for ``num_warmup`` steps from the chains' mean
    with ``max(C, 2)`` Monte-Carlo samples a step, then draw ``num_samples
    x C`` posterior samples; their log densities are evaluated ``chunk``
    draws a batch (one batch of all would hold every draw's Φ)."""
    C, P = init_positions.shape
    draws = as_draws(rng, init_positions)
    res = fit_vi(logdensity_fn, torch.mean(init_positions, dim=0), draws,
                 num_steps=num_warmup, num_mc_samples=max(C, 2),
                 learning_rate=learning_rate, init_log_sigma=init_log_sigma)
    thetas = vi_sample(res, draws, num_samples * C)
    lds = logdensity_in_chunks(logdensity_fn, thetas, chunk)
    return VISamplerResult(
        samples=thetas.reshape(num_samples, C, P),
        logdensities=lds.reshape(num_samples, C),
        accept_rate=thetas.new_ones(()),
        elbo=res.elbo_history[-1], mu=res.mu, log_sigma=res.log_sigma)
