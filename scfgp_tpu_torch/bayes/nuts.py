"""Fixed-budget multinomial NUTS (the static sampler), chain-parallel.

Port of ``scfgp_tpu/bayes/nuts.py:391-568`` (``_static_transition``,
``nuts_sample_static``) and its ``NUTSResult``.  Every transition performs
``depth`` doublings, 2^depth - 1 leapfrog steps, with no U-turn check and
no early exit, progressively sampling a multinomial proposal along the
trajectory (leaf weights ``exp(-(H_leaf - H_0))``, the biased subtree
merge of NUTS).  A constant stopping rule keeps the proposal valid, and it
keeps the chains one batch leaf by leaf: each chain has its own signed
step and its own trajectory edge, chosen by ``torch.where``, and every leaf
is one batched gradient, so a transition costs 2^depth of them (the edge
gradients are cached, as in ``hmc.leapfrog``).  A divergent leaf, non-
finite included, gets weight -inf instead of stopping the chain.

Random inputs, drawn in this order each transition: the standard-normal
momentum (C, P); then per doubling the direction bits (C,), one uniform
(C,) a leaf, and the merge uniform (C,).  The JAX package draws the same
per chain from its key tree (``nuts.py:407-459, 506``).

The dynamic ``nuts_sample`` (a U-turn stopping rule per chain) is not
ported yet (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import MAX_DELTA_ENERGY, adaptive_sample, as_draws
from .predictive import batched_value_and_grad


class NUTSResult(NamedTuple):
    samples: torch.Tensor       # (num_samples, chains, P)
    logdensities: torch.Tensor  # (num_samples, chains)
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor
    mean_depth: torch.Tensor
    divergences: torch.Tensor = None
    final_positions: torch.Tensor = None
    warmup_state: tuple = None


def _pick(mask, a, b):
    """``a`` where the chain's ``mask`` (C,) holds, else ``b``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def static_transition(value_and_grad: Callable, z0, eps, inv_mass,
                      depth: int, draws):
    """One fixed-budget multinomial transition of all chains: z0 (C, P),
    ``eps`` (C,), ``inv_mass`` (C, P).  Returns ``(z, ld, accept stat,
    divergent)`` per chain."""
    C = z0.shape[0]
    neg_inf = torch.full((C,), -math.inf, dtype=z0.dtype, device=z0.device)
    r0 = draws.normal(z0.shape) * (1.0 / torch.sqrt(inv_mass))
    ld0, g0 = value_and_grad(z0)
    h0 = -ld0 + 0.5 * torch.sum(r0 * r0 * inv_mass, dim=-1)

    z_minus = z_plus = z_prop = z0
    r_minus = r_plus = r0
    g_minus = g_plus = g0
    ld_prop = ld0
    log_w = torch.zeros_like(ld0)  # the initial point carries weight 1
    sum_acc = torch.zeros_like(ld0)
    diverged = torch.zeros(C, dtype=torch.bool, device=z0.device)
    for j in range(depth):
        go_right = draws.bernoulli((C,))
        e = torch.where(go_right, eps, -eps)[:, None]
        z = _pick(go_right, z_plus, z_minus)
        r = _pick(go_right, r_plus, r_minus)
        g = _pick(go_right, g_plus, g_minus)
        log_w_s, z_ps, ld_ps = neg_inf, z, neg_inf
        sum_a = torch.zeros_like(ld0)
        for _ in range(1 << j):
            u = draws.uniform((C,))
            r = r + 0.5 * e * g
            z = z + e * inv_mass * r
            ld, g = value_and_grad(z)
            r = r + 0.5 * e * g
            delta = -ld + 0.5 * torch.sum(r * r * inv_mass, dim=-1) - h0
            diverging = ~torch.isfinite(delta) | (delta > MAX_DELTA_ENERGY)
            log_w_leaf = torch.where(diverging, neg_inf, -delta)
            accept = torch.where(diverging, torch.zeros_like(delta),
                                 torch.clamp(torch.exp(-delta), max=1.0))
            log_w_new = torch.logaddexp(log_w_s, log_w_leaf)
            take = torch.log(u) < (log_w_leaf - log_w_new)
            z_ps = _pick(take, z, z_ps)
            ld_ps = torch.where(take, ld, ld_ps)
            log_w_s = log_w_new
            sum_a = sum_a + accept
            diverged = diverged | diverging
        # Biased progressive merge of the new subtree (as in NUTS).
        take = torch.log(draws.uniform((C,))) < (log_w_s - log_w)
        z_prop = _pick(take, z_ps, z_prop)
        ld_prop = torch.where(take, ld_ps, ld_prop)
        log_w = torch.logaddexp(log_w, log_w_s)
        sum_acc = sum_acc + sum_a
        z_plus, z_minus = _pick(go_right, z, z_plus), _pick(go_right,
                                                            z_minus, z)
        r_plus, r_minus = _pick(go_right, r, r_plus), _pick(go_right,
                                                            r_minus, r)
        g_plus, g_minus = _pick(go_right, g, g_plus), _pick(go_right,
                                                            g_minus, g)
    return z_prop, ld_prop, sum_acc / ((1 << depth) - 1), diverged


def nuts_sample_static(logdensity_fn: Callable, init_positions: torch.Tensor,
                       rng, num_warmup: int = 500, num_samples: int = 500,
                       depth: int = 6, init_step_size: float = 0.01,
                       target_accept: float = 0.8, adapted=None,
                       warmup_state=None,
                       shared_adaptation: bool = True) -> NUTSResult:
    """Static multinomial NUTS over C chains, with the warmup adaptation
    of ``hmc.hmc_sample`` (shared, or per chain with
    ``shared_adaptation=False``); each transition costs 2^depth batched
    gradients.  Arguments as ``hmc.hmc_sample``."""
    draws = as_draws(rng, init_positions)
    vg = batched_value_and_grad(logdensity_fn)
    C, P = init_positions.shape

    def transition(q, eps, inv_mass):
        return static_transition(vg, q, eps.expand(C),
                                 inv_mass.expand(C, P), depth, draws)

    (samples, lds, acc, divs, q, eps, inv_mass, ws) = adaptive_sample(
        transition, init_positions, num_warmup, num_samples, init_step_size,
        target_accept, adapted, warmup_state, shared_adaptation)
    return NUTSResult(samples=samples, logdensities=lds, accept_rate=acc,
                      step_size=eps, inv_mass=inv_mass,
                      mean_depth=torch.tensor(float(depth)),
                      divergences=divs, final_positions=q, warmup_state=ws)
