"""Parallel-tempered chain-parallel HMC for multimodal SCFGP posteriors.

Port of ``scfgp_tpu/bayes/tempering.py:39-288``.  T temperature rungs x C
chains evolve as one (T, C, P) position tensor, flattened to T*C trials
for each batched gradient (on the card one K1f and one K1b launch for all
rungs and chains).  Rung t targets ``betas[t] * logpost`` (betas[0] = 1,
the cold rung, whose draws are returned); each rung adapts its own step
size and diagonal mass during warmup; after every transition adjacent
rungs propose swaps on the deterministic even/odd schedule (DEO), pair
(t, t+1) on steps of its parity, with probability ``min(1, exp((beta_t -
beta_{t+1}) (E_{t+1} - E_t)))`` for E the untempered log posterior.

Random inputs each step, in this order: the standard-normal momentum
(T, C, P), the accept uniforms (T, C), the swap uniforms (T - 1, C).

``tempered_hmc_sample_segmented`` is not ported, and never will be:
segmentation existed only for a TPU worker's limit on one execution
(``CLAUDE.md:31-37``); one-shot and segmented runs are the same in law.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .hmc import (WelfordState, as_draws, da_init, da_update, metropolis,
                  welford_add_batch, welford_variance)
from .predictive import batched_value_and_grad, logdensity_in_chunks


class TemperedHMCResult(NamedTuple):
    samples: torch.Tensor       # (num_samples, C, P) cold-rung draws
    logdensities: torch.Tensor  # (num_samples, C) untempered logpost
    accept_rate: torch.Tensor   # () mean HMC acceptance over rungs, chains
    swap_rate: torch.Tensor     # () mean swap acceptance of proposed pairs
    step_sizes: torch.Tensor    # (T,)
    inv_mass: torch.Tensor      # (T, P)
    divergences: torch.Tensor = None   # () cold rung, sampling phase
    final_positions: torch.Tensor = None  # (T, C, P), all rungs
    warmup_state: tuple = None  # ((T,) DualAveragingState, WelfordState)


def geometric_ladder(n_rungs: int, beta_min: float = 0.1,
                     dtype=torch.float32) -> torch.Tensor:
    """Geometric ladder from 1.0 down to ``beta_min``.  Swaps between
    adjacent rungs accept with probability ~exp(-dbeta dE), so a
    data-sized posterior needs ``energy_matched_ladder``."""
    return torch.as_tensor(np.geomspace(1.0, beta_min, n_rungs), dtype=dtype)


def energy_matched_ladder(logdensity_fn: Callable, positions: torch.Tensor,
                          beta_min: float = 0.1, target_gap: float = 1.0,
                          max_rungs: int = 64, chunk: int = 32) -> torch.Tensor:
    """A linear ladder ``1, 1-d, 1-2d, ... >= beta_min`` spaced by the
    measured energy scale, ``d = target_gap / std_E`` (at least
    ``(1 - beta_min) / (max_rungs - 1)``), so the expected swap exponent is
    near ``target_gap``.  ``positions``: (num, P) pooled draws (std over
    all), or (T, C, P) draws per chain (median of the per-chain stds).
    The log densities are evaluated ``chunk`` positions a batch."""
    flat = positions.reshape(-1, positions.shape[-1])
    lds = logdensity_in_chunks(logdensity_fn, flat, chunk)
    lds = lds.cpu().numpy().astype(np.float64)
    if positions.dim() == 3:
        std_e = float(np.median(np.std(lds.reshape(positions.shape[:2]),
                                       axis=0)))
    else:
        std_e = float(np.std(lds))
    if not np.isfinite(std_e) or std_e < 1e-12:
        return geometric_ladder(4, beta_min, positions.dtype)
    d = max(target_gap / std_e, (1.0 - beta_min) / (max_rungs - 1))
    n = int(np.floor((1.0 - beta_min) / d)) + 1
    betas = 1.0 - d * np.arange(n)
    if betas[-1] > beta_min + 1e-9:
        betas = np.append(betas, beta_min)
    return torch.as_tensor(betas, dtype=positions.dtype)


def tempered_hmc_sample(logdensity_fn: Callable, init_positions: torch.Tensor,
                        rng, betas=None, num_warmup: int = 500,
                        num_samples: int = 500,
                        num_integration_steps: int = 16,
                        init_step_size: float = 0.01,
                        target_accept: float = 0.8, init_all_rungs=None,
                        adapted=None, step_offset: int = 0,
                        warmup_state=None) -> TemperedHMCResult:
    """Replica-exchange HMC.  ``init_positions``: (C, P) cold-rung inits,
    replicated across rungs; ``logdensity_fn``: (n, P) -> (n,) as
    ``hmc.hmc_sample``'s.  ``betas=None`` builds ``energy_matched_ladder``
    from the inits.

    Continuation: ``init_all_rungs`` (T, C, P) from a previous result's
    ``final_positions`` with ``adapted=(step_sizes, inv_mass)`` skips
    warmup and continues the chain exactly; ``step_offset`` (the steps
    already taken) keeps the DEO swap parity; ``warmup_state`` continues a
    warmup."""
    C, P = init_positions.shape
    dtype, device = init_positions.dtype, init_positions.device
    draws = as_draws(rng, init_positions)
    if betas is None:
        betas = energy_matched_ladder(logdensity_fn, init_positions)
    betas = torch.as_tensor(betas, dtype=dtype, device=device)
    T = betas.shape[0]
    flat_vg = batched_value_and_grad(logdensity_fn)
    b3 = betas[:, None, None]

    def base_vg(q):
        ld, g = flat_vg(q.reshape(T * C, P))
        return ld.reshape(T, C), g.reshape(T, C, P)

    def transition(q, eps, inv_mass):
        """One tempered HMC step of the whole (T, C, P) tensor: eps (T,),
        inv_mass (T, P).  Returns (q, untempered ld, accept probs (T, C),
        divergent)."""
        im = inv_mass[:, None, :]
        p = draws.normal(q.shape) * (1.0 / torch.sqrt(inv_mass))[:, None, :]
        ld0, g = base_vg(q)
        h0 = -betas[:, None] * ld0 + 0.5 * torch.sum(p * p * im, dim=-1)
        e = eps[:, None, None]
        # Gradient-cached leapfrog (see hmc.leapfrog) on the tempered target.
        q1 = q
        for _ in range(num_integration_steps):
            p = p + 0.5 * e * b3 * g
            q1 = q1 + e * im * p
            ld1, g = base_vg(q1)
            p = p + 0.5 * e * b3 * g
        h1 = -betas[:, None] * ld1 + 0.5 * torch.sum(p * p * im, dim=-1)
        return metropolis(q, q1, ld0, ld1, h0, h1, draws.uniform((T, C)))

    pair_t = torch.arange(T - 1, device=device)

    def swap(q, ld, parity):
        """Even/odd alternating adjacent-rung exchange."""
        delta = (betas[:-1] - betas[1:])[:, None] * (ld[1:] - ld[:-1])
        u = draws.uniform((T - 1, C))
        valid = (pair_t % 2 == parity)[:, None]
        acc = (torch.log(u) < delta) & valid
        none = torch.zeros((1, C), dtype=torch.bool, device=device)
        take_next = torch.cat([acc, none])
        take_prev = torch.cat([none, acc])
        q_sw = torch.where(take_next[..., None], torch.roll(q, -1, 0), q)
        q_sw = torch.where(take_prev[..., None], torch.roll(q, 1, 0), q_sw)
        ld_sw = torch.where(take_next, torch.roll(ld, -1, 0), ld)
        ld_sw = torch.where(take_prev, torch.roll(ld, 1, 0), ld_sw)
        n_valid = int((T - 1 + (1 - parity)) // 2) * C
        return q_sw, ld_sw, acc.sum().to(dtype) / max(n_valid, 1)

    if init_all_rungs is not None:
        q = torch.as_tensor(init_all_rungs, dtype=dtype, device=device)
    else:
        q = init_positions.expand(T, C, P).contiguous()
    out_warmup_state = None
    if adapted is not None:
        eps = torch.as_tensor(adapted[0], dtype=dtype, device=device)
        inv_mass = torch.as_tensor(adapted[1], dtype=dtype, device=device)
    else:
        if warmup_state is not None:
            da, wf = warmup_state
        else:
            da = da_init(init_step_size, dtype, device, (T,))
            wf = WelfordState(torch.zeros(T, dtype=dtype, device=device),
                              torch.zeros(T, P, dtype=dtype, device=device),
                              torch.ones(T, P, dtype=dtype, device=device))
        for i in range(num_warmup):
            q, ld, acc, _ = transition(q, torch.exp(da.log_eps),
                                       welford_variance(wf))
            q, ld, _ = swap(q, ld, (i + step_offset) % 2)
            da = da_update(da, torch.mean(acc, dim=1), target=target_accept)
            wf = welford_add_batch(wf, q)
        out_warmup_state = (da, wf)
        eps = torch.exp(da.log_eps_avg)
        inv_mass = welford_variance(wf)

    samples = q.new_empty((num_samples, C, P))
    lds = q.new_empty((num_samples, C))
    accs = q.new_empty((num_samples,))
    srates = q.new_empty((num_samples,))
    divs = torch.zeros((), dtype=torch.int64, device=device)
    with torch.no_grad():
        ld = logdensity_fn(q.reshape(T * C, P)).reshape(T, C)
    for i in range(num_samples):
        q, ld, acc, div = transition(q, eps, inv_mass)
        q, ld, srates[i] = swap(q, ld, (num_warmup + i + step_offset) % 2)
        samples[i], lds[i], accs[i] = q[0], ld[0], torch.mean(acc)
        divs = divs + div[0].sum()
    return TemperedHMCResult(
        samples=samples, logdensities=lds, accept_rate=torch.mean(accs),
        swap_rate=torch.mean(srates), step_sizes=eps, inv_mass=inv_mass,
        divergences=divs, final_positions=q, warmup_state=out_warmup_state)

