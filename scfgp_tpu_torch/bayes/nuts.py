"""Multinomial NUTS, chain-parallel: the dynamic sampler with the U-turn
check and the fixed-budget (static) one.

Port of ``scfgp_tpu/bayes/nuts.py``.  Both build every chain's trajectory
leaf by leaf, and every leaf is one batched gradient of all C chains
(``hmc.leapfrog``'s cached edge gradients), so on the card one K1f and one
K1b launch serve a leaf whatever C.

``nuts_sample`` (``nuts.py:59-332``) is the iterative multinomial NUTS of
Phan and Hoffman with the generalised U-turn check and the checkpoint
stack.  JAX runs it per chain under ``vmap`` of a ``while_loop``, where a
chain that has turned or diverged is frozen while the others go on; here
the chains are one batch and ``torch.where`` masks do the freezing.  All
chains build a subtree of the same depth at doubling j, so the leaf index,
its trailing-ones count and the stack pointer are Python ints shared by
the chains, and only the checkpoint stacks (C, max_depth + 1, P) are per
chain.  A doubling stops when no chain builds on, a leaf loop when every
chain still building has turned or diverged: a transition costs 1 + (2^d
- 1) batched gradients at most, d the deepest chain's depth.
``nuts_sample_host_looped`` is the same sampler: the port's samplers are
host loops already.

``nuts_sample_static`` (``nuts.py:391-568``) performs ``depth`` doublings
each transition, 2^depth - 1 leapfrog steps, with no U-turn check and no
early exit, progressively sampling a multinomial proposal along the
trajectory (leaf weights ``exp(-(H_leaf - H_0))``, the biased subtree
merge of NUTS).  A constant stopping rule keeps the proposal valid, and it
keeps the chains in step: each chain has its own signed step and its own
trajectory edge, chosen by ``torch.where``, and a transition costs
2^depth batched gradients.  A divergent leaf, non-finite included, gets
weight -inf instead of stopping the chain.

Random inputs.  Static: drawn in this order each transition, the
standard-normal momentum (C, P); then per doubling the direction bits
(C,), one uniform (C,) a leaf, and the merge uniform (C,).  Dynamic: all of
a transition's inputs at its start, in an order fixed by ``max_depth``
alone, whatever depth the chains reach: the momentum (C, P); then per
doubling j < max_depth the direction bits (C,), the 2^j leaf uniforms
(2^j, C) and the merge uniform (C,).  The JAX package draws the same per
chain from its key tree (``nuts.py:129-132, 178-201, 407-459, 506``).
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
    # Dynamic sampler: (transitions, chains) tree depth of every transition
    # of the call, warmup included, and the batched gradients it took.
    depths: torch.Tensor = None
    gradients: int = None


def _pick(mask, a, b):
    """``a`` where the chain's ``mask`` (C,) holds, else ``b``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _leapfrog_1(value_and_grad, z, r, g, e, inv_mass):
    """One leapfrog step from the cached gradient ``g`` at ``z``: one new
    batched gradient (``nuts.py:59-67``).  Returns ``(z, r, ld, g)``."""
    r = r + 0.5 * e * g
    z = z + e * inv_mass * r
    ld, g = value_and_grad(z)
    r = r + 0.5 * e * g
    return z, r, ld, g


def _leaf(ld, r, inv_mass, h0, neg_inf):
    """A leaf's ``(divergent, log weight, accept prob)`` per chain from its
    energy error; a divergent leaf, non-finite included, weighs nothing."""
    delta = -ld + 0.5 * torch.sum(r * r * inv_mass, dim=-1) - h0
    div = ~torch.isfinite(delta) | (delta > MAX_DELTA_ENERGY)
    return (div, torch.where(div, neg_inf, -delta),
            torch.where(div, torch.zeros_like(delta),
                        torch.clamp(torch.exp(-delta), max=1.0)))


def _is_turning(sum_r, r_a, r_b, inv_mass):
    """The generalised U-turn check of a block, per chain
    (``nuts.py:70-73``)."""
    return ((torch.sum(sum_r * inv_mass * r_a, dim=-1) <= 0.0)
            | (torch.sum(sum_r * inv_mass * r_b, dim=-1) <= 0.0))


def _trailing_ones(n: int) -> int:
    return ((n ^ (n + 1)).bit_length()) - 1


def dynamic_transition(value_and_grad: Callable, z0, eps, inv_mass,
                       max_depth: int, draws):
    """One dynamic NUTS transition of all chains (``nuts.py:87-249``): z0
    (C, P), ``eps`` (C,), ``inv_mass`` (C, P).  Returns ``(z, ld, accept
    stat, depth, divergent, gradients)``: per chain, then the batched
    gradients taken."""
    C, P = z0.shape
    dev, dt = z0.device, z0.dtype
    r0 = draws.normal(z0.shape) * (1.0 / torch.sqrt(inv_mass))
    plan = [(draws.bernoulli((C,)), draws.uniform((1 << j, C)),
             draws.uniform((C,))) for j in range(max_depth)]
    ld0, g0 = value_and_grad(z0)
    grads = 1
    h0 = -ld0 + 0.5 * torch.sum(r0 * r0 * inv_mass, dim=-1)
    neg_inf = torch.full((C,), -math.inf, dtype=dt, device=dev)
    no = torch.zeros(C, dtype=torch.bool, device=dev)

    z_minus = z_plus = z_prop = z0
    r_minus = r_plus = sum_r = r0
    g_minus = g_plus = g0
    ld_prop = ld0
    log_weight = sum_accept = torch.zeros_like(ld0)
    num_leaves = torch.ones_like(ld0)
    depth = torch.zeros(C, dtype=torch.int64, device=dev)
    turning = diverging = no
    for j, (go_right, u_leaf, u_merge) in enumerate(plan):
        active = ~(turning | diverging)
        if not bool(active.any()):
            break
        e = torch.where(go_right, eps, -eps)[:, None]
        # The subtree of 2^j leaves from the edge in the chain's direction,
        # leaf by leaf; a chain stops building at its first bad leaf.
        z = _pick(go_right, z_plus, z_minus)
        r = _pick(go_right, r_plus, r_minus)
        g = _pick(go_right, g_plus, g_minus)
        csum = torch.zeros_like(z0)
        z_ps, ld_ps, log_w_s = z, neg_inf, neg_inf
        acc_s = torch.zeros_like(ld0)
        r_ck = z0.new_zeros((C, max_depth + 1, P))
        csum_ck = z0.new_zeros((C, max_depth + 1, P))
        bad, div_s = ~active, no
        sp = 0
        for n in range(1 << j):
            live = ~bad
            if not bool(live.any()):
                break
            z1, r1, ld1, g1 = _leapfrog_1(value_and_grad, z, r, g, e,
                                          inv_mass)
            grads += 1
            div1, log_w_leaf, accept = _leaf(ld1, r1, inv_mass, h0, neg_inf)
            log_w_new = torch.logaddexp(log_w_s, log_w_leaf)
            take = live & (torch.log(u_leaf[n]) < (log_w_leaf - log_w_new))
            z_ps = _pick(take, z1, z_ps)
            ld_ps = torch.where(take, ld1, ld_ps)
            csum1 = csum + r1
            # Even n pushes (r_n, csum before n); odd n checks the t blocks
            # it closes against the top t checkpoints, then pops t - 1.
            if n % 2 == 0:
                r_ck[:, sp], csum_ck[:, sp] = r1, csum
                sp += 1
                turn = no
            else:
                t = _trailing_ones(n)
                turn = no
                for i in range(t):
                    turn = turn | _is_turning(csum1 - csum_ck[:, sp - 1 - i],
                                              r_ck[:, sp - 1 - i], r1,
                                              inv_mass)
                sp -= t - 1
            z, r, g = _pick(live, z1, z), _pick(live, r1, r), _pick(live,
                                                                    g1, g)
            csum = _pick(live, csum1, csum)
            log_w_s = torch.where(live, log_w_new, log_w_s)
            acc_s = torch.where(live, acc_s + accept, acc_s)
            div_s = div_s | (live & div1)
            bad = bad | (live & (div1 | turn))
        ok = active & ~bad
        # Merge a valid subtree (multinomial NUTS drops a broken doubling
        # wholesale and ends the trajectory); stopped chains keep it all.
        up_plus, up_minus = ok & go_right, ok & ~go_right
        z_plus, r_plus, g_plus = (_pick(up_plus, a, b) for a, b in
                                  ((z, z_plus), (r, r_plus), (g, g_plus)))
        z_minus, r_minus, g_minus = (_pick(up_minus, a, b) for a, b in
                                     ((z, z_minus), (r, r_minus),
                                      (g, g_minus)))
        take = ok & (torch.log(u_merge) < (log_w_s - log_weight))
        z_prop = _pick(take, z_ps, z_prop)
        ld_prop = torch.where(take, ld_ps, ld_prop)
        log_weight = torch.where(ok, torch.logaddexp(log_weight, log_w_s),
                                 log_weight)
        sum_r = _pick(ok, sum_r + csum, sum_r)
        turn_all = torch.where(ok, _is_turning(sum_r, r_minus, r_plus,
                                               inv_mass), turning)
        sum_accept = torch.where(active, sum_accept + acc_s, sum_accept)
        num_leaves = torch.where(active, num_leaves + float(1 << j),
                                 num_leaves)
        depth = depth + active.to(depth.dtype)
        turning = torch.where(active, turn_all | ~ok, turning)
        diverging = diverging | (active & div_s)
    accept_stat = sum_accept / torch.clamp(num_leaves - 1.0, min=1.0)
    return z_prop, ld_prop, accept_stat, depth, diverging, grads


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
            z, r, ld, g = _leapfrog_1(value_and_grad, z, r, g, e, inv_mass)
            diverging, log_w_leaf, accept = _leaf(ld, r, inv_mass, h0,
                                                  neg_inf)
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


def nuts_sample(logdensity_fn: Callable, init_positions: torch.Tensor, rng,
                num_warmup: int = 500, num_samples: int = 500,
                max_depth: int = 8, init_step_size: float = 0.01,
                target_accept: float = 0.8, adapted=None,
                warmup_state=None) -> NUTSResult:
    """C chains of dynamic NUTS (``scfgp_tpu/bayes/nuts.py:269-332``),
    with the warmup of ``hmc.hmc_sample`` shared by the chains (the mean
    acceptance statistic, all chains' draws).  Each transition takes at
    most ``2^max_depth`` batched gradients, as its deepest chain needs.
    ``adapted``/``warmup_state``: see ``hmc.adaptive_sample``.
    ``mean_depth`` is the chains' mean tree depth over the sampling
    transitions; ``depths`` and ``gradients`` read every transition."""
    draws = as_draws(rng, init_positions)
    vg = batched_value_and_grad(logdensity_fn)
    C, P = init_positions.shape
    depths, grads = [], [0]

    def transition(q, eps, inv_mass):
        q, ld, acc, depth, div, n = dynamic_transition(
            vg, q, eps.expand(C), inv_mass.expand(C, P), max_depth, draws)
        depths.append(depth)
        grads[0] += n
        return q, ld, acc, div

    (samples, lds, acc, divs, q, eps, inv_mass, ws) = adaptive_sample(
        transition, init_positions, num_warmup, num_samples, init_step_size,
        target_accept, adapted, warmup_state, shared_adaptation=True)
    depths = (torch.stack(depths) if depths else
              torch.zeros((0, C), dtype=torch.int64))
    kept = depths[depths.shape[0] - num_samples:].to(init_positions.dtype)
    return NUTSResult(samples=samples, logdensities=lds, accept_rate=acc,
                      step_size=eps, inv_mass=inv_mass,
                      mean_depth=torch.mean(torch.mean(kept, dim=1)),
                      divergences=divs, final_positions=q, warmup_state=ws,
                      depths=depths, gradients=grads[0])


def nuts_sample_host_looped(logdensity_fn: Callable,
                            init_positions: torch.Tensor, rng,
                            num_warmup: int = 500, num_samples: int = 500,
                            max_depth: int = 8, init_step_size: float = 0.01,
                            target_accept: float = 0.8) -> NUTSResult:
    """``scfgp_tpu/bayes/nuts.py:335-385``: the dynamic sampler with its
    adaptation on the host.  The port's samplers run on the host already,
    so this is ``nuts_sample`` under JAX's signature."""
    return nuts_sample(logdensity_fn, init_positions, rng,
                       num_warmup=num_warmup, num_samples=num_samples,
                       max_depth=max_depth, init_step_size=init_step_size,
                       target_accept=target_accept)


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
