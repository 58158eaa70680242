"""Whole chains of the port's samplers against the JAX package's, on the
CPU, over a small SCFGP posterior in float64.

The two packages draw from different generators, so each port sampler is
given JAX's draws (``Replay``), built from the JAX sampler's own key tree,
in the order the port asks for them (each JAX sampler runs under one outer
``jax.jit``, one compile instead of one a scan): HMC (shared and fleet adaptation),
static NUTS (fleet), tempered HMC (with a shifted swap parity), VI and
minibatch SGLD.  The continuation contracts (``adapted`` with the final
positions, ``warmup_state``; tempered ``init_all_rungs`` and
``step_offset``) are checked by splitting the port's run in two against
JAX's one-shot run.

Tolerance: rtol 1e-7, atol 1e-9 on every draw and adapted value.  The
chains start from equal values, and rounding differences of ~1e-15 (another
summation order) grow along the trajectories and through the adaptation:
measured up to ~1e-11.  An accept decision that flipped would differ by
O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.bayes import hmc as jhmc
from scfgp_tpu.bayes import nuts as jnuts
from scfgp_tpu.bayes import sgld as jsgld
from scfgp_tpu.bayes import tempering as jtemp
from scfgp_tpu.bayes import vi as jvi
from scfgp_tpu_torch.bayes import (hmc_sample, make_minibatch_value_and_grad,
                                   nuts_sample_static, sgld_sample,
                                   tempered_hmc_sample, vi_posterior_sample)
from test_torch_bayes import D, M, P, S, Replay, close, data, inits, t_, \
    targets

torch.set_num_threads(1)

CHAIN_TOL = dict(rtol=1e-7, atol=1e-9)


def _hmc_items(key, steps, C):
    """hmc.py:291-305, 335: keys = split(key, W + S + 1); a step's key
    splits into the momentum's and the accept test's."""
    rp = Replay()
    for k in jax.random.split(key, steps + 1)[:steps]:
        k1, k2 = jax.random.split(k)
        rp.add("normal", jax.random.normal(k1, (C, P), jnp.float64))
        rp.add("uniform", jax.random.uniform(k2, (C,)))
    return rp.items


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "fleet"])
def test_hmc_chains_equal_jax_with_its_draws(shared):
    """Then the same run split after 3 draws and continued from the final
    positions with the adapted step size and mass."""
    lp_j, lp_t = targets()
    C, W, N, L = 3, 8, 8, 4
    q0, key = inits(C), jax.random.PRNGKey(7)
    kw = dict(num_integration_steps=L, init_step_size=0.01,
              shared_adaptation=shared)
    want = jax.jit(lambda q, k: jhmc.hmc_sample(
        lp_j, q, k, num_warmup=W, num_samples=N, **kw))(jnp.asarray(q0), key)
    items = _hmc_items(key, W + N, C)
    rp = Replay(items)
    got = hmc_sample(lp_t, t_(q0), rp, num_warmup=W, num_samples=N, **kw)
    assert not rp.items
    for f in ("samples", "logdensities", "accept_rate", "step_size",
              "inv_mass", "final_positions"):
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)
    assert int(got.divergences) == int(want.divergences)
    first = hmc_sample(lp_t, t_(q0), Replay(items[:2 * (W + 3)]),
                       num_warmup=W, num_samples=3, **kw)
    rest = hmc_sample(lp_t, first.final_positions,
                      Replay(items[2 * (W + 3):]), num_warmup=0,
                      num_samples=N - 3,
                      adapted=(first.step_size, first.inv_mass), **kw)
    close(rest.samples, want.samples[3:], **CHAIN_TOL)
    assert rest.warmup_state is None
    # The warmup split in two: the adaptation state carries over.
    head = hmc_sample(lp_t, t_(q0), Replay(items[:2 * 3]), num_warmup=3,
                      num_samples=0, **kw)
    tail = hmc_sample(lp_t, head.final_positions, Replay(items[2 * 3:]),
                      num_warmup=W - 3, num_samples=N,
                      warmup_state=head.warmup_state, **kw)
    close(tail.samples, want.samples, **CHAIN_TOL)
    close(tail.step_size, want.step_size, **CHAIN_TOL)


def _nuts_items(key, steps, C, depth):
    """nuts.py:407-459, 506: a step's key splits into one a chain, each
    into the momentum's and the loop's, which splits into four a
    doubling: the loop's next, the direction's, the leaves' and the
    merge's."""
    rp = Replay()
    for k in jax.random.split(key, steps + 1)[:steps]:
        per_chain = []
        for kc in jax.random.split(k, C):
            k_mom, k_loop = jax.random.split(kc)
            seq = [("normal", jax.random.normal(k_mom, (P,), jnp.float64))]
            for j in range(depth):
                k_loop, k_dir, k_sub, k_merge = jax.random.split(k_loop, 4)
                seq.append(("bernoulli", jax.random.bernoulli(k_dir)))
                seq += [("uniform", jax.random.uniform(kl))
                        for kl in jax.random.split(k_sub, 1 << j)]
                seq.append(("uniform", jax.random.uniform(k_merge)))
            per_chain.append(seq)
        for parts in zip(*per_chain):
            rp.add(parts[0][0], np.stack([np.asarray(a) for _, a in parts]))
    return rp


def test_nuts_static_chains_equal_jax_with_its_draws():
    """Per-chain adaptation: each chain its own signed step and edge."""
    lp_j, lp_t = targets()
    C, W, N, depth = 3, 5, 5, 3
    q0, key = inits(C), jax.random.PRNGKey(8)
    kw = dict(num_warmup=W, num_samples=N, depth=depth, init_step_size=0.01,
              shared_adaptation=False)
    want = jax.jit(lambda q, k: jnuts.nuts_sample_static(lp_j, q, k, **kw))(
        jnp.asarray(q0), key)
    rp = _nuts_items(key, W + N, C, depth)
    got = nuts_sample_static(lp_t, t_(q0), rp, **kw)
    assert not rp.items
    for f in ("samples", "logdensities", "accept_rate", "step_size",
              "inv_mass", "final_positions"):
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)
    assert int(got.divergences) == int(want.divergences)


def test_tempered_chains_equal_jax_with_its_draws():
    """Three rungs, the swap parity shifted by ``step_offset=1``; then the
    run split after 3 draws and continued from all rungs' positions with
    the adapted step sizes and masses and the parity threaded through."""
    lp_j, lp_t = targets()
    C, W, N, T, off = 2, 6, 6, 3, 1
    betas = np.array([1.0, 0.7, 0.4])
    q0, key = inits(C), jax.random.PRNGKey(9)
    kw = dict(num_integration_steps=3, init_step_size=0.01)
    want = jax.jit(lambda q, k: jtemp.tempered_hmc_sample(
        lp_j, q, k, betas=jnp.asarray(betas), num_warmup=W, num_samples=N,
        step_offset=off, **kw))(jnp.asarray(q0), key)
    rp = Replay()
    for k in jax.random.split(key, W + N):  # tempering.py:241-283
        k_hmc, k_swap = jax.random.split(k)
        k1, k2 = jax.random.split(k_hmc)
        rp.add("normal", jax.random.normal(k1, (T, C, P), jnp.float64))
        rp.add("uniform", jax.random.uniform(k2, (T, C)))
        rp.add("uniform", jax.random.uniform(k_swap, (T - 1, C)))
    items = rp.items
    got = tempered_hmc_sample(lp_t, t_(q0), Replay(items), betas=t_(betas),
                              num_warmup=W, num_samples=N, step_offset=off,
                              **kw)
    for f in ("samples", "logdensities", "accept_rate", "swap_rate",
              "step_sizes", "inv_mass", "final_positions"):
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)
    first = tempered_hmc_sample(lp_t, t_(q0), Replay(items[:3 * (W + 3)]),
                                betas=t_(betas), num_warmup=W, num_samples=3,
                                step_offset=off, **kw)
    rest = tempered_hmc_sample(
        lp_t, t_(q0), Replay(items[3 * (W + 3):]), betas=t_(betas),
        num_warmup=0, num_samples=N - 3, init_all_rungs=first.final_positions,
        adapted=(first.step_sizes, first.inv_mass),
        step_offset=off + W + 3, **kw)
    close(rest.samples, want.samples[3:], **CHAIN_TOL)
    close(rest.final_positions, want.final_positions, **CHAIN_TOL)


def test_tempered_step_offset_controls_swap_parity():
    """tests/test_bayes.py:449: with two rungs only pair 0 exists, proposed
    on even global steps only."""
    init = torch.zeros(2, 3, dtype=torch.float64)
    kw = dict(betas=[1.0, 0.5], num_warmup=0, num_samples=1,
              num_integration_steps=4, init_all_rungs=init.expand(2, 2, 3),
              adapted=(torch.full((2,), 0.2, dtype=torch.float64),
                       torch.ones(2, 3, dtype=torch.float64)))

    def lp(q):
        return -0.5 * torch.sum(q * q, dim=-1)

    assert float(tempered_hmc_sample(lp, init, 0, step_offset=1,
                                     **kw).swap_rate) == 0.0
    assert max(float(tempered_hmc_sample(lp, init, k, step_offset=0,
                                         **kw).swap_rate)
               for k in range(4)) > 0.0


def test_vi_equals_jax_with_its_draws():
    """vi.py:58, 98: one key a step, then fold_in(key, 1) for the draws."""
    lp_j, lp_t = targets()
    C, W, N = 3, 6, 4
    q0, key = inits(C), jax.random.PRNGKey(10)
    want = jax.jit(lambda q, k: jvi.vi_posterior_sample(
        lp_j, q, k, num_warmup=W, num_samples=N))(jnp.asarray(q0), key)
    rp = Replay()
    for k in jax.random.split(key, W):
        rp.add("normal", jax.random.normal(k, (C, P), jnp.float64))
    rp.add("normal", jax.random.normal(jax.random.fold_in(key, 1),
                                       (N * C, P), jnp.float64))
    got = vi_posterior_sample(lp_t, t_(q0), rp, num_warmup=W, num_samples=N,
                              chunk=5)
    for f in ("samples", "logdensities", "elbo", "mu", "log_sigma"):
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)


def test_minibatch_sgld_equals_jax_with_its_draws():
    """sgld.py:141-186: a step's key splits into the rows' and the
    noise's; kept draws every ``thin`` steps, the step size decaying."""
    X, y = data()
    C, W, N, thin, batch = 3, 4, 3, 2, 16
    q0, key = inits(C), jax.random.PRNGKey(11)
    kw = dict(num_warmup=W, num_samples=N, thin=thin, step_size=1e-4,
              step_decay=0.3)
    vg_j = jsgld.make_minibatch_value_and_grad(jnp.asarray(X), jnp.asarray(y),
                                               D, S, M, batch)
    want = jax.jit(lambda q, k: jsgld.sgld_sample(vg_j, q, k, **kw))(
        jnp.asarray(q0), key)
    rp = Replay()
    for k in jax.random.split(key, W + N * thin):
        kb, kn = jax.random.split(k)
        rp.add("randint", jax.random.randint(kb, (batch,), 0, len(X)))
        rp.add("normal", jax.random.normal(kn, (C, P), jnp.float64))
    got = sgld_sample(make_minibatch_value_and_grad(
        torch.as_tensor(X), torch.as_tensor(y), D, S, M, batch), t_(q0), rp,
        **kw)
    assert not rp.items
    for f in ("samples", "logdensities", "step_size", "precond"):
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)
    assert int(got.nonfinite) == int(want.nonfinite)
