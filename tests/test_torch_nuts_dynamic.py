"""The dynamic NUTS and the host-looped samplers of the port against the
JAX package's on the CPU, in float64, and the samplers in law.

The two packages draw from different generators, so the port's samplers
are given JAX's draws (``Replay``), built from JAX's own key tree in the
order the port asks for them: a dynamic transition draws the momentum, then
for every doubling j < max_depth the direction, the 2^j leaf uniforms and
the merge uniform, whatever depth its chains reach.  The leaf keys are a
sequential split of the subtree's key (``scfgp_tpu/bayes/nuts.py:130``).
Tolerance: ``CHAIN_TOL`` (tests/test_torch_bayes_chains.py), the
divergences exactly, the mean depth at rtol 1e-6 (JAX averages the depths
in float32, ``nuts.py:323``).

In law: the moment tests of tests/test_bayes.py:48-56 and :145-164 with
their tolerances, at cut budgets from fixed seeds of the port's generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.bayes import hmc as jhmc
from scfgp_tpu.bayes import nuts as jnuts
from scfgp_tpu_torch.bayes import (hmc_sample_host_looped, nuts_sample,
                                   nuts_sample_host_looped)
from test_torch_bayes import P, Replay, close, inits, t_, targets
from test_torch_bayes_chains import CHAIN_TOL
from test_torch_bayes_fit import COV, MEAN, _gauss, _gauss_init

torch.set_num_threads(1)

FIELDS = ("samples", "logdensities", "accept_rate", "step_size", "inv_mass")


def _dynamic_items(keys, C, max_depth):
    """nuts.py:129-132, 178-201, 286-290: a transition's key splits into
    one a chain, each into the momentum's and the loop's; the loop's splits
    into four a doubling (the loop's next, the direction's, the subtree's
    and the merge's), the subtree's sequentially into one a leaf."""
    rp = Replay()
    for k in keys:
        per_chain = []
        for kc in jax.random.split(k, C):
            k_mom, k_loop = jax.random.split(kc)
            seq = [jax.random.normal(k_mom, (P,), jnp.float64)]
            for j in range(max_depth):
                k_loop, k_dir, k_sub, k_merge = jax.random.split(k_loop, 4)
                leaves = []
                for _ in range(1 << j):
                    k_sub, ku = jax.random.split(k_sub)
                    leaves.append(jax.random.uniform(ku))
                seq += [jax.random.bernoulli(k_dir), np.array(leaves),
                        jax.random.uniform(k_merge)]
            per_chain.append([np.asarray(a) for a in seq])
        rp.add("normal", np.stack([s[0] for s in per_chain]))
        for j in range(max_depth):
            rp.add("bernoulli", np.stack([s[1 + 3 * j] for s in per_chain]))
            rp.add("uniform", np.stack([s[2 + 3 * j] for s in per_chain], 1))
            rp.add("uniform", np.stack([s[3 + 3 * j] for s in per_chain]))
    return rp


@pytest.mark.parametrize("host_looped", [False, True],
                         ids=["nuts_sample", "host_looped"])
@pytest.mark.parametrize("step", [0.01, 0.2])
def test_dynamic_nuts_equals_jax_with_its_draws(host_looped, step):
    """Three chains, max_depth 4: the small step runs every transition to
    the full depth; the large one turns and diverges at other depths per
    chain, so chains stop while others go on."""
    lp_j, lp_t = targets()
    C, W, N, md = 3, 4, 4, 4
    q0, key = inits(C), jax.random.PRNGKey(12)
    kw = dict(num_warmup=W, num_samples=N, max_depth=md,
              init_step_size=step)
    if host_looped:
        want = jnuts.nuts_sample_host_looped(lp_j, jnp.asarray(q0), key,
                                             **kw)
        keys = jax.random.split(key, W + N)
        got = nuts_sample_host_looped(lp_t, t_(q0),
                                      rp := _dynamic_items(keys, C, md), **kw)
    else:
        want = jax.jit(lambda q, k: jnuts.nuts_sample(lp_j, q, k, **kw))(
            jnp.asarray(q0), key)
        keys = jax.random.split(key, W + N + 1)[:W + N]
        got = nuts_sample(lp_t, t_(q0), rp := _dynamic_items(keys, C, md),
                          **kw)
        close(got.final_positions, want.final_positions, **CHAIN_TOL)
    assert not rp.items
    for f in FIELDS:
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)
    close(got.mean_depth, want.mean_depth, rtol=1e-6)
    assert int(got.divergences) == int(want.divergences)
    assert got.depths.shape == (W + N, C)
    # One batched gradient a transition's start, one a leaf.
    assert got.gradients <= int((2 ** got.depths.max(dim=1).values).sum())


def test_host_looped_hmc_equals_jax_with_its_draws():
    """hmc.py:225-247: keys = split(key, W + N), each into the momentum's
    and the accept test's; one adaptation shared by the chains."""
    lp_j, lp_t = targets()
    C, W, N = 3, 6, 6
    q0, key = inits(C), jax.random.PRNGKey(13)
    kw = dict(num_warmup=W, num_samples=N, num_integration_steps=4,
              init_step_size=0.01)
    want = jhmc.hmc_sample_host_looped(lp_j, jnp.asarray(q0), key, **kw)
    rp = Replay()
    for k in jax.random.split(key, W + N):
        k1, k2 = jax.random.split(k)
        rp.add("normal", jax.random.normal(k1, (C, P), jnp.float64))
        rp.add("uniform", jax.random.uniform(k2, (C,)))
    got = hmc_sample_host_looped(lp_t, t_(q0), rp, **kw)
    assert not rp.items
    for f in FIELDS:
        close(getattr(got, f), getattr(want, f), **CHAIN_TOL)
    assert int(got.divergences) == int(want.divergences)


def test_dynamic_nuts_recovers_gaussian_moments():
    """tests/test_bayes.py:48-56 (400 + 800 transitions there)."""
    res = nuts_sample(_gauss, _gauss_init(8, 1), 1, num_warmup=150,
                      num_samples=300, max_depth=6, init_step_size=0.1)
    draws = res.samples.reshape(-1, 3).numpy()
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert float(res.mean_depth) >= 1.0  # trees actually expand
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.5)


def test_host_looped_samplers_match_semantics():
    """tests/test_bayes.py:145-164 (150 + 250 NUTS, 300 + 500 HMC there)."""
    res = nuts_sample_host_looped(_gauss, _gauss_init(4, 6), 12,
                                  num_warmup=100, num_samples=200,
                                  max_depth=6, init_step_size=0.1)
    draws = res.samples.reshape(-1, 3).numpy()
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert float(res.mean_depth) >= 1.0
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.3)
    res = hmc_sample_host_looped(_gauss, _gauss_init(4, 5), 7,
                                 num_warmup=200, num_samples=400,
                                 num_integration_steps=12,
                                 init_step_size=0.1)
    draws = res.samples.reshape(-1, 3).numpy()
    assert 0.4 < float(res.accept_rate) <= 1.0
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.25)


def test_a_stopped_chain_is_frozen_while_the_others_build():
    """A chain whose log density is not finite diverges at its first leaf
    and keeps its position; the others build deeper trees and move."""
    def lp(q):
        ld = -0.5 * torch.sum(q * q, dim=-1)
        return torch.where(q[:, 0] > 50.0, torch.full_like(ld, float("nan")),
                           ld)

    q0 = torch.zeros(3, 2, dtype=torch.float64)
    q0[0, 0] = 100.0
    res = nuts_sample(lp, q0, 0, num_warmup=0, num_samples=3, max_depth=4,
                      adapted=(torch.tensor(0.3, dtype=torch.float64),
                               torch.ones(2, dtype=torch.float64)))
    assert torch.equal(res.samples[:, 0], q0[0].expand(3, 2))
    assert bool((res.depths[:, 0] == 1).all())
    assert bool((res.depths[:, 1:] >= 2).all())
    assert int(res.divergences) == 3
    assert bool((res.samples[-1, 1:] != 0).all())


def test_bench_hmc_driver_runs_every_leg_on_the_cpu(tmp_path, monkeypatch):
    """experiments/bench_hmc.py --cpu at a tiny size: one line a leg with
    its fields; --mode host, JAX's, runs the same legs."""
    from scfgp_tpu_torch.experiments import bench_hmc
    monkeypatch.setattr(bench_hmc, "S", 2)
    monkeypatch.setattr(bench_hmc, "M", 4)
    out = bench_hmc.main(["--cpu", "--n", "120", "--chains", "3",
                          "--warmup", "3", "--samples", "4",
                          "--out", str(tmp_path)])
    assert set(out) == {"hmc", "nuts", "nuts_static", "sgld_b256"}
    for leg, r in out.items():
        assert r["samples_per_s"] > 0 and r["gradients"] > 0, leg
        assert r["dim"] == 3 + 8 * 2 + 4 * 2
    assert out["nuts_static"]["gradients"] == 7 * 32
    assert 1.0 <= out["nuts"]["mean_depth"] <= 6.0
    host = bench_hmc.main(["--cpu", "--n", "120", "--chains", "3",
                           "--warmup", "2", "--samples", "2", "--mode",
                           "host", "--legs", "hmc,nuts",
                           "--out", str(tmp_path)])
    assert set(host) == {"hmc", "nuts"}
    assert (tmp_path / "bench_hmc.json").exists()
