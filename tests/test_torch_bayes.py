"""The port's Bayes layer (``scfgp_tpu_torch/bayes/``) against the JAX
package's (``scfgp_tpu/bayes/``) on the CPU: diagnostics, the chain-batched
log posterior, leapfrog, the adaptation states, the tempering ladder and
the predictive mixture.  Whole chains are in ``test_torch_bayes_chains.py``
and ``fit_bayes`` in ``test_torch_bayes_fit.py``; this file also holds the
helpers they share.

Tolerances:
  * diagnostics: bitwise (the port's module is a copy of NumPy code);
  * the log posterior's value and gradient with a chain axis against
    ``jax.vmap(jax.value_and_grad(logpost))`` in float64: rtol 1e-9, the
    gradient's atol 1e-9 of its largest entry (the same math in another
    summation order through a 2K x 2K Cholesky, as
    tests/test_torch_sweeps.py);
  * leapfrog, dual averaging, Welford, the ladder and the predictive
    mixture in float64: rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.bayes import diagnostics as jdiag
from scfgp_tpu.bayes import hmc as jhmc
from scfgp_tpu.bayes import tempering as jtemp
from scfgp_tpu.bayes.predictive import (make_logposterior as jax_logpost,
                                        predictive_mixture as jax_mixture)
from scfgp_tpu.models.params import init_params as jax_init_params
from scfgp_tpu.models.params import pack_params as jax_pack
from scfgp_tpu_torch.bayes import (batched_value_and_grad, diagnostics,
                                   energy_matched_ladder, leapfrog,
                                   make_logposterior, predictive_mixture,
                                   reduced_dim)
from scfgp_tpu_torch.bayes import hmc as thmc
from scfgp_tpu_torch.bayes.tempering import geometric_ladder
from scfgp_tpu_torch.data.datasets import synthetic_gp_rff

torch.set_num_threads(1)

RTOL = 1e-9
D, S, M = 2, 2, 4
P = reduced_dim(D, S, M)


def data(n=64, seed=0):
    return synthetic_gp_rff(n=n, d=D, s=S, m=M, noise_std=0.1, seed=seed,
                            dtype=np.float64)


def inits(C, seed=1):
    """C random positions in the reduced space, from the JAX package's
    init."""
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    return np.stack([np.asarray(jax_pack(jax_init_params(
        k, D, S, M, jnp.float64)))[:P] for k in keys])


def targets(**kw):
    """The JAX and the port's log posterior of ``data()``."""
    X, y = data()
    return (jax_logpost(jnp.asarray(X), jnp.asarray(y), D, S, M, **kw),
            make_logposterior(torch.as_tensor(X), torch.as_tensor(y), D, S,
                              M, **kw))


def t_(a):
    return torch.as_tensor(np.array(a))


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want),
                               **(tol or dict(rtol=RTOL)))


class Replay:
    """JAX's draws, served in the order a port sampler asks for them."""

    def __init__(self, items=()):
        self.items = list(items)

    def add(self, kind, a):
        self.items.append((kind, np.array(a)))

    def _next(self, kind, shape):
        k, a = self.items.pop(0)
        assert k == kind and a.shape == tuple(shape), (k, kind, a.shape,
                                                       shape)
        return torch.as_tensor(a)

    def normal(self, shape):
        return self._next("normal", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def bernoulli(self, shape):
        return self._next("bernoulli", shape)

    def randint(self, high, shape):
        return self._next("randint", shape)


# -- diagnostics ---------------------------------------------------------


def _draws(kind):
    rng = np.random.RandomState(3)
    if kind == "random":
        return rng.randn(60, 4, 3)
    if kind == "stuck":
        x = rng.randn(60, 4, 3)
        x[:, 0] += 5.0          # one chain in another place
        x[:, 1, 2] = 0.25       # and a constant coordinate
        return x
    if kind == "ties":  # runs of equal values, and NaN
        x = np.round(rng.randn(40, 4, 3), 1)
        x[5, 2, 0] = x[9, 1, 0] = np.nan
        return x
    t = np.arange(61)[:, None, None]  # odd length: a dropped draw
    return 0.05 * t + rng.randn(61, 3, 2)


@pytest.mark.parametrize("kind", ["random", "stuck", "trending", "ties"])
def test_diagnostics_equal_jax_bitwise(kind):
    x = _draws(kind)
    for fn in ("split_rhat", "ess_bulk", "ess_tail", "ess_mean"):
        np.testing.assert_array_equal(getattr(diagnostics, fn)(x),
                                      getattr(jdiag, fn)(x))
        np.testing.assert_array_equal(getattr(diagnostics, fn)(x[..., 0]),
                                      getattr(jdiag, fn)(x[..., 0]))
    lds = x.sum(axis=-1)
    got = diagnostics.diagnose(x, divergences=3, logdensities=lds)
    want = jdiag.diagnose(x, divergences=3, logdensities=lds)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.summary() == want.summary()
    assert got.converged == want.converged


# -- the log posterior ---------------------------------------------------


def _basis(X):
    return X[:, :1] * 0.5


@pytest.mark.parametrize("kw", [
    {}, dict(include_phases=True),
    dict(temperature=2.5, n_scale=1000,
         phases=(np.full(S, 0.3), np.full(M, -0.2))),
    dict(basis_fn=_basis)],
    ids=["reduced", "phases", "temperature-nscale-pinned", "basis"])
def test_logposterior_value_and_grad_equal_jax(kw):
    lp_j, lp_t = targets(**kw)
    if kw.get("include_phases"):
        keys = jax.random.split(jax.random.PRNGKey(2), 3)
        thetas = np.stack([np.asarray(jax_pack(jax_init_params(
            k, D, S, M, jnp.float64))) for k in keys])
    else:
        thetas = inits(3)
    ld_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(lp_j)))(
        jnp.asarray(thetas))
    ld_t, g_t = batched_value_and_grad(lp_t)(t_(thetas))
    close(ld_t, ld_j)
    close(g_t, g_j, rtol=RTOL, atol=RTOL * float(np.abs(g_j).max()))
    close(lp_t(t_(thetas[0])), ld_j[0])  # one chain, no chain axis


# -- leapfrog, dual averaging, Welford -----------------------------------


@pytest.mark.parametrize("case", ["shared-scalar", "per_chain", "zero_steps"])
def test_leapfrog_equals_jax(case):
    """Shared mass and one step size; a mass and a step size a chain; and
    L = 0, the identity."""
    lp_j, lp_t = targets()
    C, steps = 3, (0 if case == "zero_steps" else 5)
    q0 = inits(C)
    rng = np.random.RandomState(4)
    p0 = rng.randn(C, P)
    if case == "shared-scalar":
        im, e = rng.uniform(0.5, 2.0, P), 0.01
    else:
        im, e = rng.uniform(0.5, 2.0, (C, P)), rng.uniform(0.005, 0.02, C)
    vg = jax.jit(jax.vmap(jax.value_and_grad(lp_j)))
    q_j, p_j, ld_j = jhmc.leapfrog(vg, jnp.asarray(q0), jnp.asarray(p0),
                                   jnp.asarray(e), jnp.asarray(im), steps)
    q_t, p_t, ld_t = leapfrog(batched_value_and_grad(lp_t), t_(q0), t_(p0),
                              e if np.ndim(e) == 0 else t_(e), t_(im), steps)
    for got, want in ((q_t, q_j), (p_t, p_j), (ld_t, ld_j)):
        close(got, want)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "fleet"])
def test_adaptation_states_equal_jax(shared):
    C = 4
    rng = np.random.RandomState(5)
    shape = () if shared else (C,)
    da_t = thmc.da_init(0.003, torch.float64, shape=shape)
    da_j = jax.tree.map(lambda x: jnp.broadcast_to(x, shape),
                        jhmc.da_init(0.003, jnp.float64))
    wf_t = thmc.welford_init(P, torch.float64, shape=shape)
    wf_t = wf_t._replace(m2=wf_t.m2 + 1.0)
    wf_j = jhmc.welford_init(P, jnp.float64)
    wf_j = jax.tree.map(lambda x: jnp.broadcast_to(x, shape + x.shape),
                        wf_j._replace(m2=wf_j.m2 + 1.0))
    for _ in range(12):
        acc = rng.uniform(size=shape)
        q = rng.randn(C, P)
        da_t = thmc.da_update(da_t, t_(acc), target=0.8)
        wf_t = thmc.welford_add_batch(wf_t, t_(q if shared else q[:, None]))
        if shared:
            da_j = jhmc.da_update(da_j, jnp.asarray(acc), target=0.8)
            wf_j = jhmc.welford_add_batch(wf_j, jnp.asarray(q))
        else:
            da_j = jax.vmap(lambda s, a: jhmc.da_update(s, a, target=0.8))(
                da_j, jnp.asarray(acc))
            wf_j = jax.vmap(jhmc.welford_add_batch)(wf_j,
                                                    jnp.asarray(q)[:, None])
    for got, want in zip(da_t + wf_t, da_j + wf_j):
        close(got, want)
    var_j = (jhmc.welford_variance(wf_j) if shared
             else jax.vmap(jhmc.welford_variance)(wf_j))
    close(thmc.welford_variance(wf_t), var_j)


# -- the ladder and the mixture -------------------------------------------


@pytest.mark.parametrize("shape", ["pooled", "per_chain"])
def test_energy_matched_ladder_equals_jax(shape):
    lp_j, lp_t = targets()
    rng = np.random.RandomState(6)
    pos = inits(4)[None] + 0.05 * rng.randn(5, 4, P)
    if shape == "pooled":
        pos = pos.reshape(-1, P)
    want = jtemp.energy_matched_ladder(jax.jit(lp_j), jnp.asarray(pos),
                                       target_gap=0.75, max_rungs=12)
    got = energy_matched_ladder(lp_t, t_(pos), target_gap=0.75,
                                max_rungs=12, chunk=7)
    assert got.shape == want.shape
    close(got, want)
    close(geometric_ladder(5, 0.02, torch.float64),
          jtemp.geometric_ladder(5, 0.02, jnp.float64))


@pytest.mark.parametrize("recalibrate,space", [
    (False, "reduced"), (True, "reduced"), (True, "full")])
def test_predictive_mixture_equals_jax(recalibrate, space):
    """11 draws in chunks of 4: the last chunk is padded."""
    X, y = data(n=80)
    Xt, yt, Xs = X[:60], y[:60], X[60:]
    rng = np.random.RandomState(7)
    thetas = inits(1)[0] + 0.05 * rng.randn(11, P)
    if space == "full":
        thetas = np.concatenate([thetas, rng.uniform(0, 6, (11, S + M))], 1)
    mu_j, sd_j = jax_mixture(jnp.asarray(thetas), jnp.asarray(Xt),
                             jnp.asarray(yt), jnp.asarray(Xs), D, S, M,
                             chunk=4, recalibrate=recalibrate)
    mu_t, sd_t = predictive_mixture(t_(thetas), t_(Xt), t_(yt), t_(Xs), D,
                                    S, M, chunk=4, recalibrate=recalibrate)
    close(mu_t, mu_j)
    close(sd_t, sd_j)


# -- the residual form of the data-fit term --------------------------------


@pytest.mark.parametrize("case", ["plain", "weighted", "basis", "trials"])
def test_residual_fit_equals_reference_form_float64(case):
    """``loss_fn(residual_fit=True)`` is the reference's cost in exact
    arithmetic: value and gradient in float64 at rtol 1e-10, with padding
    weights, a composite basis and a trial axis."""
    from scfgp_tpu_torch.models.objective import loss_fn
    from scfgp_tpu_torch.models.params import unpack_params
    X, y = (torch.as_tensor(a) for a in data(n=80, seed=3))
    q = t_(inits(3))
    th = torch.cat([q, torch.zeros(3, S + M, dtype=q.dtype)], 1)
    kw = {}
    if case == "weighted":
        kw["w"] = torch.as_tensor(np.r_[np.ones(60), np.zeros(20)])
    if case == "basis":
        kw["basis_fn"] = _basis
    if case == "trials":
        th, X, y = th, X.expand(3, *X.shape), y.expand(3, *y.shape)
    else:
        th = th[0]
    vals = []
    for rf in (False, True):
        t = th.clone().requires_grad_()
        cost, _ = loss_fn(unpack_params(t, D, S, M), X, y, residual_fit=rf,
                          **kw)
        g, = torch.autograd.grad(cost.sum(), t)
        vals.append((cost.detach(), g))
    close(vals[1][0], vals[0][0].numpy(), rtol=1e-10)
    close(vals[1][1], vals[0][1].numpy(), rtol=1e-10,
          atol=1e-10 * float(vals[0][1].abs().max()))


def test_residual_fit_is_accurate_in_float32_where_the_noise_is_small():
    """At a small noise variance the reference's ``yᵀy - βᵀβ`` cancels in
    float32; the residual form's error against float64 is at least ten
    times smaller (the log posterior the samplers take)."""
    from scfgp_tpu_torch.models.objective import loss_fn
    from scfgp_tpu_torch.models.params import unpack_params
    X, y = (torch.as_tensor(a) for a in data(n=2000, seed=4))
    th = torch.cat([t_(inits(1))[0], torch.zeros(S + M, dtype=torch.float64)])
    th[0] = -4.0  # sigma_n^2 = exp(2a) ~ 3e-4
    err = {}
    for rf in (False, True):
        c = {dt: float(loss_fn(unpack_params(th.to(dt), D, S, M), X.to(dt),
                               y.to(dt), residual_fit=rf)[0]) * len(X) / 2
             for dt in (torch.float64, torch.float32)}
        err[rf] = abs(c[torch.float32] - c[torch.float64])
    assert err[True] * 10 <= err[False], err


def test_precision_experiment_switches_the_samplers_data_fit_form():
    """experiments/bayes_precision.py's ``reference_form`` puts the
    reference's data-fit term into the samplers' log posterior for its
    block only (float32, where the two forms differ)."""
    from scfgp_tpu_torch.experiments import bayes_precision as bp
    from scfgp_tpu_torch.models.objective import loss_fn
    from scfgp_tpu_torch.models.params import unpack_params
    X, y = (torch.as_tensor(a, dtype=torch.float32)
            for a in data(n=500, seed=5))
    th = t_(inits(1)).float()
    th[0, 0] = -3.0
    lp = make_logposterior(X, y, D, S, M)
    full = torch.cat([th, torch.zeros(1, S + M)], 1)

    def want(rf):
        cost, _ = loss_fn(unpack_params(full, D, S, M), X[None], y[None],
                          residual_fit=rf)
        return -0.5 * len(X) * cost

    with bp.reference_form():
        assert torch.equal(lp(th), want(False))
    assert torch.equal(lp(th), want(True))
    assert not torch.equal(want(True), want(False))
