"""K2, the Phi-free sufficient statistics: the port's plain versions and
its autograd Function against the JAX package's Pallas kernels (interpret
mode on the CPU) and its XLA statistics, and the CUDA wrappers on CPU
tensors.  The kernels themselves are tested on the card by
tests/test_torch_cuda.py.

Tolerances, each with its reason:
  * f32 forward against the Pallas kernel: rtol 2e-4, atol 2e-4 on phiTphi
    and phiTy, rtol 1e-5 on yTy, n exact: the Pallas tests' own
    (tests/test_pallas_gram.py:31-36);
  * f32 backward against the Pallas kernel: 1e-4 of each output's largest
    entry, the tolerance of the feature map's backward against its Pallas
    kernel (tests/test_torch_train_grad.py): f32 sums in another order;
  * f64 against ``jax.vjp`` of the XLA statistics, and the entry against
    the port's dense statistics: rtol 1e-8 and 1e-12, the same math in
    another summation order (through a 2K-term product for the gradient);
    atols of the same size relative to the largest entry, for entries near
    zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.models import objective as jobj
from scfgp_tpu.models.params import init_params
from scfgp_tpu.ops.gram import _bwd_call, _fwd_call, sufficient_stats_pallas
from scfgp_tpu_torch.models import objective as tobj
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.gram import (SufficientStatsFn, gram_bwd_ref,
                                      sufficient_stats_bwd_cuda,
                                      sufficient_stats_cuda,
                                      sufficient_stats_kernel,
                                      sufficient_stats_ref)

torch.set_num_threads(1)

# Ragged shapes: one row, N and K off every tile size, D from 1 to 9.
SHAPES = [(1, 3, 37), (257, 3, 37), (130, 1, 5), (300, 9, 8)]


def _inputs(n, d, k, seed=0, weighted=True):
    """X, y, w (0 on a third of the rows and 1 elsewhere, as padding
    weighs them, or None), Fcat, pcat, s, and cotangents cbar (2K, 2K),
    pbar (2K,) as NumPy float64."""
    rng = np.random.RandomState(seed)
    w = (np.arange(n) % 3 != 0).astype(np.float64) if weighted else None
    return (rng.randn(n, d), rng.randn(n), w, rng.randn(d, k),
            rng.uniform(0, 2 * np.pi, k), np.float64(0.7),
            rng.randn(2 * k, 2 * k), rng.randn(2 * k))


def _t(arrays, dtype):
    return [None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype)
            for a in arrays]


def _j(arrays, dtype):
    return [None if a is None else jnp.asarray(np.asarray(a), dtype)
            for a in arrays]


def _close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_stats_ref_matches_pallas_interpret_f32(n, d, k, weighted):
    X, y, w, F, p, s, _, _ = _inputs(n, d, k, weighted=weighted)
    want = _fwd_call(*_j((X, y, w, F, p, s), jnp.float32), interpret=True)
    got = sufficient_stats_ref(*_t((X, y, w, F, p, s), torch.float32))
    for name, a, b in zip(("phiTphi", "phiTy"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    assert float(got[3]) == float(want[3])


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_gram_bwd_function_matches_pallas_interpret_f32(n, d, k):
    arrays = [None if a is None else np.asarray(a, np.float32)
              for a in _inputs(n, d, k, seed=1)]
    want = _bwd_call(*_j(arrays, jnp.float32), interpret=True)
    X, y, w, F, p, s, cbar, pbar = _t(arrays, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (F, p, s)]
    got_fn = torch.autograd.grad(SufficientStatsFn.apply(X, y, w, *leaves)[:2],
                                 leaves, grad_outputs=(cbar, pbar))
    for name, a, b in zip(("dFcat", "dpcat", "ds"), got_fn, want):
        _close(a.numpy(), b, 1e-4, name)


def _xla_stats_vjp(X, y, w, F, p, s, cbar, pbar):
    """(dFcat, dpcat, ds) of the JAX package's XLA statistics, f64."""
    def stats(F, p, s):
        T = jnp.dot(jnp.asarray(X), F) + p[None, :]
        Phi = s * jnp.concatenate([jnp.cos(T), jnp.sin(T)], axis=1)
        return tuple(jobj.sufficient_stats(
            Phi, jnp.asarray(y), None if w is None else jnp.asarray(w)))
    out, vjp = jax.vjp(stats, *_j((F, p, s), jnp.float64))
    cts = (jnp.asarray(cbar), jnp.asarray(pbar), jnp.ones(()), jnp.ones(()))
    return out, vjp(cts)


@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_ref_and_function_match_jax_vjp_f64(n, d, k, weighted):
    arrays = _inputs(n, d, k, seed=2, weighted=weighted)
    (want_stats, want_grad) = _xla_stats_vjp(*arrays)
    X, y, w, F, p, s, cbar, pbar = _t(arrays, torch.float64)
    stats = sufficient_stats_ref(X, y, w, F, p, s)
    for name, a, b in zip(("phiTphi", "phiTy", "yTy", "n"), stats,
                          want_stats):
        _close(a.numpy(), b, 1e-12, name)
    got_ref = gram_bwd_ref(X, y, w, F, p, s, cbar, pbar)
    # The Function's CPU forward and backward, through autograd.
    leaves = [t.clone().requires_grad_() for t in (F, p, s)]
    out = SufficientStatsFn.apply(X, y, w, *leaves)
    for a, b in zip(out, stats):
        assert torch.equal(a.detach(), b)
    got_fn = torch.autograd.grad(out[:2], leaves, grad_outputs=(cbar, pbar))
    for name, want, a, b in zip(("dFcat", "dpcat", "ds"), want_grad, got_ref,
                                got_fn):
        _close(a.numpy(), want, 1e-8, name)
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)


def test_function_ignores_ytyn_cotangents_and_gives_data_no_gradient():
    X, y, w, F, p, s, cbar, pbar = _t(_inputs(40, 3, 6), torch.float64)
    before = (sufficient_stats_cuda.launches,
              sufficient_stats_bwd_cuda.launches)
    data = [t.clone().requires_grad_() for t in (X, y, w)]
    leaves = [t.clone().requires_grad_() for t in (F, p, s)]
    out = SufficientStatsFn.apply(*data, *leaves)
    ones = torch.ones(())
    grads = torch.autograd.grad(out, data + leaves,
                                grad_outputs=(cbar, pbar, ones, ones),
                                allow_unused=True)
    assert grads[:3] == (None, None, None)
    for a, b in zip(grads[3:], gram_bwd_ref(X, y, w, F, p, s, cbar, pbar)):
        assert torch.equal(a, b)
    assert (sufficient_stats_cuda.launches,
            sufficient_stats_bwd_cuda.launches) == before


def _params(seed, D, S, M):
    return [np.asarray(a) for a in
            init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)]


@pytest.mark.parametrize("weighted", [True, False])
def test_entry_matches_jax_pallas_and_dense_stats(weighted):
    """sufficient_stats_kernel against sufficient_stats_pallas (f32,
    interpret, the Pallas tests' tolerances) and against the port's dense
    statistics (f64, rtol 1e-12)."""
    theta = _params(3, 5, 4, 7)
    X, y, w = _inputs(300, 5, 1, seed=3, weighted=weighted)[:3]
    want = sufficient_stats_pallas(
        jobj.SCFGPParams(*_j(theta, jnp.float32)),
        *_j((X, y, w), jnp.float32), interpret=True)
    got = sufficient_stats_kernel(params_from_numpy(theta, torch.float32),
                                  *_t((X, y, w), torch.float32))
    for name in ("phiTphi", "phiTy"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    np.testing.assert_allclose(float(got.yTy), float(want.yTy), rtol=1e-5)
    assert float(got.n) == float(want.n)
    p64 = params_from_numpy(theta, torch.float64)
    X, y, w = _t((X, y, w), torch.float64)
    got = sufficient_stats_kernel(p64, X, y, w)
    ref = tobj.sufficient_stats(tobj.fourier_features(p64, X), y, w)
    for name, a, b in zip(got._fields, got, ref):
        _close(a.numpy(), b.numpy(), 1e-12, name)


def test_raw_wrappers_refuse_cpu_and_grad_tensors():
    X, y, w, F, p, s, cbar, pbar = _t(_inputs(10, 3, 5), torch.float32)
    before = (sufficient_stats_cuda.launches,
              sufficient_stats_bwd_cuda.launches)
    with pytest.raises(ValueError, match="expected the CUDA device"):
        sufficient_stats_cuda(X, y, w, F, p, s)
    with pytest.raises(ValueError, match="expected the CUDA device"):
        sufficient_stats_bwd_cuda(X, y, None, F, p, s, cbar, pbar)
    with pytest.raises(RuntimeError, match="requires grad"):
        sufficient_stats_cuda(X, y, w, F.requires_grad_(), p, s)
    with pytest.raises(RuntimeError, match="requires grad"):
        sufficient_stats_bwd_cuda(X, y, w, F.detach(), p, s,
                                  cbar.requires_grad_(), pbar)
    assert (sufficient_stats_cuda.launches,
            sufficient_stats_bwd_cuda.launches) == before
