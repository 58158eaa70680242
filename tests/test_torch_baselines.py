"""The port's exact-GP baseline (``baselines/exact_gp.py``) against the JAX
package's, in float64 on the CPU.

The NLML and its gradient at seeded parameters agree at rtol 1e-10 (XLA's
and LAPACK's Cholesky in other orders: measured ~1e-14); the 200-step adam
history, the fitted parameters and the predictions at rtol 1e-9 (the same
rounding carried through 200 steps: measured ~1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.baselines import ExactGP as JaxExactGP
from scfgp_tpu.baselines import exact_gp as J
from scfgp_tpu_torch.baselines import ExactGP, exact_gp_fit_predict
from scfgp_tpu_torch.baselines import exact_gp as T

torch.set_num_threads(1)


def _data(n=60, d=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d) * 3
    y = np.sin(X[:, 0]) + 0.5 * np.cos(X[:, -1]) + 0.1 * rng.randn(n)
    return X, y


@pytest.mark.parametrize("seed", [0, 1])
def test_nlml_and_gradient_equal_jax(seed):
    X, y = _data(seed=seed)
    rng = np.random.RandomState(10 + seed)
    p = (0.3 * rng.randn(2), 0.2 * rng.randn(), -0.8 + 0.1 * rng.randn())
    pj = J.GPParams(*(jnp.asarray(a) for a in p))
    vj, gj = jax.value_and_grad(J._nlml)(pj, jnp.asarray(X), jnp.asarray(y))
    pt = T.GPParams(*(torch.tensor(np.asarray(a), dtype=torch.float64)
                      .requires_grad_() for a in p))
    vt = T._nlml(pt, torch.tensor(X), torch.tensor(y))
    gt = torch.autograd.grad(vt, pt)
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-10)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(b)).max())


def test_fit_history_params_and_predictions_equal_jax():
    X, y = _data(n=80, d=2, seed=2)
    ours = ExactGP(device="cpu").fit(X[:60], y[:60])
    theirs = JaxExactGP().fit(X[:60], y[:60])
    assert ours.nlml_history.shape == (200,)
    np.testing.assert_allclose(ours.nlml_history.numpy(),
                               np.asarray(theirs.nlml_history), rtol=1e-9)
    for a, b in zip(ours.params, theirs.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)
    for a, b in zip(ours.predict(X[60:]), theirs.predict(X[60:])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)


def test_exact_gp_recovers_sine_to_noise_floor():
    """``tests/test_baselines.py:9``."""
    rng = np.random.RandomState(0)
    X = rng.rand(250, 1) * 10
    y = np.sin(X[:, 0]) * 2 + 0.1 * rng.randn(250) + 3
    Xt, yt, Xv, yv = X[:200], y[:200], X[200:], y[200:]
    mu, std = exact_gp_fit_predict(Xt, yt, Xv, steps=150, device="cpu")
    nmse = float(np.mean((mu - yv) ** 2) / np.var(yv))
    assert nmse < 0.02, nmse
    assert np.all(std > 0)


def test_exact_gp_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactGP()
