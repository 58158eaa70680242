"""The port's literal Gauss-Hermite rule (``ops/quadrature.py``) against the
JAX package's and against the port's closed form, in float64: both at
rtol 1e-12, the tolerance of ``tests/test_objective.py:83``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.ops import quadrature as jq
from scfgp_tpu_torch.models.objective import expected_nll_rows
from scfgp_tpu_torch.ops import quadrature as tq

torch.set_num_threads(1)


def _rows(seed, n=40):
    rng = np.random.RandomState(seed)
    return (rng.randn(n), rng.rand(n) * 0.5, rng.randn(n),
            0.3 + rng.rand())


def test_nodes_equal_jax():
    for a, b in zip(tq.hermgauss(30), jq.hermgauss(30)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gh_equals_jax_and_the_closed_form(seed):
    mu, var, y, noise = _rows(seed)
    ours = tq.expected_nll_rows_gh(*(torch.tensor(a) for a in (mu, var, y)),
                                   noise)
    theirs = jq.expected_nll_rows_gh(*(jnp.asarray(a) for a in (mu, var, y)),
                                     noise)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12)
    closed = expected_nll_rows(torch.tensor(mu), torch.tensor(var),
                               torch.tensor(y),
                               torch.tensor(noise, dtype=torch.float64))
    np.testing.assert_allclose(closed.numpy(), ours.numpy(), rtol=1e-12)
