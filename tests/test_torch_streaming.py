"""The streaming objective: the port's ``loss_fn_streaming`` on both of its
stats routes against the JAX package's ``loss_fn_streaming`` and against
the port's dense ``loss_fn``, in value and gradient; and the large
synthetics against the JAX package's.  The cases are those of
tests/test_streaming.py.

Tolerances, each with its reason:
  * f64 value: rtol 1e-12 on the cost and 1e-9 on the posterior mean, the
    JAX package's own streaming-against-dense tolerances (the same sums in
    another block order);
  * f64 gradient: rtol 1e-8, atol 1e-12 (tests/test_streaming.py:40-41);
  * f32, the port's kernel route against the JAX package's Pallas route in
    interpret mode: rtol 2e-4 on the cost, rtol 1e-2 and atol 1e-3 on the
    gradient, the JAX package's own tolerances for that route against the
    dense path (tests/test_streaming.py:80-87): f32 rounding through a 2K x
    2K Cholesky.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.data import datasets as jdata
from scfgp_tpu.models import objective as jobj
from scfgp_tpu.models.params import init_params
from scfgp_tpu.ops.streaming import loss_fn_streaming as jax_streaming
from scfgp_tpu_torch.data import datasets as tdata
from scfgp_tpu_torch.models import objective as tobj
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.gram import (sufficient_stats_bwd_cuda,
                                      sufficient_stats_cuda)
from scfgp_tpu_torch.ops.streaming import (loss_and_grad_streaming,
                                           loss_fn_streaming)

torch.set_num_threads(1)

D, S, M = 4, 3, 6
ROUTES = ["gemm", "kernel"]
TDT = {"float64": torch.float64, "float32": torch.float32}


def _problem(n, seed=0):
    """θ from the JAX init (f64), data from NumPy: the arrays both get."""
    rng = np.random.RandomState(seed)
    theta = [np.asarray(a) for a in
             init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)]
    return theta, rng.randn(n, D), rng.randn(n)


def _jax(theta, *arrays, dtype="float64"):
    return (jobj.SCFGPParams(*[jnp.asarray(a, dtype) for a in theta]),
            *[None if a is None else jnp.asarray(a, dtype) for a in arrays])


def _port(theta, *arrays, dtype="float64"):
    t = TDT[dtype]
    return (params_from_numpy(theta, dtype=t),
            *[None if a is None else torch.as_tensor(a, dtype=t)
              for a in arrays])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n,block", [(100, 32), (256, 64), (50, 128)])
def test_value_matches_jax_streaming_and_dense(route, n, block):
    theta, X, y = _problem(n)
    cj, auxj = jax_streaming(*_jax(theta, X, y), block_size=block)
    p, Xt, yt = _port(theta, X, y)
    c, aux = loss_fn_streaming(p, Xt, yt, block_size=block, stats_impl=route)
    c_dense, aux_dense = tobj.loss_fn(p, Xt, yt)
    for want, want_alpha in ((float(cj), np.asarray(auxj.post.alpha)),
                             (float(c_dense), aux_dense.post.alpha.numpy())):
        np.testing.assert_allclose(float(c), want, rtol=1e-12)
        np.testing.assert_allclose(aux.post.alpha.numpy(), want_alpha,
                                   rtol=1e-9)


@pytest.mark.parametrize("route", ROUTES)
def test_gradient_matches_jax_streaming_and_dense_f64(route):
    theta, X, y = _problem(200, seed=1)
    pj, Xj, yj = _jax(theta, X, y)
    gj = jax.jit(jax.grad(
        lambda q: jax_streaming(q, Xj, yj, block_size=64)[0]))(pj)
    p, Xt, yt = _port(theta, X, y)
    (_, _), g = loss_and_grad_streaming(p, Xt, yt, block_size=64,
                                        stats_impl=route)
    (_, _), g_dense = tobj.loss_and_grad(p, Xt, yt)
    for name, a, b, c in zip(g._fields, g, jax.tree.leaves(gj), g_dense):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("route", ROUTES)
def test_weights_match_jax_streaming_and_dense(route):
    theta, X, y = _problem(90, seed=2)
    w = (np.arange(90) % 3 != 0).astype(np.float64)
    cj, _ = jax_streaming(*_jax(theta, X, y, w), block_size=32)
    p, Xt, yt, wt = _port(theta, X, y, w)
    c, _ = loss_fn_streaming(p, Xt, yt, w=wt, block_size=32,
                             stats_impl=route)
    c_dense, _ = tobj.loss_fn(p, Xt, yt, w=wt)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-12)
    np.testing.assert_allclose(float(c), float(c_dense), rtol=1e-12)


def test_kernel_route_matches_jax_pallas_route_f32():
    theta, X, y = _problem(200, seed=5)
    pj, Xj, yj = _jax(theta, X, y, dtype="float32")

    def jloss(q):
        return jax_streaming(q, Xj, yj, block_size=64, stats_impl="pallas")[0]
    cj, gj = jloss(pj), jax.grad(jloss)(pj)
    p, Xt, yt = _port(theta, X, y, dtype="float32")
    before = (sufficient_stats_cuda.launches,
              sufficient_stats_bwd_cuda.launches)
    (c, _), g = loss_and_grad_streaming(p, Xt, yt, block_size=64,
                                        stats_impl="kernel")
    # On CPU tensors the Function takes the plain versions.
    assert (sufficient_stats_cuda.launches,
            sufficient_stats_bwd_cuda.launches) == before
    np.testing.assert_allclose(float(c), float(cj), rtol=2e-4)
    for name, a, b in zip(g._fields, g, jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2,
                                   atol=1e-3, err_msg=name)


def test_basis_fn_needs_the_gemm_route():
    theta, X, y = _problem(60, seed=4)
    p, Xt, yt = _port(theta, X, y)

    def basis(Xi):
        return torch.stack([torch.ones_like(Xi[:, 0]), Xi[:, 0]], dim=1)

    with pytest.raises(NotImplementedError, match="basis_fn"):
        loss_fn_streaming(p, Xt, yt, block_size=16, stats_impl="kernel",
                          basis_fn=basis)
    c, _ = loss_fn_streaming(p, Xt, yt, block_size=16, basis_fn=basis)
    c_dense, _ = tobj.loss_fn(p, Xt, yt, basis_fn=basis)
    np.testing.assert_allclose(float(c), float(c_dense), rtol=1e-12)


def test_unknown_route_and_block_size_raise():
    theta, X, y = _problem(20)
    p, Xt, yt = _port(theta, X, y)
    with pytest.raises(ValueError, match="stats_impl"):
        loss_fn_streaming(p, Xt, yt, stats_impl="pallas")
    with pytest.raises(ValueError, match="block_size"):
        loss_fn_streaming(p, Xt, yt, block_size=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetics_equal_jax_bitwise(seed):
    for a, b in zip(tdata.synthetic_large(n=300, d=12, seed=seed),
                    jdata.synthetic_large(n=300, d=12, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tdata.synthetic_gp_rff(200, 5, 3, 16, seed=seed),
                    jdata.synthetic_gp_rff(200, 5, 3, 16, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

