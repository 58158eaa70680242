"""The streaming objective: the port's ``loss_fn_streaming`` on both of its
stats routes against the JAX package's ``loss_fn_streaming`` and against
the port's dense ``loss_fn``, in value and gradient; and the large
synthetics against the JAX package's.  The cases are those of
tests/test_streaming.py.  The blocks' hand-written backwards against
plain autograd through the same block bodies, and the row-sized products
and feature-map recomputes one backward makes.

Tolerances, each with its reason:
  * f64 value: rtol 1e-12 on the cost and 1e-9 on the posterior mean, the
    JAX package's own streaming-against-dense tolerances (the same sums in
    another block order);
  * f64 gradient: rtol 1e-8, atol 1e-12 (tests/test_streaming.py:40-41);
  * f32, the port's kernel route against the JAX package's Pallas route in
    interpret mode: rtol 2e-4 on the cost, rtol 1e-2 and atol 1e-3 on the
    gradient, the JAX package's own tolerances for that route against the
    dense path (tests/test_streaming.py:80-87): f32 rounding through a 2K x
    2K Cholesky;
  * the hand-written block backwards against autograd through the same
    bodies, f64: the value bitwise (the same forward), each gradient entry
    rtol 1e-10 (the same algebra in another order: Phi (C̄ + C̄ᵀ) for
    C̄ᵀ-and-C̄ products, closed-form row cotangents for autograd's chain);
    atol 1e-12 on the phases alone: a phase rotates its (cos, sin) pair of
    columns, which the objective does not see, so their gradient is zero
    in exact arithmetic and both sides read rounding (~1e-16).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scfgp_tpu.data import datasets as jdata
from scfgp_tpu.models import objective as jobj
from scfgp_tpu.models.params import init_params
from scfgp_tpu.ops.streaming import loss_fn_streaming as jax_streaming
from scfgp_tpu_torch.data import datasets as tdata
from scfgp_tpu_torch.models import objective as tobj
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.gram import (sufficient_stats_bwd_cuda,
                                      sufficient_stats_cuda)
from scfgp_tpu_torch.ops import streaming
from scfgp_tpu_torch.ops.streaming import (loss_and_grad_streaming,
                                           loss_fn_streaming,
                                           streaming_posterior)

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



class _PlainStats:
    """Pass 1's block by autograd through its body, as the block was
    differentiated before its backward was written by hand."""

    @staticmethod
    def apply(st, *rows):
        return st.stats_block(*rows)


class _PlainEnll:
    @staticmethod
    def apply(st, residual_fit, *rows):
        return st.enll_block(*rows, residual_fit)


def _basis(Xi):
    return torch.stack([torch.ones_like(Xi[:, 0]), Xi[:, 0]], dim=1)


def _trials_problem(trials, seed):
    """θ for ``trials`` trials (none: 2-D leaves), each from its own JAX
    init, and the data."""
    theta, X, y = _problem(96, seed)
    if trials:
        thetas = [_problem(1, seed + 10 * (b + 1))[0] for b in range(trials)]
        theta = [np.stack(leaves) for leaves in zip(*thetas)]
    return theta, X, y


# route, trials, weighted, residual_fit, basis_fn, mm_precision: the kernel
# route takes no trial axis and no basis_fn.
BLOCK_CASES = [c for c in itertools.product(
    ROUTES, (0, 3), (False, True), (False, True), (False, True),
    (None, "highest")) if c[0] == "gemm" or not (c[1] or c[4])]


@pytest.mark.parametrize("route,trials,weighted,residual_fit,basis,precision",
                         BLOCK_CASES)
def test_block_backward_matches_autograd_f64(route, trials, weighted,
                                             residual_fit, basis, precision,
                                             monkeypatch):
    theta, X, y = _trials_problem(trials, seed=6)
    w = 0.25 + np.random.RandomState(7).rand(len(y)) if weighted else None
    p, Xt, yt, wt = _port(theta, X, y, w)
    kw = dict(w=wt, block_size=32, stats_impl=route, residual_fit=residual_fit,
              basis_fn=_basis if basis else None, mm_precision=precision)
    (c, _), g = loss_and_grad_streaming(p, Xt, yt, **kw)
    monkeypatch.setattr(streaming, "_StatsBlock", _PlainStats)
    monkeypatch.setattr(streaming, "_EnllBlock", _PlainEnll)
    (c_plain, _), g_plain = loss_and_grad_streaming(p, Xt, yt, **kw)
    assert c.shape == ((trials,) if trials else ())
    assert torch.equal(c, c_plain)
    for name, a, b in zip(g._fields, g, g_plain):
        atol = 1e-12 if name in ("l_phase", "phase") else 0.0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=atol, err_msg=name)


class _CountProducts(TorchDispatchMode):
    """Counts the row-sized matrix products (one of m, k, n the block's
    rows, the other two at least the feature width) and the feature-map
    forwards that run inside it."""

    def __init__(self, rows, width):
        super().__init__()
        self.rows, self.width = rows, width
        self.products = self.features = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name == "phi_fwd":
            self.features += 1
        elif name in ("mm", "bmm", "addmm", "baddbmm", "addmm_",
                      "baddbmm_"):
            a, b = args[-2:] if name.startswith(("addmm", "baddbmm")) \
                else args[:2]
            dims = [a.shape[-2], a.shape[-1], b.shape[-1]]
            if self.rows in dims:
                dims.remove(self.rows)
                self.products += min(dims) >= self.width
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route,trials", [("gemm", 3), ("kernel", 0)])
def test_one_backward_counts_products_and_recomputes(route, trials):
    """Pass 1's block backward on the "gemm" route takes one row-sized
    product and pass 2's three; each recomputes Phi once.  On the CPU the
    "kernel" route's pass 1 backward is the plain K2b (``gram_bwd_ref``),
    which takes its ΦĀ product; on the card K2b takes it in its kernel."""
    rows, blocks = 32, 3
    theta, X, y = _trials_problem(trials, seed=8)
    p, Xt, yt = _port(theta, X, y)
    width = 2 * (p.S + p.M)

    def backward_counts(loss):
        leaves = type(p)(*(t.detach().requires_grad_() for t in p))
        total = loss(leaves)
        with _CountProducts(rows, width) as count:
            torch.autograd.grad(total, leaves, allow_unused=True)
        return count.products, count.features

    pass1 = backward_counts(lambda q: sum(
        t.sum() for t in streaming_posterior(
            q, Xt, yt, block_size=rows, stats_impl=route)[0][:2]))
    both = backward_counts(lambda q: loss_fn_streaming(
        q, Xt, yt, block_size=rows, stats_impl=route)[0].sum())
    assert pass1 == ((blocks, blocks) if route == "gemm" else (blocks, 0))
    assert both == (pass1[0] + 3 * blocks, pass1[1] + blocks)
