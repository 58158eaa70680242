"""The port's gradient against the JAX package: the feature map's backward
(K1b's plain version and the autograd Function's CPU wiring), the
all-GEMM Cholesky backward, and ``loss_and_grad`` against ``jax.grad``.

Tolerances, each with its reason:
  * f64 against the JAX XLA path: rtol 1e-8 (the forward's, as
    tests/test_torch_objective.py: the same math in another summation order,
    through a 2K x 2K Cholesky);
  * f32 against the Pallas backward in interpret mode: rtol 1e-4 of each
    output's largest entry (the Pallas tests' own gradient tolerance,
    tests/test_pallas_phi.py:33-47);
  * phase gradients are pure gauge, zero up to rounding
    (tests/test_objective.py::test_phase_parameters_are_pure_gauge), so they
    are held to an absolute bound relative to the largest gradient entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.models import objective as jobj
from scfgp_tpu.models.params import init_params
from scfgp_tpu.ops.phi import _phi_bwd_call
from scfgp_tpu_torch.models import objective as tobj
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.phi import (FourierFeatures,
                                     fourier_features_bwd_cuda,
                                     fourier_features_cuda,
                                     fourier_features_ref, phi_bwd_ref)

from golden_numpy import golden_cost

torch.set_num_threads(1)

SHAPES = [(1, 3, 37), (257, 3, 37), (130, 1, 5), (300, 5, 8)]
N, D, S, M = 150, 4, 3, 7
TDT = {"float64": torch.float64, "float32": torch.float32}


def _phi_inputs(n, d, k, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d), rng.randn(d, k), rng.uniform(0, 2 * np.pi, k),
            np.float64(0.7), rng.randn(n, 2 * k))


def _t(arrays, dtype):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _xla_vjp(X, F, p, s, g):
    """(dF, dp, ds) of the JAX package's XLA feature map."""
    def phi(F, p, s):
        T = jnp.dot(jnp.asarray(X), F) + p[None, :]
        return s * jnp.concatenate([jnp.cos(T), jnp.sin(T)], axis=1)
    _, vjp = jax.vjp(phi, jnp.asarray(F), jnp.asarray(p), jnp.asarray(s))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_phi_bwd_ref_and_function_match_jax_vjp_f64(n, d, k):
    X, F, p, s, g = _phi_inputs(n, d, k)
    want = _xla_vjp(X, F, p, s, g)
    Xt, Ft, pt, st, gt = _t((X, F, p, s, g), torch.float64)
    got_ref = phi_bwd_ref(Xt, Ft, pt, st, gt)
    # The Function's CPU backward, through autograd.
    leaves = [t.clone().requires_grad_() for t in (Ft, pt, st)]
    Phi = FourierFeatures.apply(Xt, *leaves)
    got_fn = torch.autograd.grad(Phi, leaves, grad_outputs=gt)
    for name, w, a, b in zip(("dFcat", "dpcat", "ds"), want, got_ref, got_fn):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max(), err_msg=name)
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_phi_bwd_ref_matches_pallas_interpret_f32(n, d, k):
    X, F, p, s, g = [np.asarray(a, np.float32)
                     for a in _phi_inputs(n, d, k, seed=1)]
    want = [np.asarray(a) for a in _phi_bwd_call(
        jnp.asarray(X), jnp.asarray(F), jnp.asarray(p), jnp.asarray(s),
        jnp.asarray(g), True)]
    got = phi_bwd_ref(*_t((X, F, p, s, g), torch.float32))
    for name, w, a in zip(("dFcat", "dpcat", "ds"), want, got):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_function_on_cpu_launches_no_kernel_and_serves_inference_mode():
    X, F, p, s, g = _t(_phi_inputs(40, 3, 6), torch.float64)
    before = (fourier_features_cuda.launches,
              fourier_features_bwd_cuda.launches)
    with torch.inference_mode():
        Phi = FourierFeatures.apply(X, F, p, s)
    assert torch.equal(Phi, fourier_features_ref(X, F, p, s))
    leaves = [t.clone().requires_grad_() for t in (F, p, s)]
    dX = torch.autograd.grad(FourierFeatures.apply(X.requires_grad_(),
                                                   *leaves).sum(),
                             [X], allow_unused=True)
    assert dX == (None,)  # X is data: no gradient
    assert (fourier_features_cuda.launches,
            fourier_features_bwd_cuda.launches) == before


def test_raw_bwd_wrapper_refuses_cpu_and_grad_tensors():
    X, F, p, s, g = _t(_phi_inputs(10, 3, 5), torch.float32)
    before = fourier_features_bwd_cuda.launches
    with pytest.raises(ValueError, match="expected the CUDA device"):
        fourier_features_bwd_cuda(X, F, p, s, g)
    with pytest.raises(RuntimeError, match="requires grad"):
        fourier_features_bwd_cuda(X, F.requires_grad_(), p, s, g)
    assert fourier_features_bwd_cuda.launches == before


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    theta = [np.asarray(a) for a in
             init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)]
    return theta, rng.randn(N, D), rng.randn(N)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-8), ("float32", 1e-4)])
def test_loss_and_grad_matches_jax_grad(dtype, rtol):
    """Cost and every gradient leaf against jax.grad(loss_fn); f32 at
    rtol 1e-4, the forward's f32 tolerance."""
    theta, X, y = _problem(seed=1)
    jdt = getattr(jnp, dtype)
    pj = jobj.SCFGPParams(*[jnp.asarray(a, jdt) for a in theta])
    (cj, auxj), gj = jax.jit(jobj.loss_and_grad)(pj, jnp.asarray(X, jdt),
                                                 jnp.asarray(y, jdt))
    pt = params_from_numpy(theta, dtype=TDT[dtype])
    (ct, auxt), gt = tobj.loss_and_grad(pt, torch.as_tensor(X, dtype=TDT[dtype]),
                                        torch.as_tensor(y, dtype=TDT[dtype]))
    assert not ct.requires_grad and not auxt.post.Li.requires_grad
    assert all(t.grad is None for t in pt)  # no .grad accumulation
    np.testing.assert_allclose(float(ct), float(cj), rtol=rtol)
    np.testing.assert_allclose(auxt.post.alpha.numpy(),
                               np.asarray(auxj.post.alpha), rtol=rtol,
                               atol=rtol * np.abs(auxj.post.alpha).max())
    scale = max(np.abs(np.asarray(a)).max() for a in gj)
    for name, a, b in zip(gj._fields, gj, gt):
        assert b.dtype == TDT[dtype]
        if name in ("l_phase", "phase"):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=rtol * scale, err_msg=name)
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=rtol * np.abs(a).max(),
                                       err_msg=name)


def test_loss_and_grad_matches_finite_differences():
    """Mirrors tests/test_objective.py::test_gradient_matches_finite_differences:
    12 coordinates against central differences of the float64 golden."""
    theta, X, y = _problem(seed=2)
    flat = np.concatenate([a.reshape(-1) for a in theta])
    p = params_from_numpy(theta, dtype=torch.float64)
    _, g = tobj.loss_and_grad(p, torch.as_tensor(X), torch.as_tensor(y))
    gflat = np.concatenate([t.numpy().reshape(-1) for t in g])
    rng = np.random.RandomState(0)
    eps = 1e-6
    for i in rng.choice(flat.shape[0], 12, replace=False):
        tp, tm = flat.copy(), flat.copy()
        tp[i] += eps
        tm[i] -= eps
        fd = (golden_cost(tp, X, y[:, None], D, S, M)
              - golden_cost(tm, X, y[:, None], D, S, M)) / (2 * eps)
        np.testing.assert_allclose(gflat[i], fd, rtol=2e-4, atol=1e-7)


def test_loss_and_grad_takes_inference_mode_params():
    """Params made under inference_mode (as recalibrate_dispersion makes
    c) still differentiate."""
    theta, X, y = _problem(seed=3)
    with torch.inference_mode():
        p = params_from_numpy(theta, dtype=torch.float64)
    _, g = tobj.loss_and_grad(p, torch.as_tensor(X), torch.as_tensor(y))
    _, g_ref = tobj.loss_and_grad(params_from_numpy(theta, dtype=torch.float64),
                                  torch.as_tensor(X), torch.as_tensor(y))
    for a, b in zip(g, g_ref):
        assert torch.equal(a, b)


def test_chol_and_inverse_backward_matches_autograd():
    """The all-GEMM backward equals autograd through torch's cholesky +
    triangular solve, asymmetric cotangents too (mirrors
    tests/test_objective.py::test_chol_and_inverse_vjp_matches_xla)."""
    rng = np.random.RandomState(11)
    m = 33
    B = rng.randn(m, m)
    A = torch.as_tensor(B @ B.T + m * np.eye(m))
    gL, gLi = torch.as_tensor(rng.randn(m, m)), torch.as_tensor(rng.randn(m, m))

    def ref(A):
        L = torch.linalg.cholesky(A)
        Li = torch.linalg.solve_triangular(
            L, torch.eye(m, dtype=A.dtype), upper=False)
        return L, Li

    a1 = A.clone().requires_grad_()
    got = torch.autograd.grad(tobj.chol_and_inverse(a1), [a1], (gL, gLi))[0]
    a2 = A.clone().requires_grad_()
    want = torch.autograd.grad(ref(a2), [a2], (gL, gLi))[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    # Only one of the two outputs feeding the loss also works.
    a3 = A.clone().requires_grad_()
    L, _ = tobj.chol_and_inverse(a3)
    got_l = torch.autograd.grad(L.sum(), [a3])[0]
    a4 = A.clone().requires_grad_()
    want_l = torch.autograd.grad(torch.linalg.cholesky(a4).sum(), [a4])[0]
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_chol_and_inverse_gives_nan_where_jax_does():
    """A matrix that is not positive definite yields NaN, as JAX's
    cholesky does, instead of raising: the training loops count such a
    step as not improved."""
    A = -torch.eye(4, dtype=torch.float64)
    L, Li = tobj.chol_and_inverse(A)
    jL = np.asarray(jnp.linalg.cholesky(jnp.asarray(A.numpy())))
    np.testing.assert_array_equal(torch.isnan(L).numpy(), np.isnan(jL))
    assert torch.isnan(torch.diagonal(Li)).all()
