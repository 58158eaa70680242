"""The CUDA kernels K1f and K1b and the port's serving and training paths
on an NVIDIA card.

Every test here needs a card and nvcc: it carries the ``cuda`` marker and
skips on a machine without one.  This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import os

import numpy as np
import pytest
import torch

from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.data.datasets import load_kin8nm
from scfgp_tpu_torch.models.objective import loss_and_grad
from scfgp_tpu_torch.models.params import init_params
from scfgp_tpu_torch.ops.phi import (fourier_features_bwd_cuda,
                                     fourier_features_cuda,
                                     fourier_features_ref, phi_bwd_ref)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Ragged shapes, the served kin8nm model's (N=6553, 2K=554) and D=256.
SHAPES = [(1, 3, 37), (777, 3, 37), (130, 1, 5), (300, 9, 129),
          (6553, 8, 277), (4096, 256, 500)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, k, device, seed=0):
    """Frequencies of scale 3: |T| reaches tens, as for trained models."""
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (rng.randn(n, d), 3.0 * rng.randn(d, k),
                      rng.uniform(0, 2 * np.pi, k), 0.7)]


def kernel_tolerance(X, F, p, s):
    """f32 rounding of T carries over one to one into cos and sin."""
    T = X.double() @ F.double() + p.double()
    return 2e-5 * abs(float(s)) * max(1.0, float(T.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, n, d, k):
    X, F, p, s = _inputs(n, d, k, cuda_device)
    before = fourier_features_cuda.launches
    got = fourier_features_cuda(X, F, p, s)
    torch.cuda.synchronize()
    assert fourier_features_cuda.launches == before + 1
    ref = fourier_features_ref(X, F, p, s)
    err = float((got - ref).abs().max())
    assert got.shape == (n, 2 * k) and err <= kernel_tolerance(X, F, p, s)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_it_does_not_take(cuda_device):
    X, F, p, s = _inputs(64, 4, 9, cuda_device)
    with pytest.raises(TypeError):
        fourier_features_cuda(X.double(), F, p, s)
    with pytest.raises(ValueError):
        fourier_features_cuda(X.t().contiguous().t(), F, p, s)
    with pytest.raises(ValueError):
        fourier_features_cuda(X, F[:3].contiguous(), p, s)
    with pytest.raises(ValueError):
        fourier_features_cuda(X.cpu(), F, p, s)
    with pytest.raises(RuntimeError, match="requires grad"):
        fourier_features_cuda(X, F.requires_grad_(), p, s)


@pytest.mark.cuda
def test_card_serving_matches_host_float64(cuda_device):
    """kin8nm served on the card in f32 against the host in f64: f32
    rounding of the feature map and the prediction GEMMs, measured at about
    3e-5 of the outputs; held at 1e-4."""
    _, _, Xv, _, _ = load_kin8nm(seed=0)
    ckpt = os.path.join(ROOT, "experiments", "results", "kin8nm",
                        "best_model.pkl")
    before = fourier_features_cuda.launches
    mu_g, sd_g = SCFGP(device="cuda").load(ckpt).predict(Xv)
    mu_c, sd_c = SCFGP(device="cpu", dtype=torch.float64).load(ckpt).predict(Xv)
    assert fourier_features_cuda.launches > before
    np.testing.assert_allclose(mu_g, mu_c, rtol=1e-4,
                               atol=1e-4 * np.abs(mu_c).max())
    np.testing.assert_allclose(sd_g, sd_c, rtol=1e-4)


def bwd_tolerance(X, F, p, s, g):
    """K1b against the plain f32 version: both round T (error ~ u sqrt(D)
    |T|abs per entry, independent across rows) and sum the rows in other
    orders (~ u times the sum of magnitudes); 4x that, per output."""
    X, F, p, s, g = (t.double() for t in (X, F, p, s, g))
    k = F.shape[1]
    u = 2.0 ** -24
    T = X @ F + p
    e = ((g[:, :k].abs() + g[:, k:].abs()) * (X.shape[1] + 2) ** 0.5
         * (1.0 + X.abs() @ F.abs() + p.abs()))
    dT = (s * (g[:, k:] * torch.cos(T) - g[:, :k] * torch.sin(T))).abs()
    ax = X.abs().T
    terms = (g[:, :k] * torch.cos(T)).abs() + (g[:, k:] * torch.sin(T)).abs()
    return (4 * u * float((ax @ dT + ((ax * ax) @ (s * e) ** 2).sqrt()).max()),
            4 * u * float((dT.sum(0) + ((s * e) ** 2).sum(0).sqrt()).max()),
            4 * u * float(terms.sum() + (e * e).sum().sqrt()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_bwd_kernel_matches_plain_and_repeats_bitwise(cuda_device, n, d, k):
    X, F, p, s = _inputs(n, d, k, cuda_device)
    g = torch.as_tensor(np.random.RandomState(1).randn(n, 2 * k),
                        dtype=torch.float32, device=cuda_device)
    before = fourier_features_bwd_cuda.launches
    got = fourier_features_bwd_cuda(X, F, p, s, g)
    again = fourier_features_bwd_cuda(X, F, p, s, g)
    torch.cuda.synchronize()
    assert fourier_features_bwd_cuda.launches == before + 2
    ref = phi_bwd_ref(X, F, p, s, g)
    assert [tuple(t.shape) for t in got] == [(d, k), (k,), ()]
    for a, b, r, tol in zip(got, again, ref, bwd_tolerance(X, F, p, s, g)):
        assert torch.equal(a, b)  # no atomics: bitwise repeatable
        assert float((a - r).abs().max()) <= tol


@pytest.mark.cuda
def test_bwd_kernel_wrapper_raises_on_what_it_does_not_take(cuda_device):
    X, F, p, s = _inputs(64, 4, 9, cuda_device)
    g = torch.zeros(64, 18, device=cuda_device)
    with pytest.raises(TypeError):
        fourier_features_bwd_cuda(X, F, p, s, g.double())
    with pytest.raises(ValueError):
        fourier_features_bwd_cuda(X, F, p, s, g[:, :17].contiguous())
    with pytest.raises(ValueError):
        fourier_features_bwd_cuda(X, F, p, s, g.t().contiguous().t())
    with pytest.raises(ValueError):
        fourier_features_bwd_cuda(X, F, p, s, g.cpu())
    with pytest.raises(RuntimeError, match="requires grad"):
        fourier_features_bwd_cuda(X, F, p, s, g.requires_grad_())


@pytest.mark.cuda
def test_loss_gradient_on_card_matches_host_float64(cuda_device):
    """loss_and_grad through K1f and K1b in f32 against the host's plain
    f64 path: f32 rounding through the Cholesky backward; held at 1e-3 of
    each leaf's largest entry (phases, pure gauge: of the largest entry)."""
    rng = np.random.RandomState(2)
    X, y = rng.rand(1500, 6), rng.randn(1500)
    p64 = init_params(torch.Generator().manual_seed(0), 6, 6, 40,
                      torch.float64)
    p32 = type(p64)(*[t.float().to(cuda_device) for t in p64])
    launches = (fourier_features_cuda.launches,
                fourier_features_bwd_cuda.launches)
    (c32, _), g32 = loss_and_grad(p32, torch.as_tensor(X, dtype=torch.float32,
                                                       device=cuda_device),
                                  torch.as_tensor(y, dtype=torch.float32,
                                                  device=cuda_device))
    assert fourier_features_cuda.launches > launches[0]
    assert fourier_features_bwd_cuda.launches > launches[1]
    (c64, _), g64 = loss_and_grad(p64, torch.as_tensor(X), torch.as_tensor(y))
    np.testing.assert_allclose(float(c32), float(c64), rtol=1e-4)
    top = max(float(t.abs().max()) for t in g64)
    for name, a, b in zip(g64._fields, g32, g64):
        den = top if "phase" in name else float(b.abs().max())
        assert float((a.cpu().double() - b).abs().max()) <= 1e-3 * den, name


@pytest.mark.cuda
def test_fit_fast_on_card_trains_and_resumes_bitwise(cuda_device, tmp_path):
    _, _, Xv, yv, _ = load_kin8nm(seed=0)
    Xt, yt, Xs, ys = Xv[:1200], yv[:1200], Xv[1200:], yv[1200:]
    kw = dict(obj="SCORE", max_iter=40, max_cvrg=6)
    a = SCFGP(sparsity=8, nfeats=30, seed=1, device="cuda")
    a.fit_fast(Xt, yt, Xs, ys, **kw)
    path = str(tmp_path / "ckpt")
    b = SCFGP(sparsity=8, nfeats=30, seed=1, device="cuda")
    b.fit_fast(Xt, yt, Xs, ys, checkpoint_path=path, checkpoint_every=7, **kw)
    assert np.isfinite(a.evals["NMSE"][1][-1])
    assert a.evals["COST"][1] == b.evals["COST"][1]
    assert all(torch.equal(x, y) for x, y in zip(a.params, b.params))


@pytest.mark.cuda
def test_float64_model_on_card_raises_at_the_kernel(cuda_device):
    """No fallback: the kernels take float32 only, so a float64 model on
    the card raises instead of quietly taking the plain versions."""
    _, _, Xv, yv, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=4, nfeats=8, seed=0, device="cuda",
              dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 only"):
        m.fit(Xv[:200], yv[:200], max_iter=2)
