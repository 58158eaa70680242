"""The CUDA kernels K1f, K1b, K2f, K2b, K3 and K4 and the port's serving,
training, streaming, sweep and Bayes paths on an NVIDIA card.

Every test here needs a card and nvcc: it carries the ``cuda`` marker and
skips on a machine without one.  This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch

from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.data.datasets import load_kin8nm
from scfgp_tpu_torch.experiments.chol_crossover import spd_input
from scfgp_tpu_torch.models.objective import chol_and_inverse, loss_and_grad
from scfgp_tpu_torch.models.params import init_params
from scfgp_tpu_torch.ops.cholesky import (cholesky_cuda,
                                          cholesky_inverse_cuda,
                                          cholesky_inverse_kernel,
                                          cholesky_inverse_ref, cholesky_ref)
from scfgp_tpu_torch.ops.gram import (gram_bwd_ref, sufficient_stats_bwd_cuda,
                                      sufficient_stats_cuda,
                                      sufficient_stats_ref)
from scfgp_tpu_torch.ops.phi import (fourier_features_bwd_cuda,
                                     fourier_features_cuda,
                                     fourier_features_ref, phi_bwd_ref)
from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (chol_tolerance, indefinite_input,  # noqa: E402
                        k2b_tolerance, k2f_tolerance)

torch.set_num_threads(1)
# Ragged shapes, the served kin8nm model's (N=6553, 2K=554), D=256, the
# edges of the 128 x 128 tile of csrc/sgemm_tile.cuh (N 127-129 and 16385,
# D 1, 63-64 where K1f and K1b change design, 255 and 257, K 127-129 and
# 256) and the streaming block (N=16384, D=256, K=256).
SHAPES = [(1, 3, 37), (777, 3, 37), (130, 1, 5), (300, 9, 129),
          (6553, 8, 277), (4096, 256, 500), (127, 255, 129),
          (128, 257, 128), (129, 64, 127), (128, 63, 129), (129, 1, 256),
          (16385, 256, 256), (16384, 256, 256)]


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
    """K1f within its bound of the plain map, bitwise repeatable, and at the
    served kin8nm model's shape bitwise equal to it (chip_smoke.GRAD_TOL
    relies on that).  Elsewhere cuBLAS may sum T in another order than the
    kernel's d = 0..D-1: an H100 gave a few ulps at N = 1, at (300, 9, 129)
    and at (128, 63, 129)."""
    X, F, p, s = _inputs(n, d, k, cuda_device)
    before = fourier_features_cuda.launches
    got = fourier_features_cuda(X, F, p, s)
    again = fourier_features_cuda(X, F, p, s)
    torch.cuda.synchronize()
    assert fourier_features_cuda.launches == before + 2
    assert torch.equal(got, again)
    ref = fourier_features_ref(X, F, p, s)
    err = float((got - ref).abs().max())
    assert got.shape == (n, 2 * k) and err <= kernel_tolerance(X, F, p, s)
    if (n, d, k) == (6553, 8, 277):
        assert torch.equal(got, ref)


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


# Ragged shapes, zero-weight rows, kin8nm's (N=6553, 2K=554), the edges of
# the 128 x 128 tile (N 127-129 and 16385, D 1, 63-64 where K2f's feature
# stage changes design, 255 and 257, K 127-129 and 256) and the streaming
# block's (N=16384, D=256, K=256).  With weights K2f's chunk holds 8192
# rows at 2K = 512, so (16385, 256, 256) takes three chunks.
K2_SHAPES = [(1, 3, 37, False), (777, 3, 37, True), (300, 9, 129, False),
             (6553, 8, 277, False), (127, 255, 129, True),
             (128, 257, 128, False), (129, 1, 127, True),
             (129, 64, 127, True), (128, 63, 129, False),
             (300, 9, 256, False), (16385, 256, 256, True),
             (16384, 256, 256, False)]


def _k2_inputs(n, d, k, weighted, device, seed=0):
    rng = np.random.RandomState(seed)
    X, y, F, p, cbar, pbar = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (rng.rand(n, d), rng.randn(n), 3.0 * rng.randn(d, k),
                  rng.uniform(0, 2 * np.pi, k), rng.randn(2 * k, 2 * k),
                  rng.randn(2 * k)))
    w = (torch.as_tensor(np.arange(n) % 3 != 0, dtype=torch.float32,
                         device=device) if weighted else None)
    return X, y, w, F, p, torch.tensor(0.7, device=device), cbar, pbar


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,weighted", K2_SHAPES)
def test_gram_kernels_match_plain_and_repeat_bitwise(cuda_device, n, d, k,
                                                     weighted):
    """K2f and K2b against their plain versions, within the rounding-model
    bounds of chip_smoke.py (k2f_tolerance, k2b_tolerance)."""
    X, y, w, F, p, s, cbar, pbar = _k2_inputs(n, d, k, weighted, cuda_device)
    before = (sufficient_stats_cuda.launches,
              sufficient_stats_bwd_cuda.launches)
    fwd = [sufficient_stats_cuda(X, y, w, F, p, s) for _ in range(2)]
    bwd = [sufficient_stats_bwd_cuda(X, y, w, F, p, s, cbar, pbar)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert (sufficient_stats_cuda.launches,
            sufficient_stats_bwd_cuda.launches) == (before[0] + 2,
                                                    before[1] + 2)
    assert torch.equal(fwd[0][0], fwd[0][0].T)  # emitted symmetric
    for got, ref, tol in (
            (fwd, sufficient_stats_ref(X, y, w, F, p, s),
             k2f_tolerance(X, F, p, s, y, w)),
            (bwd, gram_bwd_ref(X, y, w, F, p, s, cbar, pbar),
             k2b_tolerance(X, F, p, s, y, w, cbar, pbar))):
        for a, b, r, t in zip(*got, ref, tol):
            assert a.shape == r.shape
            assert torch.equal(a, b)  # no atomics: bitwise repeatable
            assert float((a - r).abs().max()) <= t


@pytest.mark.cuda
def test_gram_wrappers_raise_on_what_they_do_not_take(cuda_device):
    X, y, w, F, p, s, cbar, pbar = _k2_inputs(64, 4, 9, True, cuda_device)
    with pytest.raises(TypeError):
        sufficient_stats_cuda(X.double(), y, w, F, p, s)
    with pytest.raises(TypeError):
        sufficient_stats_bwd_cuda(X, y, w, F, p, s, cbar.double(), pbar)
    with pytest.raises(ValueError):
        sufficient_stats_cuda(X.t().contiguous().t(), y, w, F, p, s)
    with pytest.raises(ValueError):
        sufficient_stats_cuda(X, y.cpu(), w, F, p, s)
    with pytest.raises(ValueError):
        sufficient_stats_cuda(X, y, w[:10].contiguous(), F, p, s)
    with pytest.raises(ValueError):
        sufficient_stats_bwd_cuda(X, y, w, F, p, s, cbar[:4].contiguous(),
                                  pbar)
    with pytest.raises(RuntimeError, match="requires grad"):
        sufficient_stats_cuda(X, y, w, F.requires_grad_(), p, s)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "gemm"])
def test_streaming_on_card_matches_host_float64(cuda_device, route):
    """loss_fn_streaming's cost and gradient on the card in f32 against the
    host's plain dense f64 path, at the tolerances of the dense test above
    (f32 rounding through the Cholesky backward)."""
    rng = np.random.RandomState(3)
    X, y = rng.rand(3000, 6), rng.randn(3000)
    p64 = init_params(torch.Generator().manual_seed(1), 6, 6, 40,
                      torch.float64)
    p32 = type(p64)(*[t.float().to(cuda_device) for t in p64])
    launches = [f.launches for f in (sufficient_stats_cuda,
                                     sufficient_stats_bwd_cuda,
                                     fourier_features_cuda,
                                     fourier_features_bwd_cuda)]
    (c32, _), g32 = loss_and_grad_streaming(
        p32, torch.as_tensor(X, dtype=torch.float32, device=cuda_device),
        torch.as_tensor(y, dtype=torch.float32, device=cuda_device),
        block_size=700, stats_impl=route)
    after = [f.launches for f in (sufficient_stats_cuda,
                                  sufficient_stats_bwd_cuda,
                                  fourier_features_cuda,
                                  fourier_features_bwd_cuda)]
    gram_used = route == "kernel"
    assert [a > b for a, b in zip(after, launches)] == [
        gram_used, gram_used, True, True]
    (c64, _), g64 = loss_and_grad(p64, torch.as_tensor(X), torch.as_tensor(y))
    np.testing.assert_allclose(float(c32), float(c64), rtol=1e-4)
    top = max(float(t.abs().max()) for t in g64)
    for name, a, b in zip(g64._fields, g32, g64):
        den = top if "phase" in name else float(b.abs().max())
        assert float((a.cpu().double() - b).abs().max()) <= 1e-3 * den, name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 63, 64, 65, 128, 129, 200, 554, 1024])
def test_cholesky_kernels_match_plain_and_repeat_bitwise(cuda_device, n):
    """K4 and K3 against torch's pair within chip_smoke.py's rounding-model
    bounds (chol_tolerance); strict upper triangles exactly 0.  63 to 129
    end or start a 64-wide block column; 129 leaves a last block of width
    1."""
    A = spd_input(n, cuda_device)
    before = (cholesky_cuda.launches, cholesky_inverse_cuda.launches)
    L4 = [cholesky_cuda(A) for _ in range(2)]
    L3 = [cholesky_inverse_cuda(A) for _ in range(2)]
    torch.cuda.synchronize()
    assert (cholesky_cuda.launches,
            cholesky_inverse_cuda.launches) == (before[0] + 2, before[1] + 2)
    (L, Li), (Lb, Lib) = L3
    assert torch.equal(L4[0], L4[1]) and torch.equal(L, Lb)
    assert torch.equal(Li, Lib)  # no atomics: bitwise repeatable
    tol, _ = chol_tolerance(A, L, Li)
    Lp, Lip = cholesky_inverse_ref(A)
    Ld, Lid = L.double(), Li.double()
    eye = torch.eye(n, dtype=torch.float64, device=cuda_device)
    assert float((Ld @ Ld.T - A.double()).abs().max()) <= tol["recon"]
    assert float((Lid @ Ld - eye).abs().max()) <= tol["inverse"]
    for got in (L, L4[0]):
        assert float((got - Lp).abs().max()) <= tol["L"]
        assert not torch.triu(got, 1).any()
    assert float((Li - Lip).abs().max()) <= tol["Li"]
    assert not torch.triu(Li, 1).any()


@pytest.mark.cuda
def test_cholesky_kernels_return_on_an_indefinite_matrix(cuda_device):
    """The clamped pivot sqrt(max(d, 1e-30)): no error and no hang, every
    pivot in [1e-15, inf], strict upper triangles still 0, where torch's
    factor gives NaN."""
    A = indefinite_input(cuda_device)
    L, Li = cholesky_inverse_cuda(A)
    L4 = cholesky_cuda(A)
    torch.cuda.synchronize()
    for got in (L, L4):
        assert bool((torch.diagonal(got) > 0).all())
    for got in (L, Li, L4):
        assert got.shape == A.shape and not torch.triu(got, 1).any()
    assert bool(torch.isnan(cholesky_ref(A)).any())


@pytest.mark.cuda
def test_cholesky_wrappers_raise_on_what_they_do_not_take(cuda_device):
    A = spd_input(40, cuda_device)
    for fn in (cholesky_cuda, cholesky_inverse_cuda):
        with pytest.raises(TypeError, match="float32 only"):
            fn(A.double())
        with pytest.raises(ValueError, match="not contiguous"):
            fn(A.t())
        with pytest.raises(ValueError, match="square"):
            fn(A[:39].contiguous())
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(A.clone().requires_grad_())


@pytest.mark.cuda
def test_cholesky_inverse_gradient_matches_chol_and_inverse(cuda_device):
    """The gradient of sum(log diag L) + sum(Li²) through K3's Function
    against the one through chol_and_inverse (torch's pair), within
    chol_tolerance's gradient bound."""
    A = spd_input(300, cuda_device)

    def grad(fn):
        leaf = A.clone().requires_grad_()
        L, Li = fn(leaf)
        loss = torch.log(torch.diagonal(L)).sum() + (Li * Li).sum()
        return torch.autograd.grad(loss, leaf)[0]

    before = cholesky_inverse_cuda.launches
    got = grad(cholesky_inverse_kernel)
    assert cholesky_inverse_cuda.launches == before + 1
    ref = grad(chol_and_inverse)
    L, Li = cholesky_inverse_ref(A)
    tol, _ = chol_tolerance(A, L, Li)
    assert float((got - ref).abs().max()) <= tol["grad"] * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,d,k", [(455, 13, 70), (600, 256, 130)])
def test_batched_kernels_equal_per_trial_calls(cuda_device, B, n, d, k):
    """K1f and K1b with a trial axis: one launch each for all B trials, and
    each trial bitwise the 2-D call on its own inputs (D = 13 takes the
    narrow designs, D = 256 the wide ones)."""
    rng = np.random.RandomState(B)
    X, F, p, s, g = (torch.as_tensor(a, dtype=torch.float32,
                                     device=cuda_device)
                     for a in (rng.rand(B, n, d), 3.0 * rng.randn(B, d, k),
                               rng.uniform(0, 2 * np.pi, (B, k)),
                               rng.uniform(0.5, 1.5, B),
                               rng.randn(B, n, 2 * k)))
    before = (fourier_features_cuda.launches,
              fourier_features_bwd_cuda.launches)
    Phi = fourier_features_cuda(X, F, p, s)
    grads = fourier_features_bwd_cuda(X, F, p, s, g)
    torch.cuda.synchronize()
    assert (fourier_features_cuda.launches,
            fourier_features_bwd_cuda.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert Phi.shape == (B, n, 2 * k)
    assert [tuple(t.shape) for t in grads] == [(B, d, k), (B, k), (B,)]
    for b in range(B):
        assert torch.equal(Phi[b], fourier_features_cuda(X[b], F[b], p[b],
                                                         s[b]))
        one = fourier_features_bwd_cuda(X[b], F[b], p[b], s[b], g[b])
        for a, c in zip(grads, one):
            assert torch.equal(a[b], c)
        assert (float((Phi[b] - fourier_features_ref(X[b], F[b], p[b], s[b]))
                      .abs().max())
                <= kernel_tolerance(X[b], F[b], p[b], s[b]))


@pytest.mark.cuda
def test_batched_kernel_wrappers_refuse_mixed_ranks(cuda_device):
    X, F, p, s = _inputs(64, 4, 9, cuda_device)
    Xb, Fb, pb = X[None].contiguous(), F[None].contiguous(), p[None]
    sb = s.reshape(1)
    with pytest.raises(ValueError, match="expected X"):
        fourier_features_cuda(Xb, F, p, s)
    with pytest.raises(ValueError, match="shapes disagree"):
        fourier_features_cuda(Xb, torch.cat([Fb, Fb]), torch.cat([pb, pb]),
                              torch.cat([sb, sb]))
    with pytest.raises(ValueError, match="scale"):
        fourier_features_cuda(Xb, Fb, pb, s)
    with pytest.raises(ValueError, match="g is"):
        fourier_features_bwd_cuda(Xb, Fb, pb, sb,
                                  torch.zeros(64, 18, device=cuda_device))


@pytest.mark.cuda
def test_fit_fast_batch_on_card_matches_sequential(cuda_device):
    """Three boston trials: each batched alone equals its fit_fast bitwise;
    batched together, K1b launches once a step of the batch and the costs
    agree within chip_smoke.FIT_COST_TOL over the first 10 steps, before
    stall annealing can act (after it, float32 rounding of the batched
    products may flip the loop's threshold tests: chip_smoke.py,
    BATCH_FIT_EXACT_STEPS)."""
    from scfgp_tpu_torch.data.datasets import load_boston
    from scfgp_tpu_torch.models.model import fit_fast_batch
    from chip_smoke import BATCH_FIT_EXACT_STEPS, FIT_COST_TOL
    data = [load_boston(seed=b)[:4] for b in range(3)]
    kw = dict(obj="SCORE", max_iter=60, cvrg_tol=1e-5, max_cvrg=18)

    def models():
        return [SCFGP(sparsity=20, nfeats=30, seed=b, device="cuda")
                for b in range(3)]
    seq, alone, bat = models(), models(), models()
    for ms, ma, d in zip(seq, alone, data):
        ms.fit_fast(*d, **kw)
        fit_fast_batch([ma], [d], **kw)
        assert ma.evals["COST"][1] == ms.evals["COST"][1]
        assert all(torch.equal(x, y) for x, y in zip(ma.params, ms.params))
    before = fourier_features_bwd_cuda.launches
    fit_fast_batch(bat, data, **kw)
    steps = max(len(m.evals["COST"][1]) for m in bat)
    assert fourier_features_bwd_cuda.launches - before == steps
    for ms, mb in zip(seq, bat):
        a = np.asarray(ms.evals["COST"][1][:BATCH_FIT_EXACT_STEPS])
        c = np.asarray(mb.evals["COST"][1][:BATCH_FIT_EXACT_STEPS])
        assert float(np.max(np.abs(a - c) / np.abs(a))) <= FIT_COST_TOL
        assert np.isfinite(mb.evals["NMSE"][1][-1])


@pytest.mark.cuda
def test_batched_logposterior_gradient_on_card_matches_plain(cuda_device):
    """Eight chains of the Bayes log posterior (S=20, M=50, 1500 kin8nm
    rows): value and gradient through K1f and K1b, one launch each for all
    chains, against the plain feature map on the card, within
    chip_smoke.COST_TOL per chain and chip_smoke.GRAD_TOL of each block's
    largest entry (phase 12a's bounds)."""
    from scfgp_tpu_torch.bayes import batched_value_and_grad, make_logposterior
    from chip_smoke import (COST_TOL, GRAD_TOL, plain_feature_map,
                            random_chains)
    Xt, yt, _, _, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=20, nfeats=50, seed=0, device="cuda")
    m.set_data(Xt[:1500], yt[:1500])
    theta = random_chains(m, 8, 0)
    vg = batched_value_and_grad(make_logposterior(m.X, m.y, m.D, m.S, m.M))
    launches = (fourier_features_cuda.launches,
                fourier_features_bwd_cuda.launches)
    ld, g = vg(theta)
    assert fourier_features_cuda.launches - launches[0] == 1
    assert fourier_features_bwd_cuda.launches - launches[1] == 1
    with plain_feature_map():
        ld_p, g_p = vg(theta)
    assert float(((ld - ld_p).abs() / ld_p.abs()).max()) <= COST_TOL
    ds = 3 + m.D * m.S
    for s in (slice(0, 3), slice(3, ds), slice(ds, None)):
        err = (g[:, s] - g_p[:, s]).abs().max() / g_p[:, s].abs().max()
        assert float(err) <= GRAD_TOL, s


@pytest.mark.cuda
def test_fit_bayes_on_card_launches_once_per_batched_gradient(cuda_device):
    """A short fleet HMC fit_bayes of a fresh model: K1f and K1b launch
    once per batched gradient, (warmup + samples) x (L + 1), and no more;
    the draws and the held-out predictions are finite."""
    _, _, Xv, yv, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=8, nfeats=20, seed=0, device="cuda")
    launches = (fourier_features_cuda.launches,
                fourier_features_bwd_cuda.launches)
    m.fit_bayes(Xv[:1200], yv[:1200], sampler="hmc", chains=4, num_warmup=3,
                num_samples=8, num_integration_steps=3, init_step_size=0.003,
                shared_adaptation=False)
    grads = (3 + 8) * (3 + 1)
    assert fourier_features_bwd_cuda.launches - launches[1] == grads
    assert fourier_features_cuda.launches - launches[0] == grads
    assert bool(torch.isfinite(m.thetas).all())
    mu, sd = m.predict_bayes(Xv[1200:])
    assert np.isfinite(mu).all() and (sd > 0).all()


# The narrow designs of K1f and K1b (D < 64): D from 1 to 63 over the
# compiled buckets (8, 16, 32, 64), K where a column tile is ragged (37, 50,
# 70) or spans 64-column tiles (277), N from one row to the kin8nm
# training set; one trial (the 2-D call) and three.
NARROW = [(n, d, k, b) for d in (1, 3, 8, 13, 63) for k in (37, 50, 70, 277)
          for n in (1, 63, 777, 6553) for b in (1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,b", NARROW)
def test_narrow_kernels_match_plain_and_their_2d_calls(cuda_device, n, d, k,
                                                       b):
    """K1f within kernel_tolerance of the plain map and K1b within
    bwd_tolerance of phi_bwd_ref, one launch a call, bitwise repeatable;
    with three trials, each trial bitwise its own 2-D call."""
    rng = np.random.RandomState(n + d + k + b)
    lead = (b,) if b > 1 else ()
    X, F, p, g = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
                  for a in (rng.rand(*lead, n, d), 3.0 * rng.randn(*lead, d, k),
                            rng.uniform(0, 2 * np.pi, (*lead, k)),
                            rng.randn(*lead, n, 2 * k)))
    s = torch.as_tensor(rng.uniform(0.5, 1.5, b) if b > 1 else 0.7,
                        dtype=torch.float32, device=cuda_device)
    before = (fourier_features_cuda.launches,
              fourier_features_bwd_cuda.launches)
    Phi, Phi2 = (fourier_features_cuda(X, F, p, s) for _ in range(2))
    grads, grads2 = (fourier_features_bwd_cuda(X, F, p, s, g)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert (fourier_features_cuda.launches,
            fourier_features_bwd_cuda.launches) == (before[0] + 2,
                                                    before[1] + 2)
    assert torch.equal(Phi, Phi2)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads2))
    assert Phi.shape == (*lead, n, 2 * k)
    assert [tuple(t.shape) for t in grads] == [(*lead, d, k), (*lead, k), lead]
    trials = [tuple(t[i] for t in (X, F, p, s, g)) for i in range(b)] \
        if b > 1 else [(X, F, p, s, g)]
    for i, (Xi, Fi, pi, si, gi) in enumerate(trials):
        phi = Phi[i] if b > 1 else Phi
        grad = [t[i] for t in grads] if b > 1 else list(grads)
        if b > 1:
            assert torch.equal(phi, fourier_features_cuda(Xi, Fi, pi, si))
            assert all(torch.equal(a, c) for a, c in zip(
                grad, fourier_features_bwd_cuda(Xi, Fi, pi, si, gi)))
        err = float((phi - fourier_features_ref(Xi, Fi, pi, si)).abs().max())
        assert err <= kernel_tolerance(Xi, Fi, pi, si)
        for a, r, tol in zip(grad, phi_bwd_ref(Xi, Fi, pi, si, gi),
                             bwd_tolerance(Xi, Fi, pi, si, gi)):
            assert float((a - r).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [63, 6553])
@pytest.mark.parametrize("k", [37, 50, 70, 277])
def test_gram_forward_at_d8_matches_plain(cuda_device, n, k):
    """K2f's features at D = 8 come from the narrow K1f design: K2f within
    k2f_tolerance of sufficient_stats_ref, one launch a call, bitwise
    repeatable."""
    X, y, w, F, p, s, _, _ = _k2_inputs(n, 8, k, False, cuda_device, seed=k)
    before = sufficient_stats_cuda.launches
    got, again = (sufficient_stats_cuda(X, y, w, F, p, s) for _ in range(2))
    torch.cuda.synchronize()
    assert sufficient_stats_cuda.launches == before + 2
    for a, b, r, t in zip(got, again, sufficient_stats_ref(X, y, w, F, p, s),
                          k2f_tolerance(X, F, p, s, y, w)):
        assert torch.equal(a, b)
        assert float((a - r).abs().max()) <= t


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(6553, 8, 277), (777, 3, 37)])
def test_phi_fwd_op_on_card_is_the_kernel(cuda_device, n, d, k):
    """The registered operator launches K1f (counted) and gives its bits."""
    from scfgp_tpu_torch.ops.phi import phi_fwd_op
    X, F, p, s = _inputs(n, d, k, cuda_device)
    before = fourier_features_cuda.launches
    got = torch.ops.scfgp_tpu_torch.phi_fwd(X, F, p, s)
    assert fourier_features_cuda.launches == before + 1
    assert torch.equal(got, fourier_features_cuda(X, F, p, s))
    torch.library.opcheck(phi_fwd_op, (X, F, p, s),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
def test_exported_predictor_on_card_equals_predict(cuda_device):
    """kin8nm served through the exported program: one K1f launch a call,
    no Cholesky kernel, and the model's predict within 1e-5 (the same
    operations; only GEMMs of another row count may round otherwise)."""
    from scfgp_tpu_torch.utils.serving import (ServedPredictor,
                                               export_predictor)
    _, _, Xv, _, _ = load_kin8nm(seed=0)
    ckpt = os.path.join(ROOT, "experiments", "results", "kin8nm",
                        "best_model.pkl")
    m = SCFGP(device="cuda").load(ckpt)
    served = ServedPredictor(export_predictor(m, 256), device="cuda")
    chol = cholesky_cuda.launches + cholesky_inverse_cuda.launches
    for rows in (slice(0, 1), slice(1, 18), slice(18, 274)):
        before = fourier_features_cuda.launches
        mu, sd = served(Xv[rows])
        assert fourier_features_cuda.launches == before + 1
        mu_r, sd_r = m.predict(Xv[rows])
        np.testing.assert_allclose(mu, mu_r, rtol=1e-5,
                                   atol=1e-5 * np.abs(mu_r).max())
        np.testing.assert_allclose(sd, sd_r, rtol=1e-5)
    assert cholesky_cuda.launches + cholesky_inverse_cuda.launches == chol
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        ServedPredictor(export_predictor(m, 8), device="cpu")


@pytest.mark.cuda
def test_exact_gp_on_card_equals_cpu(cuda_device):
    from scfgp_tpu_torch.baselines import ExactGP
    rng = np.random.RandomState(0)
    X = rng.rand(120, 3) * 3
    y = np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 2]) + 0.1 * rng.randn(120)
    gpu = ExactGP(steps=100, device="cuda").fit(X[:100], y[:100])
    cpu = ExactGP(steps=100, device="cpu").fit(X[:100], y[:100])
    np.testing.assert_allclose(gpu.nlml_history.cpu().numpy(),
                               cpu.nlml_history.numpy(), rtol=1e-10)
    for a, b in zip(gpu.predict(X[100:]), cpu.predict(X[100:])):
        np.testing.assert_allclose(a, b, rtol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 3])
def test_streaming_logposterior_on_card_matches_plain(cuda_device, chains):
    """The chain-batched streaming log posterior (S=20, M=50, 1500 kin8nm
    rows in blocks of 512, the last ragged): value and gradient through K1f
    and K1b against the plain feature map within phase 12a's bounds, and 4
    K1f and 2 K1b launches a block whatever the chain count."""
    from scfgp_tpu_torch.bayes import batched_value_and_grad, make_logposterior
    from chip_smoke import (COST_TOL, GRAD_TOL, plain_feature_map,
                            random_chains)
    Xt, yt, _, _, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=20, nfeats=50, seed=0, device="cuda")
    m.set_data(Xt[:1500], yt[:1500])
    theta = random_chains(m, chains, 0)
    vg = batched_value_and_grad(make_logposterior(
        m.X, m.y, m.D, m.S, m.M, streaming_block=512))
    launches = (fourier_features_cuda.launches,
                fourier_features_bwd_cuda.launches)
    ld, g = vg(theta)
    assert fourier_features_cuda.launches - launches[0] == 4 * 3
    assert fourier_features_bwd_cuda.launches - launches[1] == 2 * 3
    with plain_feature_map():
        ld_p, g_p = vg(theta)
    assert float(((ld - ld_p).abs() / ld_p.abs()).max()) <= COST_TOL
    ds = 3 + m.D * m.S
    for s in (slice(0, 3), slice(3, ds), slice(ds, None)):
        err = (g[:, s] - g_p[:, s]).abs().max() / g_p[:, s].abs().max()
        assert float(err) <= GRAD_TOL, s


@pytest.mark.cuda
def test_dynamic_nuts_transition_on_card_matches_plain(cuda_device):
    """One dynamic NUTS transition of 4 chains at max_depth 2 on the Bayes
    log posterior (1500 kin8nm rows), through the kernels and through the
    plain map, from the same draws: every chain reaches the same depth, and
    the positions agree within 1e-4 of the largest starting coordinate
    (the gradients differ by ~GRAD_TOL relative, moved by e² a step)."""
    from scfgp_tpu_torch.bayes import batched_value_and_grad, make_logposterior
    from scfgp_tpu_torch.bayes.hmc import Draws
    from scfgp_tpu_torch.bayes.nuts import dynamic_transition
    from chip_smoke import plain_feature_map, random_chains
    Xt, yt, _, _, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=20, nfeats=50, seed=0, device="cuda")
    m.set_data(Xt[:1500], yt[:1500])
    z0 = random_chains(m, 4, 1)
    vg = batched_value_and_grad(make_logposterior(m.X, m.y, m.D, m.S, m.M))
    eps = torch.full((4,), 0.01, device="cuda")
    im = torch.ones_like(z0)

    def transition():
        draws = Draws(torch.Generator(device="cuda").manual_seed(3),
                      z0.dtype, z0.device)
        return dynamic_transition(vg, z0, eps, im, 2, draws)

    launches = fourier_features_bwd_cuda.launches
    z, ld, acc, depth, div, grads = transition()
    assert fourier_features_bwd_cuda.launches - launches == grads <= 4
    with plain_feature_map():
        z_p, _, _, depth_p, _, _ = transition()
    assert torch.equal(depth, depth_p)
    err = float((z - z_p).abs().max()) / max(1.0, float(z0.abs().max()))
    assert err <= 1e-4, err
    assert bool(torch.isfinite(z).all())


PRECISION_CASES = ["ieee", "default", "high", "highest", "bf16"]


def _precision_inputs(n, k, B, device):
    gen = torch.Generator(device=device).manual_seed(0)
    lead = () if B is None else (B,)
    Phi = 0.1 * torch.randn(*lead, n, 2 * k, device=device, generator=gen)
    Li = 0.05 * torch.randn(*lead, 2 * k, 2 * k, device=device,
                            generator=gen).tril()
    return Phi, Li


@pytest.mark.cuda
@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("setting", PRECISION_CASES)
def test_precision_gemms_on_card(cuda_device, setting, B):
    """chip_smoke 16a at (N, K) = (3000, 130): the Gram and Φ·L⁻ᵀ with their
    backward GEMMs (``models/objective.py::_gemm``) run a TF32 kernel under
    "default" only and a bf16 kernel under bf16; each forward product is
    within its setting's rounding bound of float64 (bf16: of the plain
    upcast product), and the TF32 switch is off after the call."""
    from chip_smoke import PRECISION_SETTINGS, U32, U_TF32, gemm_kind
    from scfgp_tpu_torch.models.objective import _gemm
    from scfgp_tpu_torch.utils.profiling import kernel_profile
    kw = PRECISION_SETTINGS[setting]
    n, k = 3000, 130
    Phi, Li = _precision_inputs(n, k, B, cuda_device)
    P, L = Phi.clone().requires_grad_(), Li.clone().requires_grad_()

    def step():
        out = (_gemm(P.mT, P, **kw), _gemm(P, L.mT, **kw))
        torch.autograd.grad(out[0].sum() + (out[1] ** 2).sum(), (P, L))
        return tuple(t.detach() for t in out)

    prof = kernel_profile(step)
    out, names = prof["out"], sorted(prof["kernels"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    kinds = sorted({gemm_kind(x) for x in names} - {None})
    assert kinds == {"default": ["tf32"], "bf16": ["bf16"]}.get(setting, []), \
        names
    for o, (a, b), inner in zip(out, ((Phi.mT, Phi), (Phi, Li.mT)),
                                (n, 2 * k)):
        if setting == "bf16":
            a, b = a.bfloat16(), b.bfloat16()
            diff = (o - a.float() @ b.float()).abs().double()
            bound = 2 * inner * U32 * (a.abs().double() @ b.abs().double())
        else:
            diff = (o.double() - a.double() @ b.double()).abs()
            u = 2 * U_TF32 if setting == "default" else 0.0
            bound = (u + inner * U32) * (a.abs().double() @ b.abs().double())
        assert bool((diff <= bound).all()), float((diff / bound).max())


@pytest.mark.cuda
def test_tf32_error_exceeds_ieee_on_card(cuda_device):
    """TF32 ran: its Gram is further from float64 than IEEE's, and the
    reduced-precision products take float32 output (``aten::mm.dtype``)."""
    from scfgp_tpu_torch.models.objective import _gemm
    Phi, _ = _precision_inputs(3000, 130, None, cuda_device)
    ref = Phi.double().mT @ Phi.double()
    errs = {p: float((_gemm(Phi.mT, Phi, mm_precision=p).double() - ref)
                     .abs().max()) for p in ("default", "highest")}
    assert errs["default"] > 10 * errs["highest"], errs
    a16 = Phi.bfloat16()
    assert torch.mm(a16.mT, a16, out_dtype=torch.float32).dtype \
        == torch.float32
    assert torch.bmm(a16[None].mT, a16[None],
                     out_dtype=torch.float32).dtype == torch.float32


@pytest.mark.cuda
def test_fit_fast_under_tf32_resumes_bitwise_on_card(cuda_device, tmp_path):
    """A TF32 fit in two checkpointed segments equals its one-shot run
    bitwise (cuBLAS's TF32 GEMMs repeat under the fixed workspace that
    importing chip_smoke sets before the first GEMM)."""
    Xt, yt, Xv, yv, _ = load_kin8nm(seed=0)
    kw = dict(obj="SCORE", max_iter=30, cvrg_tol=1e-5, max_cvrg=8)

    def fit(**extra):
        m = SCFGP(sparsity=-1, nfeats=50, seed=0, device="cuda",
                  mm_precision="default")
        m.fit_fast(Xt[:2000], yt[:2000], Xv, yv, **kw, **extra)
        return m

    one = fit()
    seg = fit(checkpoint_path=str(tmp_path / "c.ckpt"), checkpoint_every=10)
    assert all(torch.equal(a, b) for a, b in zip(one.params, seg.params))
    assert one.evals["COST"][1] == seg.evals["COST"][1]


@pytest.mark.cuda
def test_chain_sharded_samplers_on_card_match_unsharded(cuda_device):
    """Two gloo ranks sharing the card, 4 chains each, at a small width
    (D=8, S=4, M=12, 1000 kin8nm rows): 15d's four runs (chip_smoke.
    CHAIN_RUNS) gathered, bitwise the same runs unsharded in this process
    on the same seeded draws with the log density taken in blocks of 4
    chains, no accept decision flipped, the counts equal and the ranks
    agreeing; each rank's runs launch K1f and K1b, and K1f and K1b agree
    with the plain map on a rank's chains (all rows and a minibatch) at
    COST_TOL and GRAD_TOL."""
    from chip_smoke import (CHAIN_RUNS, CHAIN_SHARDED, COST_TOL, GRAD_TOL,
                            chain_fields, chain_rank_checks, chain_rows,
                            chain_sample)
    from scfgp_tpu_torch.bayes import reduced_dim
    from scfgp_tpu_torch.models.params import pack_params
    from scfgp_tpu_torch.parallel import launch
    D, S, M = 8, 4, 12
    Xt, yt, _, _, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=S, nfeats=M, seed=0, device="cuda")
    m.set_data(Xt[:1000], yt[:1000])
    gen = torch.Generator().manual_seed(3)
    q0 = torch.stack([pack_params(init_params(gen, D, S, M))
                      [:reduced_dim(D, S, M)]
                      for _ in range(CHAIN_SHARDED)])
    cfg = dict(device="cuda", q0=q0.numpy(),
               data=(m.X.cpu().numpy(), m.y.cpu().numpy(), (D, S, M)))
    res = launch.run(chain_rank_checks, 2, cfg, timeout=600)
    data = (m.X, m.y, (D, S, M))
    ref = {name: chain_fields(chain_sample(
        name, data, q0.cuda(),
        torch.Generator(device="cuda").manual_seed(seed),
        block=CHAIN_SHARDED // 2))
        for name, (_, _, seed) in CHAIN_RUNS.items()}
    for name, row in chain_rows(res, ref).items():
        assert not row["accept_flips"], (name, row)
        assert all(row["counts_equal"].values()) and row["digests_equal"]
        assert all(row["bitwise"].values()), (name, row)
        for r in res:
            assert r[name]["launches"]["phi_fwd"] > 0
            assert r[name]["launches"]["phi_bwd"] > 0
    for r in res:
        for row in r["vs_plain"].values():
            assert row["finite"], row
            assert row["ld_rel_err"] <= COST_TOL, row
            assert max(row["grad_rel_err"].values()) <= GRAD_TOL, row
