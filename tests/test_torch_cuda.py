"""The CUDA kernels K1f, K1b, K2f, K2b, K3 and K4 and the port's serving,
training and streaming paths on an NVIDIA card.

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
