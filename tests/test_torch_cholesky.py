"""K3 and K4, the blocked Cholesky: the port's entries (their plain route
on the CPU) against the JAX package's Pallas kernels in interpret mode, the
block-Neumann inverse against the JAX function, the posterior rebuilt
through the fused entry, the crossover experiment and the profiling
utilities.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.

Tolerances, each with its reason:
  * values against the Pallas kernels, f32: rtol = atol = 2e-4, and the
    reconstruction L Lᵀ = A to atol 2e-3, the Pallas tests' own
    (tests/test_pallas_cholesky.py:18-26, 66-76);
  * gradients against ``jax.grad`` through the Pallas entries, f32: rtol
    2e-3, atol 1e-4 (tests/test_pallas_cholesky.py:29-43, 79-97);
  * f64 against ``jax.vjp`` of XLA's cholesky: rtol 1e-10, the same closed
    form in another summation order at cond(A) ~ 10;
  * the block-Neumann inverse: the residual bound of the JAX test
    (5e-6) and the Pallas tolerance against the JAX function;
  * the posterior rebuilt through the fused entry: rtol = atol = 2e-3, the
    tolerance of tests/test_pallas_cholesky.py:62-63.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.models import objective as jobj
from scfgp_tpu.models.params import init_params
from scfgp_tpu.ops import cholesky as jchol
from scfgp_tpu_torch.experiments.chol_crossover import LEGS, crossover
from scfgp_tpu_torch.models import objective as tobj
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.cholesky import (cholesky_cuda,
                                          cholesky_inverse_cuda,
                                          cholesky_inverse_kernel,
                                          cholesky_inverse_ref,
                                          cholesky_kernel, cholesky_ref,
                                          tri_inverse_blocked)
from scfgp_tpu_torch.utils.profiling import (assert_deterministic,
                                             debug_numerics, time_fn, trace)

torch.set_num_threads(1)


def _spd(n, seed=0):
    """``B Bᵀ + n I``, B standard normal (tests/test_pallas_cholesky.py)."""
    rng = np.random.RandomState(seed)
    B = rng.randn(n, n)
    return B @ B.T + n * np.eye(n)


def _both(A, dtype=np.float32):
    A = np.asarray(A, dtype)
    return jnp.asarray(A), torch.as_tensor(A)


@pytest.mark.parametrize("n", [128, 200, 256, 384])
def test_cholesky_kernel_matches_pallas_interpret(n):
    A_j, A_t = _both(_spd(n))
    want = np.asarray(jchol.cholesky_pallas(A_j))
    L = cholesky_kernel(A_t).numpy()
    np.testing.assert_allclose(L, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(L, np.linalg.cholesky(_spd(n)), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(L @ L.T, A_t.numpy(), rtol=2e-4, atol=2e-3)
    assert not np.triu(L, 1).any()


@pytest.mark.parametrize("n", [128, 300, 512])
def test_cholesky_inverse_kernel_matches_pallas_interpret(n):
    A_j, A_t = _both(_spd(n, seed=n))
    want_L, want_Li = jchol.cholesky_inverse_pallas(A_j)
    L, Li = (t.numpy() for t in cholesky_inverse_kernel(A_t))
    np.testing.assert_allclose(L, np.asarray(want_L), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Li, np.asarray(want_Li), rtol=2e-4, atol=2e-4)
    assert not np.triu(L, 1).any() and not np.triu(Li, 1).any()


def _grad_t(fn, A, loss):
    leaf = A.clone().requires_grad_()
    return torch.autograd.grad(loss(fn(leaf)), leaf)[0].numpy()


def test_cholesky_kernel_grad_matches_pallas():
    A_j, A_t = _both(_spd(128, seed=1))

    def f_jax(A):
        L = jchol.cholesky_pallas(A)
        return jnp.sum(jnp.log(jnp.diagonal(L))) + 0.1 * jnp.sum(L)

    got = _grad_t(cholesky_kernel, A_t, lambda L: torch.log(
        torch.diagonal(L)).sum() + 0.1 * L.sum())
    np.testing.assert_allclose(got, np.asarray(jax.grad(f_jax)(A_j)),
                               rtol=2e-3, atol=1e-4)


def test_cholesky_inverse_kernel_grad_matches_pallas():
    A_j, A_t = _both(_spd(96, seed=5))

    def f_jax(A):
        L, Li = jchol.cholesky_inverse_pallas(A)
        return jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(Li ** 2)

    def loss(out):
        L, Li = out
        return torch.log(torch.diagonal(L)).sum() + (Li ** 2).sum()

    got = _grad_t(cholesky_inverse_kernel, A_t, loss)
    np.testing.assert_allclose(got, np.asarray(jax.grad(f_jax)(A_j)),
                               rtol=2e-3, atol=1e-4)
    # One backward for both: chol_and_inverse's gives the same bits.
    assert np.array_equal(got, _grad_t(tobj.chol_and_inverse, A_t, loss))


@pytest.mark.parametrize("n", [1, 57, 130])
def test_cholesky_backward_equals_jax_vjp_f64(n):
    """chol_bwd, the closed form of CholeskyFn's backward, against
    ``jax.vjp(jnp.linalg.cholesky)``."""
    rng = np.random.RandomState(n)
    A = _spd(n, seed=n)
    gL = np.tril(rng.randn(n, n))
    _, vjp = jax.vjp(jnp.linalg.cholesky, jnp.asarray(A))
    want = np.asarray(vjp(jnp.asarray(gL))[0])
    leaf = torch.as_tensor(A).requires_grad_()
    got = torch.autograd.grad(cholesky_kernel(leaf), leaf,
                              grad_outputs=torch.as_tensor(gL))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("n,block", [(256, 256), (512, 256), (512, 128),
                                     (768, 256)])
def test_tri_inverse_blocked_matches_jax(n, block):
    L_np = np.linalg.cholesky(_spd(n, seed=1)).astype(np.float32)
    want = np.asarray(jchol.tri_inverse_blocked(jnp.asarray(L_np),
                                                block=block))
    L = torch.as_tensor(L_np)
    Li = tri_inverse_blocked(L, block=block)
    err = float((Li @ L - torch.eye(n)).abs().max())
    assert err < 5e-6, err
    assert not torch.triu(Li, 1).any()
    np.testing.assert_allclose(Li.numpy(), want, rtol=2e-4, atol=2e-4)


def test_tri_inverse_blocked_rejects_bad_block():
    L = cholesky_ref(torch.as_tensor(_spd(300, seed=2), dtype=torch.float32))
    with pytest.raises(ValueError, match="multiple"):
        tri_inverse_blocked(L, block=256)


def test_posterior_rebuilt_through_fused_entry_matches_jax():
    """The posterior solve of tests/test_pallas_cholesky.py:46-63 with the
    port's fused entry: every field of solve_posterior, f32."""
    rng = np.random.RandomState(2)
    X, y = rng.randn(300, 4), rng.randn(300)
    theta = [np.asarray(a, np.float32) for a in
             init_params(jax.random.PRNGKey(0), 4, 10, 54, jnp.float32)]
    p_j = jobj.SCFGPParams(*[jnp.asarray(a) for a in theta])
    stats_j = jobj.sufficient_stats(
        jobj.fourier_features(p_j, jnp.asarray(X, jnp.float32)),
        jnp.asarray(y, jnp.float32))
    want = jobj.solve_posterior(stats_j, jnp.exp(2.0 * p_j.a))

    p = params_from_numpy(theta, torch.float32)
    Xt, yt = (torch.as_tensor(a, dtype=torch.float32) for a in (X, y))
    stats = tobj.sufficient_stats(tobj.fourier_features(p, Xt), yt)
    sig2_n = torch.exp(2.0 * p.a)
    A = stats.phiTphi + (sig2_n + tobj.EPSILON) * torch.eye(128)
    L, Li = cholesky_inverse_kernel(A)
    beta = Li @ stats.phiTy
    got = tobj.Posterior(L=L, Li=Li, alpha=Li.T @ beta, beta=beta,
                         log_diag_L=torch.log(torch.diagonal(L)))
    np.testing.assert_allclose(cholesky_kernel(A).numpy(),
                               np.asarray(want.L), rtol=2e-3, atol=2e-3)
    for name in tobj.Posterior._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_plain_routes_give_nan_where_not_positive_definite():
    A = -torch.eye(5)
    assert torch.isnan(cholesky_kernel(A)).any()
    L, Li = cholesky_inverse_kernel(A)
    assert torch.isnan(L).any() and torch.isnan(Li).any()


def test_raw_wrappers_refuse_cpu_and_grad_tensors():
    A = torch.as_tensor(_spd(8), dtype=torch.float32)
    before = (cholesky_cuda.launches, cholesky_inverse_cuda.launches)
    for fn in (cholesky_cuda, cholesky_inverse_cuda):
        with pytest.raises(ValueError, match="expected a CUDA device"):
            fn(A)
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(A.clone().requires_grad_())
    assert (cholesky_cuda.launches, cholesky_inverse_cuda.launches) == before


def test_crossover_returns_every_leg_on_cpu():
    res = crossover(sizes=[64, 96], device="cpu", iters=1, reps=1)
    assert res["device"] == "cpu" and sorted(res["sizes"]) == [64, 96]
    for cell in res["sizes"].values():
        assert set(cell["legs"]) == set(LEGS)
        assert cell["neumann_err"] < 1e-5
        for name, row in cell["legs"].items():
            assert row["call_ms"] > 0 and row["device_ms"] is None
            if name.startswith("kernel"):
                # the plain route on the CPU: torch's pair, bit for bit
                assert row["max_abs_err"] == 0.0


def test_crossover_input_is_the_jax_scripts():
    from scfgp_tpu_torch.experiments.chol_crossover import spd_input
    rng = np.random.RandomState(0)
    B = rng.randn(50, 50).astype(np.float32) / np.float32(math.sqrt(50))
    want = B @ B.T + np.eye(50, dtype=np.float32)
    assert np.array_equal(spd_input(50, "cpu").numpy(), want)


def test_time_fn_reports_calls_per_second():
    out = time_fn(lambda a: a @ a, torch.ones(8, 8), iters=3, warmup=1)
    assert set(out) == {"calls_per_s", "ms_per_call"}
    assert out["ms_per_call"] > 0
    assert math.isclose(out["calls_per_s"], 1e3 / out["ms_per_call"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        time_fn(lambda: torch.ones(2), iters=1, warmup=0, clock="device")


def test_assert_deterministic_raises_on_a_changing_function():
    A = torch.as_tensor(_spd(16), dtype=torch.float32)
    ref = assert_deterministic(cholesky_inverse_kernel, A)
    assert len(ref) == 2 and np.array_equal(ref[0],
                                            cholesky_ref(A).numpy())
    calls = iter(range(10))
    with pytest.raises(AssertionError, match="non-deterministic"):
        assert_deterministic(lambda: torch.full((3,), float(next(calls))))


def test_trace_writes_a_profile(tmp_path):
    with trace(str(tmp_path)) as prof:
        cholesky_kernel(torch.as_tensor(_spd(32), dtype=torch.float32))
    assert list(tmp_path.iterdir())
    assert any("cholesky" in e.key for e in prof.key_averages())


def test_debug_numerics_names_the_op_that_made_nan():
    x = torch.tensor([-1.0], requires_grad=True)
    with debug_numerics(), pytest.raises(RuntimeError, match="Sqrt"):
        torch.sqrt(x).sum().backward()


def test_chol_variants_edits_the_source_and_needs_a_card():
    """The variant timer cuts 1-based line ranges, then applies each
    replacement exactly once; it refuses to run without a card."""
    from scfgp_tpu_torch.experiments import chol_variants
    text = "a\nb\nc\nd\ne\n"
    assert chol_variants.edit_source(text, drop=[(2, 3)]) == "a\nd\ne\n"
    assert chol_variants.edit_source(
        text, drop=[(5, 5)], replace=[("b\\nc", "x")]) == "a\nx\nd\n"
    with pytest.raises(ValueError, match="occurs 0 times"):
        chol_variants.edit_source(text, replace=[("z", "y")])
    with pytest.raises(ValueError, match="occurs 2 times"):
        chol_variants.edit_source("q\nq\n", replace=[("q", "y")])
    if not torch.cuda.is_available():
        assert chol_variants.main(["--sizes", "64"]) == 1
