"""Batched sweeps and ensembles of the port against the JAX package: the
co2 loader and the surrogate floors, the feature map and the loss with a
leading trial axis against ``jax.vmap``, and the port's mirrors of
``tests/test_batch_fit.py`` (``fit_fast_batch`` against sequential
``fit_fast``, ``run_sweep``, ``fit_ensemble``).

Tolerances:
  * the batched plain feature map and its backward against the vmapped
    Pallas kernel in interpret mode: f32, rtol 2e-5, atol 2e-6, the Pallas
    tests' own (as tests/test_torch_phi.py);
  * the batched loss and gradients against ``jax.vmap(loss_fn)`` in f64:
    rtol 1e-9, the same math in another summation order through a 2K x 2K
    Cholesky (as tests/test_torch_objective.py);
  * batched against sequential fits, f64: the JAX tolerances of
    ``tests/test_batch_fit.py:49-72``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.data import datasets as jds
from scfgp_tpu.models.objective import loss_fn as jax_loss_fn
from scfgp_tpu.models.params import init_params as jax_init_params
from scfgp_tpu.ops.phi import fourier_features_pallas
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.data import datasets as tds
from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
from scfgp_tpu_torch.models.model import fit_fast_batch
from scfgp_tpu_torch.models.objective import loss_and_grad
from scfgp_tpu_torch.models.params import SCFGPParams
from scfgp_tpu_torch.ops.phi import (FourierFeatures, fourier_features_ref,
                                     phi_bwd_ref)

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-5, atol=2e-6)
F64_RTOL = 1e-9

# -- co2 and the floors ----------------------------------------------------


@pytest.mark.parametrize("name", list(jds.ORACLES))
def test_surrogate_floor_equals_jax(name):
    loader = {"boston_housing": "load_boston"}.get(name, "load_" + name)
    _, _, Xv, yv, meta = getattr(tds, loader)(seed=3)
    assert meta["source"] == "synthetic-surrogate"
    assert tds.surrogate_floor(name, Xv, yv) == jds.surrogate_floor(
        name, Xv, yv)
    np.testing.assert_array_equal(tds.ORACLES[name](Xv),
                                  jds.ORACLES[name](Xv))
    np.testing.assert_array_equal(tds.ORACLE_STDS[name](Xv),
                                  jds.ORACLE_STDS[name](Xv))


# -- the feature map with a trial axis ----------------------------------------


def _batched_inputs(B, n, d, k, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, d), 3.0 * rng.randn(B, d, k),
            rng.uniform(0, 2 * np.pi, (B, k)), rng.uniform(0.5, 1.5, B),
            rng.randn(B, n, 2 * k))


@pytest.mark.parametrize("B,n,d,k", [(3, 40, 13, 35), (2, 130, 1, 5)])
def test_batched_feature_map_matches_vmapped_pallas(B, n, d, k):
    X, F, p, s, g = [np.asarray(a, np.float32)
                     for a in _batched_inputs(B, n, d, k)]

    def phi(X_, F_, p_, s_):
        return fourier_features_pallas(X_, F_, p_, s_, interpret=True)

    ref, vjp = jax.vjp(jax.vmap(phi), *map(jnp.asarray, (X, F, p, s)))
    _, dF, dp, ds = vjp(jnp.asarray(g))
    Xt, Ft, pt, st, gt = map(torch.as_tensor, (X, F, p, s, g))
    got = fourier_features_ref(Xt, Ft, pt, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    for a, b in zip(phi_bwd_ref(Xt, Ft, pt, st, gt), (dF, dp, ds)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6 * float(np.abs(b).max()))


def test_batched_function_is_per_trial_on_cpu():
    """FourierFeatures with a trial axis gives each trial what the 2-D call
    gives it, forward and backward (f64: the batched product sums in
    another order at most)."""
    X, F, p, s, g = map(torch.as_tensor, _batched_inputs(3, 50, 4, 9))
    leaves = [t.clone().requires_grad_() for t in (F, p, s)]
    Phi = FourierFeatures.apply(X, *leaves)
    grads = torch.autograd.grad(Phi, leaves, grad_outputs=g)
    for b in range(3):
        one = [t[b].clone().requires_grad_() for t in (F, p, s)]
        Phi_b = FourierFeatures.apply(X[b], *one)
        np.testing.assert_allclose(Phi[b].detach().numpy(),
                                   Phi_b.detach().numpy(), rtol=1e-13,
                                   atol=1e-13)
        for a, c in zip(grads, torch.autograd.grad(Phi_b, one,
                                                   grad_outputs=g[b])):
            np.testing.assert_allclose(a[b].numpy(), c.numpy(), rtol=1e-12,
                                       atol=1e-12)


# -- the loss with a trial axis -----------------------------------------------


def _linear_jax(X):
    return X


def _linear_torch(X):
    return X


@pytest.mark.parametrize("basis", [False, True])
def test_batched_loss_and_gradient_match_vmapped_jax(basis):
    B, n, d, S, M = 3, 60, 3, 2, 7
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    pj = [jax_init_params(k, d, S, M, jnp.float64) for k in keys]
    stacked = [np.stack([np.asarray(getattr(p, f)) for p in pj])
               for f in pj[0]._fields]
    rng = np.random.RandomState(5)
    X, y = rng.rand(B, n, d), rng.randn(B, n)

    def one(p, X_, y_):
        return jax_loss_fn(p, X_, y_,
                           basis_fn=_linear_jax if basis else None)
    vg = jax.jit(jax.vmap(jax.value_and_grad(one, has_aux=True)))
    (cost_j, aux_j), grad_j = vg(type(pj[0])(*map(jnp.asarray, stacked)),
                                 jnp.asarray(X), jnp.asarray(y))

    p = SCFGPParams(*[torch.as_tensor(a) for a in stacked])
    (cost, aux), grads = loss_and_grad(
        p, torch.as_tensor(X), torch.as_tensor(y),
        basis_fn=_linear_torch if basis else None)
    assert cost.shape == (B,)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_j),
                               rtol=F64_RTOL)
    np.testing.assert_allclose(aux.nlml.numpy(), np.asarray(aux_j.nlml),
                               rtol=F64_RTOL)
    for f in grads._fields:
        a, b = getattr(grads, f).numpy(), np.asarray(getattr(grad_j, f))
        assert a.shape == b.shape
        # Phase gradients are pure gauge (about zero): held absolutely, at
        # the scale of the largest gradient entry.
        top = max(float(np.abs(np.asarray(t)).max()) for t in grad_j)
        np.testing.assert_allclose(a, b, rtol=F64_RTOL,
                                   atol=F64_RTOL * top, err_msg=f)
    for f in aux.post._fields:
        b = np.asarray(getattr(aux_j.post, f))
        np.testing.assert_allclose(getattr(aux.post, f).numpy(), b,
                                   rtol=1e-8, atol=1e-8 * np.abs(b).max(),
                                   err_msg=f)


# -- batched fits: the port's mirrors of tests/test_batch_fit.py ---------------


def _make_splits(B, n=120, d=3):
    out = []
    for b in range(B):
        X, y = synthetic_gp_rff(n=n + 30, d=d, s=3, m=6, seed=b)
        out.append((X[:n], y[:n], X[n:], y[n:]))
    return out


OPT = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
       "max_iter": 40, "cvrg_tol": 1e-6, "max_cvrg": 10}


def _model(seed):
    return SCFGP(sparsity=3, nfeats=6, seed=seed, device="cpu",
                 dtype=torch.float64)


@pytest.mark.parametrize("obj", ["COST", "SCORE"])
def test_batched_equals_sequential(obj):
    B = 3
    splits = _make_splits(B)
    data = splits if obj == "SCORE" else [s[:2] for s in splits]
    seq = []
    for b in range(B):
        m = _model(100 + b)
        m.fit_fast(*data[b], obj=obj, **OPT)
        seq.append(m)
    bat = [_model(100 + b) for b in range(B)]
    assert fit_fast_batch(bat, data, obj=obj, **OPT) is bat
    for ms, mb in zip(seq, bat):
        assert len(mb.evals["COST"][1]) == len(ms.evals["COST"][1])
        np.testing.assert_allclose(mb.evals["COST"][1], ms.evals["COST"][1],
                                   rtol=1e-6)
        for a, b_ in zip(ms.params, mb.params):
            np.testing.assert_allclose(b_.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-7)
        assert mb.min_obj_ind == -1 and mb._ensemble is None
        if obj == "SCORE":
            for metric in ("NMSE", "MNLP", "SCORE", "RMSE"):
                np.testing.assert_allclose(mb.evals[metric][1][-1],
                                           ms.evals[metric][1][-1],
                                           rtol=1e-5, err_msg=metric)
    if obj == "SCORE":  # early stopping is per trial: lengths differ
        assert len({len(m.evals["COST"][1]) for m in bat}) > 1


def test_batched_trials_stay_independent():
    """Another trial's data does not change a trial's result, bit for
    bit."""
    B = 2
    splits = _make_splits(B)
    bat1 = [_model(100 + b) for b in range(B)]
    fit_fast_batch(bat1, splits, obj="SCORE", **OPT)
    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=6, seed=77)
    bat2 = [_model(100 + b) for b in range(B)]
    fit_fast_batch(bat2, [splits[0], (X[:120], y[:120], X[120:], y[120:])],
                   obj="SCORE", **OPT)
    assert bat2[0].evals["COST"][1] == bat1[0].evals["COST"][1]
    assert all(torch.equal(a, b) for a, b in zip(bat1[0].params,
                                                 bat2[0].params))


def test_fit_fast_batch_refuses_mesh_and_mismatched_models():
    splits = _make_splits(2)
    with pytest.raises(ValueError, match="identical"):
        fit_fast_batch([_model(0), SCFGP(sparsity=3, nfeats=7, seed=1,
                                          device="cpu",
                                          dtype=torch.float64)], splits)
    with pytest.raises(ValueError, match="equal length"):
        fit_fast_batch([_model(0)], splits)
    assert fit_fast_batch([], []) == []


def test_run_sweep_batched_with_restarts(tmp_path):
    import json
    from scfgp_tpu_torch.utils.experiment import run_sweep

    def loader(seed=0):
        X, y = synthetic_gp_rff(n=140, d=3, s=3, m=6, seed=seed)
        return X[:110], y[:110], X[110:], y[110:], \
            {"name": "synthetic", "source": "synthetic"}

    summary = run_sweep("toy", loader, [6], sparsity=3, trials=2,
                        opt_params=dict(OPT, obj="SCORE"),
                        out_dir=str(tmp_path), batched=True, restarts=2,
                        device="cpu", dtype=torch.float64)
    assert summary["restarts"] == 2 and summary["batched"]
    assert len(summary["metrics"]["NMSE"]["mean"]) == 1
    assert np.isfinite(summary["metrics"]["NMSE"]["mean"][0])
    assert (tmp_path / "best_model.pkl").exists()
    with open(tmp_path / "results.json") as f:
        assert json.load(f)["plots"] is summary["plots"]


def test_boston_driver_batched_quick(tmp_path):
    """The ported driver end to end on the CPU: one trial a size, a floor
    ratio per size."""
    from scfgp_tpu_torch.experiments import boston_housing
    summary = boston_housing.main(["--cpu", "--quick", "--trials", "1",
                                   "--batched", "--out", str(tmp_path)])
    assert summary["batched"] and summary["nfeats_choices"] == [10, 30]
    assert len(summary["nmse_over_floor"]) == 2
    assert all(np.isfinite(summary["nmse_over_floor"]))


def test_fit_ensemble_mixture_and_roundtrip(tmp_path):
    X, y = synthetic_gp_rff(n=180, d=3, s=3, m=6, seed=5)
    Xt, yt, Xv, yv = X[:140], y[:140], X[140:], y[140:]
    m = _model(0)
    m.fit_ensemble(Xt, yt, Xv, yv, k=3, obj="SCORE", **{
        k_: v for k_, v in OPT.items() if k_ != "algo"})
    assert m._ensemble is not None and len(m._ensemble) == 3
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert np.isfinite(nmse) and nmse < 1.0

    mu, std = m.predict(Xv)
    assert mu.shape[0] == Xv.shape[0] and np.all(std > 0)
    m2 = _model(1)
    m2.fit_ensemble(Xt, yt, Xv, yv, k=4, mix_best=2, obj="SCORE", **OPT)
    assert len(m2._ensemble) == 2

    p = str(tmp_path / "ens.pkl")
    m.save(p)
    m3 = SCFGP(device="cpu", dtype=torch.float64).load(p)
    mu3, std3 = m3.predict(Xv)
    np.testing.assert_allclose(mu3, mu, rtol=1e-12)
    np.testing.assert_allclose(std3, std, rtol=1e-12)

    m.fit_fast(Xt, yt, max_iter=10)  # a point fit supersedes the mixture
    assert m._ensemble is None
