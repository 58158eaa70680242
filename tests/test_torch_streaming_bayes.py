"""The Bayes layer over the streaming objective on the CPU, against the JAX
package: ``loss_fn_streaming`` with a trial (chain) axis, the streaming log
posterior, the full-batch (ULA) estimator, the streaming mixture and
``fit_bayes(streaming_block)``; and the ported drivers at tiny sizes.

Tolerances, each with its reason:
  * float64, the port's streaming log posterior (the residual form of the
    data-fit term) against JAX's ``make_logposterior(streaming_block)``
    under ``vmap`` (the reference form): rtol 1e-9 on the value, and on the
    gradient atol 1e-9 of its largest entry; the two forms agree to ~1e-10
    (tests/test_torch_bayes.py::
    test_residual_fit_equals_reference_form_float64) and the sums run in
    another order;
  * float32, the streaming log posterior against the port's dense one:
    JAX's rtol 1e-5 on the value and 1e-4 on the gradient
    (tests/test_bayes.py:266-286), both in the residual form;
  * a chain of a batch against its own 1-chain call, and a trial of
    ``loss_fn_streaming`` against its 1-trial call: rtol 1e-12 in float64
    (the same sums; batched products may round otherwise);
  * the streaming mixture against JAX's and against the port's dense one:
    rtol 1e-9 in float64 (tests/test_torch_bayes.py's mixture tolerance).
"""

import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu.bayes import sgld as jsgld
from scfgp_tpu.bayes.predictive import (make_logposterior as jax_logpost,
                                        predictive_mixture as jax_mixture)
from scfgp_tpu.models.params import init_params as jax_init_params
from scfgp_tpu.models.params import pack_params as jax_pack
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.bayes import (batched_value_and_grad, make_logposterior,
                                   make_minibatch_value_and_grad,
                                   predictive_mixture, reduced_dim)
from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
from scfgp_tpu_torch.experiments import bayes_precision as bp
from scfgp_tpu_torch.models.objective import loss_fn, value_and_grad
from scfgp_tpu_torch.models.params import unpack_params
from scfgp_tpu_torch.ops.streaming import loss_fn_streaming
from test_torch_bayes_fit import SAMPLER_KW, _regression

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_bayes.py:266-286: N=250 in blocks of 64, the last ragged.
D, S, M, N, BLOCK = 3, 4, 10, 250, 64
P = reduced_dim(D, S, M)


def _data(dtype=np.float64, n=N, seed=3):
    return synthetic_gp_rff(n=n, d=D, s=S, m=M, noise_std=0.1, seed=seed,
                            dtype=dtype)


def _thetas(C, dtype=jnp.float64, full=False):
    """C positions from the JAX package's init (reduced unless ``full``)."""
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    return np.stack([np.asarray(jax_pack(jax_init_params(k, D, S, M, dtype)))
                     [:None if full else P] for k in keys])


def _close(got, want, rtol=1e-9):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol)


def _grad_close(got, want, rel=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_streaming_logposterior_equals_jax_float64():
    """Value and gradient of three chains against JAX's streaming log
    posterior under ``vmap``; each chain of the batch equals its 1-chain
    call, and the (P,) form its chain."""
    X, y = _data()
    th = _thetas(3)
    lp_j = jax_logpost(jnp.asarray(X), jnp.asarray(y), D, S, M,
                       streaming_block=BLOCK)
    v_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(lp_j)))(jnp.asarray(th))
    lp = make_logposterior(torch.as_tensor(X), torch.as_tensor(y), D, S, M,
                           streaming_block=BLOCK)
    v, g = batched_value_and_grad(lp)(torch.as_tensor(th))
    _close(v, v_j)
    _grad_close(g, g_j)
    for c in range(3):
        v1, g1 = batched_value_and_grad(lp)(torch.as_tensor(th[c:c + 1]))
        _close(v1, v[c:c + 1].numpy(), rtol=1e-12)
        _grad_close(g1, g[c:c + 1].numpy(), rel=1e-12)
    with torch.no_grad():
        _close(lp(torch.as_tensor(th[1])), v[1].numpy(), rtol=1e-12)


def test_streaming_logposterior_float32_matches_dense():
    """tests/test_bayes.py:266-286 in float32 at its position (JAX's init
    from key 0), both in the residual form, at JAX's tolerances."""
    X, y = (torch.as_tensor(a) for a in _data(np.float32))
    th = torch.as_tensor(np.asarray(jax_pack(jax_init_params(
        jax.random.PRNGKey(0), D, S, M, jnp.float32)))[None, :P])
    v_d, g_d = batched_value_and_grad(make_logposterior(X, y, D, S, M))(th)
    v_s, g_s = batched_value_and_grad(make_logposterior(
        X, y, D, S, M, streaming_block=BLOCK))(th)
    np.testing.assert_allclose(v_s.numpy(), v_d.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_s.numpy(), g_d.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ula_estimator_equals_jax():
    """tests/test_sgld.py:89-110 in float64: the full-batch estimator over
    the streaming log posterior against JAX's, and against the port's
    dense one."""
    X, y = _data(n=160, seed=0)
    q = _thetas(2)
    vg_j = jsgld.make_minibatch_value_and_grad(
        jnp.asarray(X), jnp.asarray(y), D, S, M, batch_size=0,
        streaming_block=BLOCK)
    v_j, g_j = vg_j(jnp.asarray(q), jax.random.PRNGKey(0))
    Xt, yt, qt = (torch.as_tensor(a) for a in (X, y, q))
    v, g = make_minibatch_value_and_grad(Xt, yt, D, S, M, batch_size=0,
                                         streaming_block=BLOCK)(qt, None)
    _close(v, v_j)
    _grad_close(g, g_j)
    v_d, g_d = make_minibatch_value_and_grad(Xt, yt, D, S, M,
                                             batch_size=0)(qt, None)
    _close(v, v_d.numpy(), rtol=1e-12)
    _grad_close(g, g_d.numpy(), rel=1e-9)


def test_streaming_mixture_equals_jax_and_refuses_recalibrate():
    """Seven draws in chunks of three (the last padded with weight 0):
    JAX's streaming mixture, the port's dense one, and ``ValueError`` for
    ``recalibrate`` with streaming."""
    X, y = _data()
    Xs = np.random.RandomState(4).rand(30, D)
    th = _thetas(7)
    mu_j, sd_j = jax_mixture(jnp.asarray(th), jnp.asarray(X), jnp.asarray(y),
                             jnp.asarray(Xs), D, S, M, chunk=3,
                             streaming_block=BLOCK)
    args = (torch.as_tensor(th), torch.as_tensor(X), torch.as_tensor(y),
            torch.as_tensor(Xs), D, S, M)
    mu, sd = predictive_mixture(*args, chunk=3, streaming_block=BLOCK)
    _close(mu, mu_j)
    _close(sd, sd_j)
    mu_d, sd_d = predictive_mixture(*args, chunk=3)
    _close(mu, mu_d.numpy())
    _close(sd, sd_d.numpy())
    with pytest.raises(ValueError, match="streaming_block"):
        predictive_mixture(*args, streaming_block=BLOCK, recalibrate=True)


def _trial_problem(B, weighted, basis):
    X, y = _data()
    w = (np.arange(N) % 4 != 0).astype(np.float64) if weighted else None
    p = unpack_params(torch.as_tensor(_thetas(B, full=True)), D, S, M)
    basis_fn = ((lambda Xi: torch.stack([torch.ones_like(Xi[:, 0]),
                                         Xi[:, 0]], dim=1)) if basis
                else None)
    return (p, torch.as_tensor(X), torch.as_tensor(y),
            None if w is None else torch.as_tensor(w), basis_fn)


@pytest.mark.parametrize("residual_fit", [False, True])
@pytest.mark.parametrize("weighted,basis", [(False, False), (True, False),
                                            (False, True)],
                         ids=["plain", "weighted", "basis"])
def test_loss_fn_streaming_trials_equal_their_own_calls(residual_fit,
                                                        weighted, basis):
    """Params with a trial axis B=3: cost (3,), each trial's value and
    gradient its own 1-trial call's; and the dense ``loss_fn`` of the same
    form (the same sums in other blocks)."""
    p, X, y, w, basis_fn = _trial_problem(3, weighted, basis)
    kw = dict(w=w, block_size=BLOCK, basis_fn=basis_fn,
              residual_fit=residual_fit)
    (cost, _), g = value_and_grad(loss_fn_streaming, p, X, y, **kw)
    assert cost.shape == (3,)
    for b in range(3):
        pb = type(p)(*(t[b] for t in p))
        (cb, _), gb = value_and_grad(loss_fn_streaming, pb, X, y, **kw)
        _close(cost[b], cb.numpy(), rtol=1e-12)
        for name, a, c in zip(g._fields, g, gb):
            np.testing.assert_allclose(a[b].numpy(), c.numpy(), rtol=1e-10,
                                       atol=1e-12, err_msg=name)
        cd, _ = loss_fn(pb, X, y, w=w, basis_fn=basis_fn,
                        residual_fit=residual_fit)
        _close(cb, cd.numpy(), rtol=1e-12)


def test_kernel_route_refuses_a_trial_axis():
    p, X, y, _, _ = _trial_problem(2, False, False)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        loss_fn_streaming(p, X, y, block_size=BLOCK, stats_impl="kernel")
    pb = type(p)(*(t[0] for t in p))
    c, _ = loss_fn_streaming(pb, X, y, block_size=BLOCK, stats_impl="kernel")
    c_g, _ = loss_fn_streaming(pb, X, y, block_size=BLOCK)
    _close(c, c_g.numpy(), rtol=1e-12)


@pytest.mark.parametrize("sampler", list(SAMPLER_KW))
def test_fit_bayes_streams_every_sampler(sampler):
    """``fit_bayes(streaming_block)`` at a tiny budget: finite draws, the
    block kept for ``predict_bayes``, whose mixture equals the dense mixture
    of the same draws; ``recalibrate=True`` then raises."""
    X, y, Xv, yv = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=0, device="cpu",
              dtype=torch.float64)
    kw = dict(SAMPLER_KW[sampler])
    if sampler == "sgld":
        kw.update(batch_size=0)  # the full-batch (ULA) estimator streams
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, Xv, yv, sampler=sampler, chains=3, num_warmup=4,
                    num_samples=5, num_integration_steps=3,
                    streaming_block=32, **kw)
    assert m._bayes_streaming_block == 32
    assert torch.isfinite(m.thetas).all() and m.thetas.shape[0] == 15
    mu, sd = m.predict_bayes(Xv)
    mu_d, sd_d = predictive_mixture(m.thetas, m.X, m.y, m._scale_X(Xv),
                                    m.D, m.S, m.M)
    mu_y, sd_y = m._unscale_moments(mu_d, sd_d)
    np.testing.assert_allclose(mu, mu_y, rtol=1e-9)
    np.testing.assert_allclose(sd, sd_y, rtol=1e-9)
    with pytest.raises(ValueError, match="recalibrate"):
        m.predict_bayes(Xv, recalibrate=True)


def test_tempered_adaptation_key_includes_the_streaming_block():
    """scfgp_tpu/models/model.py:1256-1262: a tempered fit with another
    streaming block re-adapts (a new key)."""
    X, y, _, _ = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=0, device="cpu")
    kw = dict(sampler="tempered", chains=2, num_warmup=3, num_samples=2,
              num_integration_steps=2, max_rungs=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, **kw)
        m.fit_bayes(X, y, streaming_block=32, **kw)
    assert sorted(k[8] for k in m._bayes_adaptation) == [0, 32]


def test_precision_terms_run_on_the_device_they_are_given(monkeypatch):
    """``--mode terms`` runs on the card unless given ``--cpu``, as fleet
    mode does; every reading names the device of its float32 terms."""
    monkeypatch.setattr(bp, "S", 2)
    monkeypatch.setattr(bp, "M", 4)
    lines = bp.main(["--mode", "terms", "--cpu", "--rows", "120"])
    assert len(lines) == 4
    assert {ln["device"] for ln in lines} == {"cpu"}
    seen = []
    monkeypatch.setattr(bp, "terms", lambda args, device: seen.append(device))
    monkeypatch.setattr(bp, "fleet", lambda args, device: seen.append(device))
    bp.main(["--mode", "terms"])
    bp.main(["--mode", "fleet"])
    bp.main(["--mode", "terms", "--cpu"])
    assert seen == ["cuda", "cuda", "cpu"]


def test_campaign_driver_runs_its_arms_on_the_cpu(tmp_path, monkeypatch):
    """experiments/bayes_predictive.py --cpu --tiny on boston at a narrow
    width: one line an arm, the recalibrated and bootstrap fields of the
    Bayes arms, the summary and the results file."""
    from scfgp_tpu_torch.experiments import bayes_predictive as bpd
    monkeypatch.setitem(bpd.DATASETS, "boston",
                        dict(bpd.DATASETS["boston"], S=2, M=4))
    monkeypatch.setattr(bpd, "BAYES", {a: bpd.BAYES[a]
                                       for a in ("hmc", "sgld")})
    out = bpd.main(["--cpu", "--tiny", "--datasets", "boston", "--seeds",
                    "1", "--out", str(tmp_path)])
    arms = out["boston"]["rows"][0]["arms"]
    assert set(arms) == {"map", "ensemble", "hmc", "sgld"}
    for arm in ("hmc", "sgld"):
        r = arms[arm]
        assert np.isfinite([r["NMSE"], r["MNLP"], r["NMSE_recal"],
                            r["MNLP_recal"], r["mc_std_MNLP"]]).all(), arm
        assert r["NMSE_recal"] == r["NMSE"]  # recalibration moves the std
    assert set(out["boston"]["summary"]) == set(arms)
    assert (tmp_path / "results_tiny.json").exists()


def test_sgld_scale_driver_runs_its_legs_on_the_cpu(tmp_path, monkeypatch):
    """experiments/sgld_scale.py --cpu at a tiny size: the two pSGLD legs
    and the streaming ULA leg, each with its fields; --legs picks one."""
    from scfgp_tpu_torch.experiments import sgld_scale
    monkeypatch.setattr(sgld_scale, "BATCHES", (64, 256))
    args = ["--cpu", "--n", "3000", "--d", "4", "--sparsity", "2",
            "--nfeats", "3", "--chains", "2", "--streaming-block", "1024",
            "--out", str(tmp_path)]
    out = sgld_scale.main(args + ["--warmup", "2", "--samples", "3"])
    assert out["dim"] == 3 + 4 * 2 + 3 * 2
    assert [r["leg"] for r in out["legs"]] == ["psgld-b64", "psgld-b256",
                                               "ula-streaming"]
    for r in out["legs"]:
        assert r["draws_per_s"] > 0 and r["logdensity_finite"]
        assert r["nonfinite"] == 0
    assert (tmp_path / "sgld_scale.json").exists()
    ula = sgld_scale.main(args + ["--legs", "ula-streaming", "--warmup",
                                  "1", "--samples", "2"])
    assert [(r["leg"], r["warmup"], r["samples"]) for r in ula["legs"]] == [
        ("ula-streaming", 1, 2)]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The streaming Bayes path, the precision policy, chain-sharded
    sampling and the new drivers (the floor drivers, the boston probes and
    the tempering campaigns), in a fresh process."""
    code = ("import sys, scfgp_tpu_torch.bayes, scfgp_tpu_torch.bayes.nuts,"
            " scfgp_tpu_torch.ops.streaming,"
            " scfgp_tpu_torch.experiments.bayes_predictive,"
            " scfgp_tpu_torch.experiments.bench_hmc,"
            " scfgp_tpu_torch.experiments.sgld_scale,"
            " scfgp_tpu_torch.experiments.bayes_precision,"
            " scfgp_tpu_torch.parallel, scfgp_tpu_torch.parallel.launch,"
            " scfgp_tpu_torch.ops.dispatch,"
            " scfgp_tpu_torch.experiments.precision_quality,"
            " scfgp_tpu_torch.experiments.precision_matrix,"
            " scfgp_tpu_torch.parallel.chains,"
            " scfgp_tpu_torch.experiments.floor_oracle,"
            " scfgp_tpu_torch.experiments.mnlp_floor,"
            " scfgp_tpu_torch.experiments.kin8nm_floor,"
            " scfgp_tpu_torch.experiments.bf16_accuracy_sweep,"
            " scfgp_tpu_torch.experiments.boston_floor_probe,"
            " scfgp_tpu_torch.experiments.boston_floor_probe2,"
            " scfgp_tpu_torch.experiments.boston_floor_probe3,"
            " scfgp_tpu_torch.experiments.boston_floor_probe4,"
            " scfgp_tpu_torch.experiments.tempering_probe,"
            " scfgp_tpu_torch.experiments.tempering_sweep,"
            " scfgp_tpu_torch.experiments.deep_ladder;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'scfgp_tpu' or "
            "m.startswith('scfgp_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
