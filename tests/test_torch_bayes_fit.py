"""``SCFGP.fit_bayes`` and ``predict_bayes`` of the port on the CPU, the
samplers in law, and a diverging chain inside a batch.

In law: the moment tests of tests/test_bayes.py:34-59 and :134 (HMC and
static NUTS on a correlated Gaussian), the mode escape of :167 (tempered
HMC) and the SGLD masking of tests/test_sgld.py:294, with their tolerances;
the budgets are smaller (HMC 300 + 600 transitions, NUTS 150 + 300 at depth
4) from fixed seeds of the port's generator.
"""

import warnings

import numpy as np
import pytest
import torch

from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.bayes import (batched_value_and_grad, hmc_sample,
                                   make_minibatch_value_and_grad,
                                   nuts_sample_static, reduced_dim,
                                   sgld_sample, tempered_hmc_sample)
from scfgp_tpu_torch.bayes.tempering import geometric_ladder
from test_torch_bayes import D, M, P, S, data, inits, t_, targets

torch.set_num_threads(1)

COV = np.array([[1.0, 0.6, 0.0], [0.6, 2.0, 0.3], [0.0, 0.3, 0.5]])
MEAN = np.array([1.0, -2.0, 0.5])
PREC = torch.as_tensor(np.linalg.inv(COV))


def _gauss(q):
    d = q - torch.as_tensor(MEAN, dtype=q.dtype)
    return -0.5 * torch.sum((d @ PREC.to(q.dtype)) * d, dim=-1)


def _gauss_init(chains, seed):
    return torch.as_tensor(np.random.RandomState(seed).randn(chains, 3))


def test_hmc_recovers_gaussian_moments():
    res = hmc_sample(_gauss, _gauss_init(8, 0), 0, num_warmup=300,
                     num_samples=600, num_integration_steps=12,
                     init_step_size=0.1)
    draws = res.samples.reshape(-1, 3).numpy()
    assert 0.4 < float(res.accept_rate) <= 1.0
    np.testing.assert_allclose(res.inv_mass.numpy(), np.diag(COV), rtol=0.5)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.35)


def test_static_nuts_recovers_gaussian_moments():
    res = nuts_sample_static(_gauss, _gauss_init(8, 1), 1, num_warmup=150,
                             num_samples=300, depth=4, init_step_size=0.1)
    draws = res.samples.reshape(-1, 3).numpy()
    assert 0.5 < float(res.accept_rate) <= 1.0
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.5)


def test_tempered_hmc_escapes_modes_plain_hmc_cannot():
    """tests/test_bayes.py:167: all chains start in the + mode of a
    well-separated mixture; plain HMC stays, the cold rung crosses."""
    sep, sig = 4.0, 0.3

    def lp(q):
        x = q[:, 0]
        return torch.logaddexp(-0.5 * ((x - sep) / sig) ** 2,
                               -0.5 * ((x + sep) / sig) ** 2)

    init = torch.full((4, 1), sep)
    plain = hmc_sample(lp, init, 0, num_warmup=150, num_samples=300,
                       num_integration_steps=8, init_step_size=0.1)
    assert float(plain.samples.min()) > 0.0
    temp = tempered_hmc_sample(lp, init, 0,
                               betas=geometric_ladder(5, beta_min=0.02),
                               num_warmup=150, num_samples=300,
                               num_integration_steps=8, init_step_size=0.1)
    frac_minus = float((temp.samples[..., 0] < 0.0).double().mean())
    assert 0.05 < frac_minus < 0.95, (frac_minus, float(temp.swap_rate))
    assert float(temp.swap_rate) > 0.01


def test_sgld_nan_chain_does_not_poison_shared_preconditioner():
    """tests/test_sgld.py:294: chain 0's gradient is always NaN; it is
    rejected every step, the shared metric stays finite, the rest move."""
    mu = torch.tensor([1.0, -2.0, 0.5, 3.0])
    base = batched_value_and_grad(lambda q: -0.5 * torch.sum((q - mu) ** 2,
                                                             dim=-1))

    def vg(q, rows):
        vals, grads = base(q)
        grads[0] = float("nan")
        return vals, grads

    res = sgld_sample(vg, torch.zeros(4, 4), 3, num_warmup=100,
                      num_samples=500, step_size=0.05,
                      preconditioner="rmsprop", precond_lambda=1e-3)
    assert torch.isfinite(res.precond).all()
    assert int(res.nonfinite) == 600
    np.testing.assert_array_equal(res.samples[:, 0].numpy(), 0.0)
    healthy = res.samples[:, 1:].reshape(-1, 4).numpy()
    np.testing.assert_allclose(healthy.mean(0), mu.numpy(), atol=1.0)


# -- a diverging chain inside a batch ------------------------------------


def _diverging_inits(C):
    """C random inits; chain 0 at b = 1000, where the feature scale
    overflows: its log posterior is NaN (an indefinite Gram), never an
    error."""
    q = inits(C)
    q[0, 1] = 1e3
    return t_(q)


@pytest.mark.parametrize("sampler", ["hmc", "nuts", "tempered", "sgld"])
def test_a_diverging_chain_does_not_stop_the_batch(sampler):
    _, lp = targets()
    q0 = _diverging_inits(3)
    assert torch.isnan(lp(q0[:1])).all() and torch.isfinite(lp(q0[1:])).all()
    kw = dict(num_warmup=4, num_samples=6)
    if sampler == "hmc":
        res = hmc_sample(lp, q0, 0, num_integration_steps=3,
                         init_step_size=0.005, shared_adaptation=False, **kw)
    elif sampler == "nuts":
        res = nuts_sample_static(lp, q0, 0, depth=2, init_step_size=0.005,
                                 shared_adaptation=False, **kw)
    elif sampler == "tempered":
        res = tempered_hmc_sample(lp, q0, 0, betas=[1.0, 0.5],
                                  num_integration_steps=3,
                                  init_step_size=0.005, **kw)
    else:
        X, y = data()
        vg = make_minibatch_value_and_grad(torch.as_tensor(X),
                                           torch.as_tensor(y), D, S, M, 16)
        res = sgld_sample(vg, q0, 0, step_size=1e-5, **kw)
    draws = res.samples
    assert torch.isfinite(draws).all()
    assert torch.equal(draws[:, 0], q0[0].expand(6, P))  # stuck, counted
    assert (draws[-1, 1:] != q0[1:]).any(dim=1).all()    # the others move
    counted = res.nonfinite if sampler == "sgld" else res.divergences
    assert int(counted) >= 6


# -- fit_bayes and predict_bayes -------------------------------------------


def _regression(n=100, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n + 30, 2) * 5
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(n + 30)
    return X[:n], y[:n], X[n:], y[n:]


SAMPLER_KW = {"hmc": dict(shared_adaptation=False),
              "nuts": dict(depth=2), "tempered": dict(max_rungs=3),
              "vi": {}, "sgld": dict(batch_size=32, init_step_size=1e-4,
                                     thin=2)}


@pytest.mark.parametrize("chain_init", ["random", "map", "ensemble"])
@pytest.mark.parametrize("sampler", list(SAMPLER_KW))
def test_fit_bayes_runs_every_sampler_and_init(sampler, chain_init):
    X, y, Xv, yv = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, Xv, yv, sampler=sampler, chains=3, num_warmup=6,
                    num_samples=8, num_integration_steps=3,
                    chain_init=chain_init, map_iters=10,
                    **SAMPLER_KW[sampler])
    Pm = reduced_dim(m.D, m.S, m.M)
    assert m.thetas.shape == (24, Pm) and torch.isfinite(m.thetas).all()
    assert m.bayes_result.samples.shape == (8, 3, Pm)
    d = m.bayes_diagnostics
    assert np.isfinite([d.max_rhat, d.min_ess_bulk, d.min_ess_tail]).all()
    assert d.num_draws == 24 and m.bayes_diagnostics_wall > 0
    assert np.isfinite(m.evals["NMSE"][1][-1]) and m.min_obj_ind == -1
    for recal in (False, True):
        mu, sd = m.predict_bayes(Xv, recalibrate=recal)
        assert mu.shape == sd.shape == (len(Xv), 1)
        assert np.isfinite(mu).all() and (sd > 0).all()


def test_fit_bayes_tempered_reuses_adaptation(monkeypatch):
    """tests/test_bayes.py:385: a second tempered fit on the same data and
    configuration skips the ladder probe and the warmup and continues."""
    X, y, _, _ = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=0, device="cpu")
    kw = dict(sampler="tempered", chains=2, num_warmup=8, num_samples=5,
              num_integration_steps=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, **kw)
        assert len(m._bayes_adaptation) == 1
        e1 = dict(next(iter(m._bayes_adaptation.values())))
        assert e1["steps_done"] == 13
        import scfgp_tpu_torch.bayes.tempering as tp

        def boom(*a, **k):
            raise AssertionError("ladder rebuilt despite persisted adaptation")

        monkeypatch.setattr(tp, "energy_matched_ladder", boom)
        m.fit_bayes(X, y, **kw)
        e2 = next(iter(m._bayes_adaptation.values()))
        np.testing.assert_array_equal(e2["betas"], e1["betas"])
        np.testing.assert_array_equal(e2["eps"], e1["eps"])
        assert e2["steps_done"] == 13 + 5
        assert m.bayes_result.warmup_state is None
        assert not np.array_equal(e2["positions"], e1["positions"])
        with pytest.raises(AssertionError, match="ladder rebuilt"):
            m.fit_bayes(X, y, **dict(kw, chains=3))


def test_fit_bayes_thetas_survive_save_and_load(tmp_path):
    X, y, Xv, yv = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, chains=2, num_warmup=5, num_samples=4,
                    num_integration_steps=3)
    path = str(tmp_path / "bayes.ckpt")
    m.save(path)
    r = SCFGP(device="cpu").load(path)
    assert torch.equal(r.thetas, m.thetas)
    with pytest.raises(RuntimeError, match="set_data"):
        r.predict_bayes(Xv)
    r.set_data(X, y)
    np.testing.assert_array_equal(r.predict_bayes(Xv)[0],
                                  m.predict_bayes(Xv)[0])


def test_fit_bayes_counts_divergences_and_stays_finite():
    """A step size far too large for the posterior: the chains' proposals
    diverge and are rejected, counted, and the draws stay finite."""
    X, y, Xv, yv = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, Xv, yv, chains=3, num_warmup=0, num_samples=6,
                    num_integration_steps=3, init_step_size=50.0)
    assert m.bayes_diagnostics.divergences > 0
    assert torch.isfinite(m.thetas).all()
    assert np.isfinite(m.evals["NMSE"][1][-1])


def test_fit_bayes_refuses_what_it_does_not_take():
    X, y, _, _ = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, chains=2, num_warmup=2, num_samples=2,
                    num_integration_steps=2, streaming_block=64)
    with pytest.raises(ValueError, match="recalibrate"):
        m.predict_bayes(X, recalibrate=True)
    with pytest.raises(ValueError, match="unknown sampler"):
        m.fit_bayes(X, y, sampler="mala")
    with pytest.raises(ValueError, match="chain_init"):
        m.fit_bayes(X, y, chain_init="prior")
    with pytest.raises(RuntimeError, match="fit_bayes"):
        SCFGP(device="cpu").predict_bayes(X)


def test_fit_bayes_maps_features_once_per_batched_gradient(monkeypatch):
    """The structure the card's launch counts rest on: every batched
    gradient of all chains is one feature map forward and one backward
    (K1f and K1b on the card), and nothing else maps features: a fresh
    model's set_data draws its params without a forward."""
    from scfgp_tpu_torch.ops import phi
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = phi.fourier_features_ref, phi.phi_bwd_ref

    def counted(kind, fn):
        def wrapper(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(phi, "fourier_features_ref", counted("fwd", fwd))
    monkeypatch.setattr(phi, "phi_bwd_ref", counted("bwd", bwd))
    X, y, _, _ = _regression()
    m = SCFGP(sparsity=2, nfeats=4, seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, chains=5, num_warmup=3, num_samples=8,
                    num_integration_steps=3, shared_adaptation=False)
    grads = (3 + 8) * (3 + 1)
    assert calls == {"fwd": grads, "bwd": grads}


def test_probe_experiment_arm_records_its_fields(monkeypatch):
    """experiments/kin8nm_bayes_probe.py's arm at a small width."""
    from scfgp_tpu_torch.experiments import kin8nm_bayes_probe as probe
    monkeypatch.setattr(probe, "S", 2)
    monkeypatch.setattr(probe, "M", 4)
    X, y, Xv, yv = _regression()
    rec, m = probe.run_arm(X, y, Xv, yv, floor=0.01, device="cpu",
                           sampler="tempered", chains=2, num_warmup=4,
                           num_samples=8, num_integration_steps=3,
                           max_rungs=3)
    assert m.thetas.shape[0] == rec["draws"] == 16
    assert rec["nmse_over_floor"] == rec["NMSE"] / 0.01
    assert np.isfinite([rec["NMSE"], rec["MNLP"], rec["accept"],
                        rec["recalibrated"]["MNLP"], rec["swap_rate"]]).all()
    assert 2 <= rec["rungs"] <= 3 and rec["config"]["chains"] == 2
