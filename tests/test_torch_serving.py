"""The serving slice of the port against the JAX package: scaler, metrics,
dataset loaders, and the whole path load -> predict -> set_data ->
update_data -> recalibrate_dispersion on committed checkpoints.

Both models run float64 on the CPU (the JAX side under tests/conftest.py,
x64 on), so the slice is held at rtol 1e-8: the same math in another
summation order through a 2K x 2K Cholesky.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scfgp_tpu import SCFGP as JaxSCFGP
from scfgp_tpu.data import datasets as jds
from scfgp_tpu.data.scaler import Scaler as JaxScaler
from scfgp_tpu.utils import metrics as jmetrics
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.data import datasets as tds
from scfgp_tpu_torch.data.scaler import ALGOS, Scaler
from scfgp_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-8


def _ckpt(name):
    return os.path.join(ROOT, "experiments", "results", name,
                        "best_model.pkl")


def _close(a, b, rtol=RTOL, what=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                               err_msg=what)


# -- scaler -------------------------------------------------------------------


def _scaler_data(seed=0, n=200, d=4):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.randn(n, d)) ** 1.5 * rng.gamma(2.0, 1.0, (n, d)) + 0.1
    X[:, 1] = rng.rand(n) * 10 - 3
    X[:, 3] = 2.0  # constant column: dropped at fit time
    return X


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_scaler_matches_jax(algo, compat):
    X = _scaler_data(1)
    ts = Scaler(algo, compat_reference=compat).fit(X)
    js = JaxScaler(algo, compat_reference=compat).fit(X)
    np.testing.assert_array_equal(ts.cols, js.cols)
    assert ts.state.keys() == js.state.keys()
    for k in js.state:
        np.testing.assert_allclose(ts.state[k].numpy(),
                                   np.asarray(js.state[k]), rtol=1e-12)
    tX = ts.forward_transform(X)
    jX = np.asarray(js.forward_transform(X))
    np.testing.assert_allclose(tX.numpy(), jX, rtol=1e-10, atol=1e-13)
    # Inside (0, 1) for the CDF algorithms, so every backward is defined.
    Z = np.clip(jX, 1e-3, 1 - 1e-3)
    np.testing.assert_allclose(ts.backward_transform(Z).numpy(),
                               np.asarray(js.backward_transform(Z)),
                               rtol=1e-9, atol=1e-12)


def test_scaler_state_dict_crosses_packages():
    X = _scaler_data(2)
    js = JaxScaler("auto-inv-normal").fit(X)
    ts = Scaler.from_state_dict(js.to_state_dict())
    np.testing.assert_allclose(ts.forward_transform(X).numpy(),
                               np.asarray(js.forward_transform(X)),
                               rtol=1e-12)
    back = JaxScaler.from_state_dict(ts.to_state_dict())
    np.testing.assert_allclose(np.asarray(back.forward_transform(X)),
                               np.asarray(js.forward_transform(X)),
                               rtol=0, atol=0)


def test_scaler_native_and_bad_algo_raise():
    with pytest.raises(NotImplementedError):
        Scaler("auto-normal", native=True)
    with pytest.raises(ValueError):
        Scaler("bogus")


# -- metrics and loaders --------------------------------------------------------


def test_metrics_equal_jax():
    rng = np.random.RandomState(3)
    mu, std, ys = rng.randn(50), rng.rand(50) + 0.1, rng.randn(50)
    assert (tmetrics.regression_metrics(mu, std, ys)
            == jmetrics.regression_metrics(mu, std, ys))
    assert tmetrics.new_evals_dict() == jmetrics.new_evals_dict()


@pytest.mark.parametrize("name", ["load_boston", "load_abalone",
                                  "load_kin8nm", "load_co2"])
@pytest.mark.parametrize("real", [False, True])
def test_loaders_equal_jax(name, real, monkeypatch):
    if real:  # the JAX package's authentic-format fixture files
        fixtures = os.path.join(ROOT, "tests", "fixtures", "real_formats")
        monkeypatch.setattr(tds, "DATA_DIR", fixtures)
        monkeypatch.setattr(jds, "DATA_DIR", fixtures)
    got = getattr(tds, name)(seed=4)
    want = getattr(jds, name)(seed=4)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


# -- the slice as a whole ----------------------------------------------------------


@pytest.mark.parametrize("name,loader", [
    ("boston_housing", tds.load_boston),
    ("kin8nm", tds.load_kin8nm),
])
def test_serving_slice_matches_jax(name, loader):
    Xt, yt, Xv, yv, _ = loader(seed=0)
    j = JaxSCFGP().load(_ckpt(name))
    t = SCFGP(device="cpu", dtype=torch.float64).load(_ckpt(name))

    for got, want in zip(t.predict(Xv, yv), j.predict(Xv, yv)):
        assert got.shape == (len(Xv), 1)
        _close(got, want, what="predict after load")
    for k in ("NMSE", "MNLP"):
        np.testing.assert_allclose(t.evals[k][1][-1], j.evals[k][1][-1],
                                   rtol=RTOL)
    assert t.TsNMSE == t.evals["NMSE"][1][-1]

    t.set_data(Xt, yt)
    j.set_data(Xt, yt)
    for f in t.post._fields:
        _close(getattr(t.post, f).numpy(), getattr(j.post, f),
               what="set_data " + f)
    assert np.isfinite(float(t.cost))

    k = min(64, len(Xv) // 2)  # held-out rows folded in; the rest served
    t.update_data(Xv[:k], yv[:k])
    j.update_data(Xv[:k], yv[:k])
    assert t.N == j.N == len(Xt) + k
    for f in t.post._fields:
        _close(getattr(t.post, f).numpy(), getattr(j.post, f),
               what="update_data " + f)

    t.recalibrate_dispersion()
    j.recalibrate_dispersion()
    np.testing.assert_allclose(float(t.params.c), float(j.params.c),
                               rtol=RTOL)
    for got, want in zip(t.predict(Xv[k:]), j.predict(Xv[k:])):
        _close(got, want, what="predict after recalibrate")


def test_mixture_members_match_jax(tmp_path):
    """A checkpoint with mixture members (fit_ensemble) predicts and
    recalibrates like the JAX package."""
    Xt, yt, Xv, yv, _ = tds.load_boston(seed=1)
    j = JaxSCFGP().load(_ckpt("boston_housing"))
    j._ensemble = [(j.params, j.post),
                   (j.params._replace(c=j.params.c + 0.5), j.post)]
    path = str(tmp_path / "mix.ckpt")
    j.save(path)
    t = SCFGP(device="cpu", dtype=torch.float64).load(path)
    assert len(t._ensemble) == 2
    for got, want in zip(t.predict(Xv), j.predict(Xv)):
        _close(got, want, what="mixture predict")
    t.set_data(Xt, yt)
    j.set_data(Xt, yt)
    t.recalibrate_dispersion()
    j.recalibrate_dispersion()
    for (tp_, _), (jp_, _) in zip(t._ensemble, j._ensemble):
        np.testing.assert_allclose(float(tp_.c), float(jp_.c), rtol=RTOL)


def test_predict_and_update_before_data_raise():
    m = SCFGP(device="cpu")
    with pytest.raises(RuntimeError, match="predict"):
        m._predict_unscale(torch.zeros(2, 3))
    with pytest.raises(RuntimeError, match="update_data"):
        m.update_data(np.zeros((2, 3)), np.zeros(2))
    loaded = SCFGP(device="cpu").load(_ckpt("boston_housing"))
    with pytest.raises(RuntimeError, match="set_data"):
        loaded.recalibrate_dispersion()


def test_set_data_without_params_draws_them():
    Xt, yt, _, _, _ = tds.load_boston(seed=2)
    m = SCFGP(sparsity=3, nfeats=5, seed=0, device="cpu")
    m.set_data(Xt, yt)
    assert m.params.l_F.shape == (13, 3) and m.post is None
    assert m.X.dtype == torch.float32 and m.X.shape == Xt.shape
    m2 = SCFGP(3, 5, False, True, device="cpu")  # legacy positionals
    assert m2.fftype is False and m2.verbose is True


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SCFGP()


def test_import_leaves_jax_out():
    code = ("import sys, scfgp_tpu_torch, scfgp_tpu_torch.models.model, "
            "scfgp_tpu_torch.data.datasets, scfgp_tpu_torch.utils.checkpoint,"
            " scfgp_tpu_torch.ops.gram, scfgp_tpu_torch.ops.streaming,"
            " scfgp_tpu_torch.ops.cholesky, scfgp_tpu_torch.utils.profiling,"
            " scfgp_tpu_torch.experiments.chol_crossover,"
            " scfgp_tpu_torch.experiments.kernel_ab,"
            " scfgp_tpu_torch.utils.experiment,"
            " scfgp_tpu_torch.experiments.boston_housing,"
            " scfgp_tpu_torch.experiments.abalone,"
            " scfgp_tpu_torch.experiments.kin8nm,"
            " scfgp_tpu_torch.experiments.co2;"
            "from scfgp_tpu_torch.ops import loss_fn_streaming;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'scfgp_tpu' or "
            "m.startswith('scfgp_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
