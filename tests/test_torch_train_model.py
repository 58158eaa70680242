"""The port's training surface against the JAX package's: the host loop
``fit``/``optimize`` from the same params and seed at float64, annealing
included; checkpoints resumed across packages in both directions; the
median-minibatch path; and ``fit`` reaching the end-to-end quality band.

The host loop's stall annealing draws from the NumPy ``self._rng`` in both
packages, so from the same params and seed the port replays JAX's
trajectory: cost histories at rtol 1e-7 (float64 rounding in another
summation order, amplified over tens of adam steps), the same stop
iteration, and the same best index.
"""

import json
import os

import numpy as np
import pytest
import torch

from scfgp_tpu import SCFGP as JaxSCFGP
from scfgp_tpu.data.datasets import synthetic_gp_rff
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.models.params import params_from_numpy

torch.set_num_threads(1)

S, M = 4, 8
RTOL = 1e-7
ALGO = {"algo": "adam", "algo_params": {"learning_rate": 0.02, "beta1": 0.9,
                                        "beta2": 0.999, "epsilon": 1e-8}}


def _data(seed=0):
    X, y = synthetic_gp_rff(n=240, d=3, s=4, m=8, noise_std=0.1, seed=seed)
    return X[:200], y[:200], X[200:], y[200:]


def _pair(Xt, yt, seed=7):
    """A JAX and a port model with the same seed, data and params (the
    port's init draws other bits, so it takes the JAX params)."""
    mj = JaxSCFGP(sparsity=S, nfeats=M, seed=seed)
    mj.set_data(Xt, yt)
    mt = SCFGP(sparsity=S, nfeats=M, seed=seed, device="cpu",
               dtype=torch.float64)
    mt.set_data(Xt, yt)
    mt.params = params_from_numpy([np.asarray(a) for a in mj.params],
                                  dtype=torch.float64)
    return mj, mt


def _without_entry(history, i):
    """A resumed history holds the interrupted run's final evaluation at
    index ``i`` (the number of iterations it ran); drop it."""
    return history[:i] + history[i + 1:]


def _close_histories(mj, mt, keys=("COST", "NMSE", "MNLP")):
    for k in keys:
        a, b = np.asarray(mj.evals[k][1]), np.asarray(mt.evals[k][1])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("obj", ["cost", "score"])
def test_host_fit_replays_jax_host_loop(obj):
    """Annealing fires (max_cvrg=4) and the loop stops early."""
    Xt, yt, Xv, yv = _data()
    mj, mt = _pair(Xt, yt)
    kw = dict(max_iter=70, max_cvrg=4, obj=obj, algo=ALGO)
    mj.optimize(Xv, yv, **kw)
    mt.optimize(Xv, yv, **kw)
    n = len(mt.evals["COST"][1])
    assert n < 71  # stopped early (70 iterations + the final entry)
    assert mt.min_obj_ind == mj.min_obj_ind
    _close_histories(mj, mt)
    for a, b in zip(mj.params, mt.params):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(a)).max())


def test_minibatch_median_path_replays_jax():
    """nbatches=2 with the same NumPy shuffles; an even batch count takes
    the midpoint of the two middle params, as jnp.median does."""
    Xt, yt, Xv, yv = _data(seed=1)
    mj, mt = _pair(Xt, yt, seed=5)
    kw = dict(max_iter=8, nbatches=2, batchsize=90, algo=ALGO)
    mj.optimize(Xv, yv, **kw)
    mt.optimize(Xv, yv, **kw)
    _close_histories(mj, mt)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX mid-training checkpoint (optimizer accumulators, host RNG,
    live and best params) resumed by the port's optimize(resume=True)
    replays JAX's uninterrupted run."""
    Xt, yt, Xv, yv = _data()
    kw = dict(obj="score", algo=ALGO, max_cvrg=6)
    mA = JaxSCFGP(sparsity=S, nfeats=M, seed=3)
    mA.fit(Xt, yt, Xv, yv, max_iter=40, **kw)
    mB = JaxSCFGP(sparsity=S, nfeats=M, seed=3)
    mB.fit(Xt, yt, Xv, yv, max_iter=20, **kw)
    path = os.path.join(tmp_path, "jax.ckpt")
    mB.save(path)

    mC = SCFGP(seed=99, device="cpu", dtype=torch.float64).load(path)
    assert mC._train_state["opt_state"].inner.t.dtype == np.float32
    mC.set_data(Xt, yt)
    # The loop's settings other than obj and algo are not resume state.
    mC.optimize(Xv, yv, resume=True, max_iter=40, max_cvrg=6)
    np.testing.assert_allclose(_without_entry(mC.evals["COST"][1], 20),
                               mA.evals["COST"][1], rtol=RTOL)
    for a, c in zip(mA.params, mC.params):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(a)).max())


def test_port_checkpoint_resumes_in_jax_and_in_port(tmp_path):
    """The port's mid-training checkpoint (written by checkpoint_path inside
    the loop) resumes bitwise in the port and, read by the JAX package,
    continues the same trajectory there."""
    Xt, yt, Xv, yv = _data(seed=2)
    kw = dict(obj="score", algo=ALGO, max_cvrg=6)
    mA = SCFGP(sparsity=S, nfeats=M, seed=4, device="cpu",
               dtype=torch.float64)
    mA.fit(Xt, yt, Xv, yv, max_iter=36, **kw)
    path = os.path.join(tmp_path, "port.ckpt")
    log = os.path.join(tmp_path, "train.jsonl")
    mB = SCFGP(sparsity=S, nfeats=M, seed=4, device="cpu",
               dtype=torch.float64)
    mB.fit(Xt, yt, Xv, yv, max_iter=18, checkpoint_path=path,
           checkpoint_every=5, log_file=log, **kw)
    recs = [json.loads(line) for line in open(log)]
    assert [r["iter"] for r in recs] == list(range(18))
    assert recs[-1]["COST"] == pytest.approx(mB.evals["COST"][1][17])

    mC = SCFGP(seed=99, device="cpu", dtype=torch.float64).load(path)
    mC.set_data(Xt, yt)
    mC.optimize(Xv, yv, resume=True, max_iter=36, max_cvrg=6)
    for a, c in zip(mA.params, mC.params):
        assert torch.equal(a, c)
    assert _without_entry(mC.evals["COST"][1], 18) == mA.evals["COST"][1]

    mJ = JaxSCFGP(seed=99).load(path)
    mJ.set_data(Xt, yt)
    mJ.optimize(Xv, yv, resume=True, max_iter=36, max_cvrg=6)
    np.testing.assert_allclose(_without_entry(mJ.evals["COST"][1], 18),
                               mA.evals["COST"][1], rtol=RTOL)


def test_fit_reaches_gp_rff_noise_floor():
    """The band of tests/test_end_to_end.py::test_recovers_gp_rff_data_to_noise_floor
    (same data, model and protocol), in float32."""
    X, y = synthetic_gp_rff(n=600, d=4, s=5, m=15, noise_std=0.1, seed=0)
    Xt, yt, Xv, yv = X[:480], y[:480], X[480:], y[480:]
    m = SCFGP(sparsity=8, nfeats=20, seed=0, device="cpu")
    m.fit(Xt, yt, Xv, yv, max_iter=200, cvrg_tol=1e-5)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    noise_floor = 0.01 / np.var(yv)
    assert nmse < max(5 * noise_floor, 0.08), (nmse, noise_floor)
    mu, std = m.predict(Xv)
    assert mu.shape == (120, 1) and np.isfinite(std).all()


def test_fit_fast_with_validation_objective_and_recalibrate():
    Xt, yt, Xv, yv = _data(seed=3)
    m = SCFGP(sparsity=S, nfeats=M, seed=0, device="cpu")
    m.fit_fast(Xt, yt, Xv, yv, max_iter=60, obj="NMSE", recalibrate=True)
    assert np.isfinite(m.evals["NMSE"][1][m.min_obj_ind])
    assert len(m.evals["COST"][1]) == len(m.evals["TIME(s)"][1])
    assert m._fused_train_state["done"]


def test_training_after_update_data_and_recalibration():
    """update_data and recalibrate_dispersion run under inference_mode;
    their tensors still train (optimize(resume=True) on the grown data,
    as the JAX package's update_data docstring suggests)."""
    Xt, yt, Xv, yv = _data(seed=4)
    m = SCFGP(sparsity=S, nfeats=M, seed=1, device="cpu")
    m.fit(Xt, yt, max_iter=10)
    m.update_data(Xv[:20], yv[:20]).recalibrate_dispersion()
    m.optimize(Xv[20:], yv[20:], resume=True, max_iter=15)
    assert m.N == 220 and np.isfinite(m.evals["COST"][1][-1])


def test_parts_not_ported_raise():
    Xt, yt, _, _ = _data()
    m = SCFGP(sparsity=S, nfeats=M, seed=0, device="cpu")
    m.set_data(Xt, yt)
    with pytest.raises(RuntimeError, match="resume"):
        SCFGP(device="cpu").optimize(resume=True)
