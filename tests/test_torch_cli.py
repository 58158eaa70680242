"""The port's command line (``python -m scfgp_tpu_torch``, ``run.py``) and
its config dataclasses against the JAX package's.

The CLI only drives: with the same flags and seed its metrics are bitwise
those of the direct ``SCFGP`` call with ``TrainConfig.as_optimize_kwargs()``
(same process, same device, same arithmetic).  The run tests mirror
``tests/test_utils.py:155-203`` on the CPU (``--cpu``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scfgp_tpu import config as jcfg
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch import config as tcfg
from scfgp_tpu_torch.data.datasets import load_boston, load_co2
from scfgp_tpu_torch.run import main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["OptimizerConfig", "ModelConfig",
                                  "TrainConfig", "MeshConfig"])
def test_config_defaults_equal_jax(name):
    ours, theirs = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(theirs)])
    assert tcfg.to_dict(ours) == jcfg.to_dict(theirs)


def test_optimize_kwargs_equal_jax():
    kw = dict(obj="SCORE", max_iter=77, cvrg_tol=1e-5,
              optimizer=dict(algo="adamax", learning_rate=0.05, beta1=0.8))
    ours = tcfg.TrainConfig(**{**kw, "optimizer": tcfg.OptimizerConfig(
        **kw["optimizer"])})
    theirs = jcfg.TrainConfig(**{**kw, "optimizer": jcfg.OptimizerConfig(
        **kw["optimizer"])})
    assert ours.as_optimize_kwargs() == theirs.as_optimize_kwargs()
    assert tcfg.TrainConfig().as_optimize_kwargs() == \
        jcfg.TrainConfig().as_optimize_kwargs()


def test_make_model_takes_the_device():
    m = tcfg.make_model(tcfg.ModelConfig(sparsity=3, nfeats=5, seed=2),
                        device="cpu")
    assert (m.S, m.M, m.device.type) == (3, 5, "cpu")
    assert m.get_compiled_funcs() is None


def test_graft_entry_objective_equals_jax_loss():
    """``graft_entry.entry()``'s forward objective against the JAX
    ``loss_fn`` on the same params and data, float32 (Cholesky of a
    500 x 500 Gram in another order: rtol 1e-4)."""
    from scfgp_tpu.models.objective import loss_fn as jax_loss_fn
    from scfgp_tpu.models.params import SCFGPParams as JaxParams
    from scfgp_tpu_torch.graft_entry import entry
    fn, (params, X, y) = entry(device="cpu")
    cost, alpha = fn(params, X, y)
    assert X.shape == (1024, 8) and alpha.shape == (500,)
    jp = JaxParams(*(np.asarray(t) for t in params))
    jcost, jaux = jax_loss_fn(jp, X.numpy(), y.numpy())
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4)


def test_run_cli_fused_and_config(tmp_path):
    """``tests/test_utils.py:155``: flags and a config file; writes the
    checkpoint and prints the JAX CLI's keys."""
    out = tmp_path / "run"
    res = main(["--dataset", "co2", "--sparsity", "6", "--nfeats", "8",
                "--max-iter", "30", "--fused", "--seed", "0", "--cpu",
                "--out", str(out)])
    assert set(res) == {"dataset", "source", "model", "metrics",
                        "checkpoint"}
    assert np.isfinite(res["metrics"]["NMSE"])
    assert (out / "model.pkl").exists()
    back = SCFGP(device="cpu").load(res["checkpoint"])
    assert (back.S, back.M) == (6, 8)

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": "boston",
        "model": {"sparsity": 6, "nfeats": 8, "seed": 1},
        "train": {"max_iter": 25,
                  "optimizer": {"algo": "adamax", "learning_rate": 0.05}},
    }))
    res2 = main(["--config", str(cfg), "--cpu"])
    assert np.isfinite(res2["metrics"]["RMSE"])


def test_cli_fused_metrics_are_the_direct_fit_fast(tmp_path):
    res = main(["--dataset", "co2", "--sparsity", "6", "--nfeats", "8",
                "--max-iter", "30", "--fused", "--seed", "0", "--cpu"])
    Xt, yt, Xv, yv, _ = load_co2(seed=0)
    kw = tcfg.TrainConfig(max_iter=30).as_optimize_kwargs()
    for key in ("nbatches", "batchsize"):
        kw.pop(key)
    m = SCFGP(sparsity=6, nfeats=8, seed=0, device="cpu")
    m.fit_fast(Xt, yt, Xv, yv, **kw)
    direct = {k: float(m.evals[k][1][m.min_obj_ind])
              for k in ("MAE", "NMSE", "RMSE", "MNLP", "SCORE")}
    assert res["metrics"] == direct


def test_cli_host_loop_metrics_are_the_direct_fit(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": "boston", "out": str(tmp_path / "o"),
        "model": {"sparsity": 5, "nfeats": 7, "seed": 3},
        "train": {"max_iter": 20, "obj": "SCORE",
                  "optimizer": {"algo": "adamax", "learning_rate": 0.05}},
    }))
    res = main(["--config", str(cfg), "--cpu"])
    Xt, yt, Xv, yv, _ = load_boston(seed=3)
    t = tcfg.TrainConfig(max_iter=20, obj="SCORE", optimizer=tcfg.
                         OptimizerConfig(algo="adamax", learning_rate=0.05))
    m = SCFGP(sparsity=5, nfeats=7, seed=3, device="cpu")
    m.fit(Xt, yt, Xv, yv, **t.as_optimize_kwargs())
    direct = {k: float(m.evals[k][1][m.min_obj_ind])
              for k in ("MAE", "NMSE", "RMSE", "MNLP", "SCORE")}
    assert res["metrics"] == direct
    lines = (tmp_path / "o" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len(m.evals["COST"][1]) - 1


def test_run_cli_ensemble(tmp_path):
    res = main(["--dataset", "co2", "--sparsity", "3", "--nfeats", "5",
                "--max-iter", "15", "--ensemble", "3", "--mix-best", "2",
                "--seed", "0", "--cpu"])
    assert np.isfinite(res["metrics"]["NMSE"])


def test_run_cli_bayes_bool_config_and_key_validation(tmp_path):
    """``tests/test_utils.py:184``: ``"bayes": true`` works; an unknown
    bayes key fails with a SystemExit that names it."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": "co2",
        "model": {"sparsity": 2, "nfeats": 4, "seed": 0},
        "bayes": True,
    }))
    res = main(["--config", str(cfg), "--chains", "2", "--samples", "10",
                "--warmup", "20", "--cpu"])
    assert res["bayes"]["draws"] > 0 and res["bayes"]["sampler"] == "hmc"
    assert {"max_rhat", "min_ess_bulk", "divergences"} <= set(res["bayes"])

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({
        "dataset": "co2",
        "model": {"sparsity": 2, "nfeats": 4},
        "bayes": {"sampler": "hmc", "not_a_knob": 1},
    }))
    with pytest.raises(SystemExit, match="not_a_knob"):
        main(["--config", str(bad), "--cpu"])


@pytest.mark.parametrize("argv,match", [
    (["--sparsity", "3"], "no dataset"),
    (["--dataset", "mnist", "--cpu"], "unknown dataset"),
])
def test_run_cli_refuses_bad_input(argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv)


def test_run_cli_without_cpu_and_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataset", "co2", "--sparsity", "2", "--nfeats", "4",
              "--max-iter", "2"])


def test_module_entry_runs_a_config(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": "co2", "model": {"sparsity": 2, "nfeats": 4, "seed": 0},
        "train": {"max_iter": 5, "fused": True}}))
    res = subprocess.run([sys.executable, "-m", "scfgp_tpu_torch",
                          "--config", str(cfg), "--cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["dataset"] == "co2" and np.isfinite(line["metrics"]["NMSE"])
