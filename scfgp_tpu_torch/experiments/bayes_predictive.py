"""Posterior-predictive campaign of the Bayes layer on the benchmarks, on
the port.

Port of ``experiments/bayes_predictive.py``.  On each dataset and split
seed it measures held-out NMSE and MNLP for every inference arm at the same
model capacity (same S, m), so the comparison isolates the inference:

  map       ``fit_fast`` (co2: then ``recalibrate_dispersion``)
  ensemble  ``fit_ensemble(k, mix_best)``
  hmc       ``fit_bayes(sampler="hmc", chain_init="map")``
  tempered  ``fit_bayes(sampler="tempered")``
  sgld      ``fit_bayes(sampler="sgld", chain_init="map")``
  fleet     ``fit_bayes(sampler="hmc", chains=32,
            shared_adaptation=False)``, random inits
  ens_init  ``fit_bayes(chain_init="ensemble")`` (boston and kin8nm)

Every Bayes arm reports ``predict_bayes`` raw and with
``recalibrate=True`` (``*_recal``), its diagnostics, and Monte-Carlo error
bars from a bootstrap over chains (``chain_bootstrap``).  Across seeds,
mean and std.  The budgets are the JAX campaign's; ``--quick`` caps every
arm at 60 + 60 transitions and 60 optimizer steps, ``--tiny`` at 16 + 16
with 4 chains and 30 steps (a path check).  The JAX package's segmented
tempered runs are one-shot here (the same in law), and it resumed a
campaign cut by a TPU worker's fault, which the port does not.

    python -m scfgp_tpu_torch.experiments.bayes_predictive [--quick |
        --tiny] [--datasets boston,abalone,kin8nm,co2] [--seeds 3]
        [--cpu] [--out DIR]

Runs on the card unless ``--cpu``.  Prints one line an arm and writes
``<out>/results.json`` (``results_tiny.json`` with ``--tiny``; default
``scfgp_tpu_torch/experiments/results/bayes_predictive/``).
"""

import argparse
import json
import math
import os
import time
import warnings

import numpy as np
import torch

from ..data.datasets import load_abalone, load_boston, load_co2, load_kin8nm
from ..ops.dispatch import DEFAULT_MM_PRECISION
from ..utils.metrics import regression_metrics
from .boston_housing import RESULTS
from .co2 import ADAMAX, seasonal_trend_basis

DATASETS = {
    "boston": dict(S=20, M=50, ens=dict(k=16, mix_best=8),
                   opt=dict(max_iter=500, cvrg_tol=1e-5, max_cvrg=18)),
    "abalone": dict(S=20, M=64, ens=dict(k=8, mix_best=4),
                    skip_arms=("ens_init",),
                    opt=dict(max_iter=500, cvrg_tol=1e-5, max_cvrg=18)),
    "kin8nm": dict(S=20, M=50, ens=dict(k=8, mix_best=4),
                   opt=dict(max_iter=500, cvrg_tol=1e-5, max_cvrg=18)),
    "co2": dict(S=10, M=20, ens=dict(k=8, mix_best=4), co2=True,
                skip_arms=("ens_init",),
                opt=dict(max_iter=1000, cvrg_tol=1e-5, max_cvrg=60,
                         obj="cost", algo=ADAMAX)),
}

BAYES = {
    "hmc": dict(sampler="hmc", chains=8, num_warmup=300, num_samples=300,
                num_integration_steps=16, init_step_size=0.003,
                chain_init="map", map_iters=300),
    "tempered": dict(sampler="tempered", chains=8, num_warmup=100,
                     num_samples=200, num_integration_steps=16,
                     init_step_size=0.003, max_rungs=12),
    "sgld": dict(sampler="sgld", chains=8, num_warmup=2000,
                 num_samples=500, thin=4, init_step_size=1e-5,
                 chain_init="map", map_iters=300),
    "fleet": dict(sampler="hmc", chains=32, num_warmup=300,
                  num_samples=300, num_integration_steps=16,
                  init_step_size=0.003, shared_adaptation=False),
    "ens_init": dict(sampler="hmc", chains=16, num_warmup=300,
                     num_samples=300, num_integration_steps=16,
                     init_step_size=0.003, chain_init="ensemble",
                     map_iters=300, shared_adaptation=False),
}
LOADERS = {"boston": load_boston, "abalone": load_abalone,
           "kin8nm": load_kin8nm, "co2": load_co2}


def _metrics(mu, std, ys):
    m = regression_metrics(mu, std, ys)
    return {"NMSE": m["NMSE"], "MNLP": m["MNLP"], "RMSE": m["RMSE"]}


def chain_bootstrap(model, Xv, yv, n_boot=200, seed=0):
    """Monte-Carlo error bars of the predictive metrics by a bootstrap over
    chains (``experiments/bayes_predictive.py:117-158``).  With equal
    draws a chain, each chain's predictive moments are an exact
    sub-mixture, A_c = E_c[mu] and B_c = E_c[var] + E_c[mu²] - A_c², so a
    resampled set R of chains mixes in closed form: mu_R = mean A_c,
    var_R = mean (B_c + A_c²) - mu_R²."""
    from ..bayes.predictive import predictive_mixture
    samples = model.bayes_result.samples          # (draws, C, P)
    C = samples.shape[1]
    Xs = model._scale_X(Xv)
    A, B = [], []
    for c in range(C):
        mu_c, std_c = predictive_mixture(
            samples[:, c, :].to(model.dtype), model.X, model.y, Xs,
            model.D, model.S, model.M, basis_fn=model.extra_basis,
            streaming_block=model._bayes_streaming_block)
        A.append(mu_c.double().cpu().numpy())
        B.append((std_c.double() ** 2).cpu().numpy())
    A, B = np.stack(A), np.stack(B)                 # (C, nv)
    ys = np.asarray(yv).reshape(-1, 1)
    rng = np.random.RandomState(seed)
    boots = []
    for _ in range(int(n_boot)):
        idx = rng.randint(0, C, C)
        mu = A[idx].mean(axis=0)
        var = (B[idx] + A[idx] ** 2).mean(axis=0) - mu * mu
        mu_y, std_y = model._unscale_moments(
            torch.as_tensor(mu, dtype=model.dtype, device=model.device),
            torch.as_tensor(np.sqrt(np.maximum(var, 1e-12)),
                            dtype=model.dtype, device=model.device))
        boots.append(_metrics(mu_y, std_y, ys))
    return {k: {"mc_std": float(np.std([b[k] for b in boots])),
                "mc_mean": float(np.mean([b[k] for b in boots]))}
            for k in boots[0]}


def arm_budget(arm, quick):
    """The arm's ``fit_bayes`` arguments, cut by ``quick`` (True or
    "tiny") as the JAX campaign cuts them."""
    bkw = dict(BAYES[arm])
    if quick:
        bkw.update(num_warmup=min(bkw["num_warmup"], 60),
                   num_samples=min(bkw["num_samples"], 60))
        if "map_iters" in bkw:
            bkw["map_iters"] = 60
    if quick == "tiny":
        bkw.update(num_warmup=16, num_samples=16, chains=4)
        if bkw["sampler"] == "tempered":
            bkw.update(max_rungs=4)
        if bkw["sampler"] == "sgld":
            bkw.update(thin=1)
        if "map_iters" in bkw:
            bkw["map_iters"] = 30
    return bkw


def run_dataset(name, seeds, quick=False, device="cuda", verbose=True):
    """One row a seed: ``{"seed", "source", "arms": {arm: fields}}``."""
    from ..models.model import SCFGP
    cfg = DATASETS[name]
    rows = []
    for seed in seeds:
        Xt, yt, Xv, yv, meta = LOADERS[name](seed=seed)
        ys = np.asarray(yv).reshape(-1, 1)
        model_kw = dict(sparsity=cfg["S"], nfeats=cfg["M"], seed=seed,
                        device=device)
        opt, ens = dict(cfg["opt"]), dict(cfg["ens"])
        if cfg.get("co2"):
            omega = 2 * math.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0
            model_kw.update(X_scaling_method="min-max",
                            y_scaling_method="normal",
                            extra_basis=seasonal_trend_basis(omega))
        if quick:
            opt["max_iter"] = min(opt["max_iter"], 60)
            ens = dict(k=4, mix_best=2)
        if quick == "tiny":
            opt["max_iter"] = 30
            ens = dict(k=2, mix_best=2)
        out = {}

        def record(arm, mets, wall, extra=None):
            out[arm] = dict(mets, wall_s=round(wall, 2), **(extra or {}))
            if verbose:
                print(json.dumps({"dataset": name, "seed": seed, "arm": arm,
                                  **out[arm]}), flush=True)

        m = SCFGP(**model_kw)
        t0 = time.time()
        m.fit_fast(Xt, yt, **opt)
        if cfg.get("co2"):
            m.recalibrate_dispersion()  # the co2 recipe
        record("map", _metrics(*m.predict(Xv), ys), time.time() - t0)
        m = SCFGP(**model_kw)
        t0 = time.time()
        m.fit_ensemble(Xt, yt, k=ens["k"], mix_best=ens["mix_best"], **opt)
        if cfg.get("co2"):
            m.recalibrate_dispersion()
        record("ensemble", _metrics(*m.predict(Xv), ys), time.time() - t0,
               ens)
        for arm in BAYES:
            if arm in cfg.get("skip_arms", ()):
                continue
            m = SCFGP(**model_kw)
            t0 = time.time()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m.fit_bayes(Xt, yt, **arm_budget(arm, quick))
            wall = time.time() - t0
            mets = _metrics(*m.predict_bayes(Xv), ys)
            recal = _metrics(*m.predict_bayes(Xv, recalibrate=True), ys)
            d = m.bayes_diagnostics
            boot = chain_bootstrap(m, Xv, yv, n_boot=10 if quick else 200,
                                   seed=seed)
            record(arm, mets, wall, {
                "NMSE_recal": recal["NMSE"], "MNLP_recal": recal["MNLP"],
                "mc_std_NMSE": boot["NMSE"]["mc_std"],
                "mc_std_MNLP": boot["MNLP"]["mc_std"],
                "max_rhat": float(d.max_rhat),
                "rhat_logdensity": float(d.rhat_logdensity),
                "min_ess_bulk": float(d.min_ess_bulk),
                "divergences": int(d.divergences or 0),
                "accept": float(getattr(m.bayes_result, "accept_rate",
                                        float("nan"))),
                "sampler_wall_s": m.bayes_diagnostics_wall})
        rows.append({"seed": seed, "source": meta["source"], "arms": out})
    return rows


def summarize(rows):
    """Across seeds, mean and std of each arm's metrics."""
    out = {}
    for a in rows[0]["arms"]:
        out[a] = {}
        for k in ("NMSE", "MNLP", "RMSE", "wall_s", "NMSE_recal",
                  "MNLP_recal"):
            if k in rows[0]["arms"][a]:
                vals = [r["arms"][a][k] for r in rows]
                out[a][k] = {"mean": float(np.mean(vals)),
                             "std": float(np.std(vals))}
        for k in ("mc_std_NMSE", "mc_std_MNLP", "max_rhat", "min_ess_bulk"):
            if k in rows[0]["arms"][a]:
                out[a][k] = float(np.mean([r["arms"][a][k] for r in rows]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="minimal budgets, a path check")
    ap.add_argument("--datasets", default="boston,abalone,kin8nm,co2")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    names = [s.strip() for s in args.datasets.split(",") if s.strip()]
    quick = "tiny" if args.tiny else args.quick
    device = "cpu" if args.cpu else "cuda"
    outdir = args.out or os.path.join(RESULTS, "bayes_predictive")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, "results_tiny.json" if args.tiny
                           else "results.json")
    results = {}
    for name in names:
        rows = run_dataset(name, list(range(args.seeds)), quick, device)
        results[name] = {"rows": rows, "summary": summarize(rows)}
        for a, s in results[name]["summary"].items():
            print(json.dumps({"dataset": name, "arm": a, "summary": s}),
                  flush=True)
        payload = {"device": device, "quick": quick,
                   "arithmetic": {
                       "fits": "mm_precision=%r (ops/dispatch.py)"
                               % DEFAULT_MM_PRECISION,
                       "samplers": "IEEE float32: auto settings stay off "
                                   "the samplers"},
                   "bayes_budgets": {a: arm_budget(a, quick) for a in BAYES},
                   "dataset_configs": {
                       k: {kk: vv for kk, vv in v.items() if kk != "co2"}
                       for k, v in DATASETS.items()},
                   "results": results}
        with open(outpath, "w") as f:
            json.dump(payload, f, indent=2, default=str)
    print("wrote", outpath, flush=True)
    return results


if __name__ == "__main__":
    main()
