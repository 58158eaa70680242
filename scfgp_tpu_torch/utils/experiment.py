"""Model-selection sweep harness shared by the benchmark experiments.

Port of ``scfgp_tpu/utils/experiment.py:33-182``, which re-creates the
reference experiment shape (``reference:
experiments/boston_housing/boston_housing.py``): for each feature size, R
independent trials on fresh random splits, the best model kept by SCORE
and saved, and per-metric errorbar plots (mean ± std over trials,
``boston_housing.py:108-128``).

Plots need matplotlib, which is imported only when they are drawn; where
it is missing ``run_sweep`` writes none and says so in ``results.json``
(``"plots": false``).  ``results.json`` and ``best_model.pkl`` are always
written.  Beside the JAX package's keys the summary carries each size's
wall time (``seconds``) and, on a synthetic surrogate, each trial's NMSE
and floor NMSE (``per_trial``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.datasets import ORACLES, surrogate_floor
from ..models.model import SCFGP, fit_fast_batch

PLOT_METRICS = ("MAE", "NMAE", "MSE", "NMSE", "RMSE", "MNLP", "SCORE",
                "TIME(s)")


def run_sweep(name: str, loader: Callable, nfeats_choices: Sequence[int],
              sparsity: int, trials: int, opt_params: dict,
              out_dir: str, seed0: int = 0, verbose: bool = False,
              fused: bool = True, batched: bool = False,
              restarts: int = 1, extra_basis=None,
              ensemble: int = 0, mix_best=None, device="cuda",
              dtype=torch.float32) -> dict:
    """Sweep feature sizes x trials; returns the summary and writes
    ``best_model.pkl`` (the SCORE tournament's winner, reference
    ``boston_housing.py:90-102``), ``results.json`` (each metric's mean and
    std by size) and, where matplotlib imports, ``plots/<metric>.png``.

    Trials train with ``fit_fast`` (``fused=True``) or the host loop
    ``fit``; ``batched=True`` trains every (trial x restart) model of a
    size in one ``fit_fast_batch``; ``restarts > 1`` keeps a split's best
    restart by validation SCORE; ``ensemble=k`` fits each split with
    ``fit_ensemble(k, mix_best)`` instead.  When the data is a synthetic
    surrogate, each split's Bayes floor (``surrogate_floor``) is reported
    beside the metrics, with each size's achieved/floor NMSE ratio.  Models
    live on ``device`` in ``dtype``."""
    os.makedirs(out_dir, exist_ok=True)
    results = {m: {"mean": [], "std": []} for m in PLOT_METRICS}
    floor_results = {m: {"mean": [], "std": []} for m in
                     ("MAE", "MSE", "RMSE", "NMSE")}
    ratio_nmse, seconds = [], []
    per_trial_nmse, per_trial_floor = [], []
    best_score = np.inf
    summary_meta = None
    model_kw = dict(sparsity=sparsity, verbose=verbose,
                    extra_basis=extra_basis, device=device, dtype=dtype)

    for nfeats in nfeats_choices:
        per_trial = {m: [] for m in PLOT_METRICS}
        per_floor = {m: [] for m in floor_results}
        t_size = time.time()
        splits = []
        for rep in range(trials):
            Xt, yt, Xv, yv, meta = loader(seed=seed0 + rep)
            splits.append((Xt, yt, Xv, yv))
            summary_meta = meta
            if meta.get("source") == "synthetic-surrogate" \
                    and meta.get("name") in ORACLES:
                fl = surrogate_floor(meta["name"], Xv, yv)
                for m in per_floor:
                    per_floor[m].append(fl[m])
        if ensemble:
            groups = []
            for rep in range(trials):
                m = SCFGP(nfeats=int(nfeats), seed=seed0 + rep, **model_kw)
                m.fit_ensemble(*splits[rep], k=ensemble, mix_best=mix_best,
                               **opt_params)
                groups.append([m])
        else:
            groups = [[SCFGP(nfeats=int(nfeats),
                             seed=(seed0 + rep if k == 0
                                   else seed0 + 1000003 * k + rep),
                             **model_kw)
                       for k in range(restarts)] for rep in range(trials)]
            if batched:
                fit_fast_batch([m for g in groups for m in g],
                               [splits[rep] for rep in range(trials)
                                for _ in range(restarts)], **opt_params)
            else:
                for rep, g in enumerate(groups):
                    for model in g:
                        fit = model.fit_fast if fused else model.fit
                        fit(*splits[rep], **opt_params)

        def val_score(m_):
            s = m_.evals["SCORE"][1]
            return s[min(m_.min_obj_ind, len(s) - 1)]

        for rep, g in enumerate(groups):
            model = min(g, key=val_score)
            ix = model.min_obj_ind
            for m in PLOT_METRICS:
                series = model.evals[m][1]
                per_trial[m].append(series[min(ix, len(series) - 1)])
            score = val_score(model)
            if score < best_score:
                best_score = score
                model.save(os.path.join(out_dir, "best_model.pkl"))
        seconds.append(time.time() - t_size)
        print(f"[{name}] m={nfeats}: {trials} trials x {restarts} restart(s)"
              f" mean SCORE={np.mean(per_trial['SCORE']):.4f}"
              f" ({seconds[-1]:.1f}s)", flush=True)
        for m in PLOT_METRICS:
            results[m]["mean"].append(float(np.mean(per_trial[m])))
            results[m]["std"].append(float(np.std(per_trial[m])))
        for m in floor_results:
            if per_floor[m]:
                floor_results[m]["mean"].append(float(np.mean(per_floor[m])))
                floor_results[m]["std"].append(float(np.std(per_floor[m])))
        if per_floor["NMSE"]:
            ratio_nmse.append(results["NMSE"]["mean"][-1]
                              / floor_results["NMSE"]["mean"][-1])
            per_trial_nmse.append([float(v) for v in per_trial["NMSE"]])
            per_trial_floor.append([float(v) for v in per_floor["NMSE"]])

    summary = {
        "name": name,
        "data_source": summary_meta.get("source") if summary_meta else None,
        "nfeats_choices": list(map(int, nfeats_choices)),
        "sparsity": sparsity,
        "trials": trials,
        "restarts": restarts,
        "batched": batched,
        "extra_basis": bool(extra_basis),
        "best_score": float(best_score),
        "metrics": results,
        "seconds": seconds,
        "device": str(torch.device(device)),
    }
    if ratio_nmse:
        summary["floor"] = floor_results
        summary["nmse_over_floor"] = [round(r, 4) for r in ratio_nmse]
        summary["per_trial"] = {"NMSE": per_trial_nmse,
                                "floor_NMSE": per_trial_floor}
    summary["plots"] = _plot_sweep(name, nfeats_choices, results,
                                   os.path.join(out_dir, "plots"))
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _plot_sweep(name, nfeats_choices, results, plot_dir) -> bool:
    """Errorbar plot per metric vs feature size (boston_housing.py:108-128);
    returns False, drawing nothing, where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    for m, series in results.items():
        fig = plt.figure(figsize=(8, 5), facecolor="white")
        ax = fig.add_subplot(111)
        ax.errorbar(list(nfeats_choices), series["mean"], yerr=series["std"],
                    fmt="-o", capsize=4)
        ax.set_xlabel("Number of Fourier features")
        ax.set_ylabel(m)
        title = f"{name}: {m} vs feature size"
        if m == "TIME(s)":
            # Batched trials share one loop: a model's wall time is the
            # batch's split evenly (fit_fast_batch), an estimate.
            title += " (estimated: batched trials share one loop)"
        ax.set_title(title)
        fname = m.lower().replace("(", "").replace(")", "")
        fig.savefig(os.path.join(plot_dir, f"{fname}.png"), dpi=110,
                    bbox_inches="tight")
        plt.close(fig)
    return True
