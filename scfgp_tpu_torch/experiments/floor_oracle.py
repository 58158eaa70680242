"""Floor certification on the port: the closed-form oracle, the exact GP
and SCFGP on the same boston splits.

Port of ``experiments/floor_oracle.py``.  Four predictors a split:

  floor    — ``datasets.surrogate_floor``: the closed-form conditional mean
             of the known generative process (no predictor beats it);
  exact_gp — the ARD-RBF GP, ML-II hyperparameters (``baselines/``):
             certifies that the floor is reachable;
  scfgp    — the boston experiment's config (S=20, M=20, SCORE, 500
             iterations, max_cvrg 18);
  scfgp_ensemble — ``fit_ensemble(k=16, mix_best=8)`` with a linear extra
             basis, 1500 iterations, max_cvrg 40: the floor-closing recipe
             (k restarts trained as one batched loop, the best 8 by
             validation SCORE mixed).

    python -m scfgp_tpu_torch.experiments.floor_oracle [--seeds K] [--cpu]
        [--out DIR]

Prints one JSON line a seed and the means, and writes ``<out>/floors.json``
(default ``scfgp_tpu_torch/experiments/results/floors/``) with the keys of
the JAX driver's ``experiments/results/floors/floors.json``.  On the card
unless ``--cpu``; the first line names the device.
"""

import argparse
import json
import os

import numpy as np
import torch

from ..baselines import ExactGP
from ..data.datasets import load_boston, surrogate_floor
from ..models.model import SCFGP
from .boston_housing import ADAM, RESULTS, linear_basis
from .precision_quality import device_record

# The JAX driver's budgets (experiments/floor_oracle.py:48-74).
GP_STEPS = 300
FIT = dict(obj="SCORE", algo=ADAM, max_iter=500, cvrg_tol=1e-5, max_cvrg=18)
ENSEMBLE = dict(k=16, mix_best=8, obj="SCORE", algo=ADAM, max_iter=1500,
                cvrg_tol=1e-5, max_cvrg=40)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print(json.dumps(device_record(torch.device(device))), flush=True)

    rows = []
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, meta = load_boston(seed=seed)
        floor = surrogate_floor("boston_housing", Xv, yv)

        gp = ExactGP(steps=GP_STEPS, device=device).fit(Xt, yt)
        mu_gp, _ = gp.predict(Xv)
        nmse_gp = float(np.mean((mu_gp - yv) ** 2) / np.var(yv))

        m = SCFGP(sparsity=20, nfeats=20, seed=seed, device=device)
        m.fit_fast(Xt, yt, Xv, yv, **FIT)
        nmse_sc = float(m.evals["NMSE"][1][m.min_obj_ind])

        me = SCFGP(sparsity=20, nfeats=20, seed=seed,
                   extra_basis=linear_basis, device=device)
        me.fit_ensemble(Xt, yt, Xv, yv, **ENSEMBLE)
        nmse_ens = float(me.evals["NMSE"][1][me.min_obj_ind])

        rows.append({
            "seed": seed, "source": meta["source"],
            "floor_nmse": round(floor["NMSE"], 4),
            "exact_gp_nmse": round(nmse_gp, 4),
            "exact_gp_over_floor": round(nmse_gp / floor["NMSE"], 3),
            "scfgp_nmse": round(nmse_sc, 4),
            "scfgp_over_floor": round(nmse_sc / floor["NMSE"], 3),
            "scfgp_ensemble_nmse": round(nmse_ens, 4),
            "scfgp_ensemble_over_floor": round(nmse_ens / floor["NMSE"], 3),
        })
        print(json.dumps(rows[-1]), flush=True)

    summary = {
        "dataset": "boston_housing",
        "rows": rows,
        "mean_exact_gp_over_floor": round(float(np.mean(
            [r["exact_gp_over_floor"] for r in rows])), 3),
        "mean_scfgp_over_floor": round(float(np.mean(
            [r["scfgp_over_floor"] for r in rows])), 3),
        "mean_scfgp_ensemble_over_floor": round(float(np.mean(
            [r["scfgp_ensemble_over_floor"] for r in rows])), 3),
    }
    out = args.out or os.path.join(RESULTS, "floors")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "floors.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in
                      ("mean_exact_gp_over_floor", "mean_scfgp_over_floor",
                       "mean_scfgp_ensemble_over_floor")}))
    return summary


if __name__ == "__main__":
    main()
