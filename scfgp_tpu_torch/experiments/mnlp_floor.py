"""MNLP floor certification on the port: calibration anchored the way NMSE
is.

Port of ``experiments/mnlp_floor.py``.  ``datasets.surrogate_floor``
returns two MNLP anchors:

  MNLP       — the Bayes-optimal Gaussian predictive (the true conditional
               mean and std): nothing scored by the Gaussian MNLP metric
               (``utils/metrics.py``) beats it;
  MNLP_HOMO  — the best single-sigma Gaussian at the oracle mean: the floor
               within the homoscedastic family the dispersion c lives in.

Per dataset and seed it reports the model's MNLP, its excess over the
floor (nats), and the self-calibration excess

    MNLP_model - 0.5 (1 + log(2 pi MSE_model)),

how far the model's intervals are from the best intervals given its own
point accuracy.  co2 takes the composite trend + seasonal basis of
``experiments/co2.py`` with the closed-form dispersion recalibration.

    python -m scfgp_tpu_torch.experiments.mnlp_floor [--seeds K]
        [--datasets boston_housing abalone kin8nm co2] [--cpu] [--out DIR]

Prints one JSON line a dataset and seed and the means, and writes
``<out>/mnlp_floors.json`` (default
``scfgp_tpu_torch/experiments/results/floors/``) with the keys of the JAX
driver's ``experiments/results/floors/mnlp_floors.json``.  On the card
unless ``--cpu``; the first line names the device.
"""

import argparse
import json
import math
import os

import numpy as np
import torch

from ..data import datasets as D
from ..data.datasets import surrogate_floor
from ..models.model import SCFGP
from .boston_housing import RESULTS
from .co2 import ADAMAX, seasonal_trend_basis
from .precision_quality import device_record

CONFIGS = {
    # dataset -> (loader name, sparsity, nfeats, max_iter)
    "boston_housing": ("load_boston", 20, 20, 300),
    "abalone": ("load_abalone", 20, 64, 300),
    "kin8nm": ("load_kin8nm", 20, 100, 300),
    "co2": ("load_co2", 100, 50, 500),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--datasets", nargs="*", default=list(CONFIGS))
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print(json.dumps(device_record(torch.device(device))), flush=True)

    out = {}
    for name in args.datasets:
        loader_name, S, M, max_iter = CONFIGS[name]
        loader = getattr(D, loader_name)
        rows = []
        for seed in range(args.seeds):
            Xt, yt, Xv, yv, meta = loader(seed=seed)
            fl = surrogate_floor(name, Xv, yv)
            if name == "co2":
                # The composite config that reaches the co2 NMSE floor
                # (experiments/co2.py), with the closed-form dispersion
                # recalibration: the reference's softplus(c)(1 + var_f)
                # inflates the predictive std at co2's extreme SNR.
                omega = 2 * math.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0
                m = SCFGP(sparsity=10, nfeats=20, seed=seed,
                          X_scaling_method="min-max",
                          y_scaling_method="normal",
                          extra_basis=seasonal_trend_basis(omega),
                          device=device)
                m.fit_fast(Xt, yt, Xv, yv, obj="cost", max_iter=max_iter,
                           algo=ADAMAX, max_cvrg=60, recalibrate=True)
            else:
                m = SCFGP(sparsity=S, nfeats=M, seed=seed, device=device)
                m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=max_iter)
            mnlp = float(m.evals["MNLP"][1][m.min_obj_ind])
            mse = float(m.evals["MSE"][1][m.min_obj_ind])
            self_cal = mnlp - 0.5 * (1 + np.log(2 * np.pi * mse))
            rows.append({
                "seed": seed, "source": meta["source"],
                "floor_mnlp": round(fl["MNLP"], 4),
                "floor_mnlp_homo": round(fl["MNLP_HOMO"], 4),
                "model_mnlp": round(mnlp, 4),
                "excess_nats": round(mnlp - fl["MNLP"], 4),
                "self_calibration_excess_nats": round(self_cal, 4),
                "model_mse": round(mse, 6),
                "floor_nmse": round(fl["NMSE"], 4),
            })
            print(json.dumps({name: rows[-1]}), flush=True)
        out[name] = {
            "rows": rows,
            "mean_excess_nats": round(float(np.mean(
                [r["excess_nats"] for r in rows])), 4),
            "mean_self_calibration_excess_nats": round(float(np.mean(
                [r["self_calibration_excess_nats"] for r in rows])), 4),
        }

    outdir = args.out or os.path.join(RESULTS, "floors")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "mnlp_floors.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: {kk: v[kk] for kk in
                          ("mean_excess_nats",
                           "mean_self_calibration_excess_nats")}
                      for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
