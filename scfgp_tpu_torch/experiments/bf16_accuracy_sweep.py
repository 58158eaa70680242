"""bf16 GEMM accuracy sweep across the four benchmark experiments, on the
port.

Port of ``experiments/bf16_accuracy_sweep.py``.  ``mm_dtype=
torch.bfloat16`` runs the objective's two O(N K²) GEMMs (the Gram and
Φ·L⁻ᵀ, ``models/objective.py::_gemm``, ``ops/dispatch.py``) as bf16 GEMMs
with a float32 result; on the CPU the upcast product has the same
semantics (bf16-rounded inputs, float32 sums).  For each dataset, one
mid-sweep config (S=20), ``--trials`` seeds, each fitted twice on the same
split from the same init seed, float32 GEMMs and bf16 GEMMs, so that a
seed's difference isolates the GEMM arithmetic.  Decision rule: bf16 is
neutral on a dataset when |mean delta| < the float32 trials' std for
RMSE, NMSE and MNLP.

    python -m scfgp_tpu_torch.experiments.bf16_accuracy_sweep [--trials N]
        [--quick] [--cpu] [--out DIR]

Prints a line a dataset and writes ``<out>/bf16_sweep.json`` (default
``scfgp_tpu_torch/experiments/results/``) with the keys of the JAX
driver's ``experiments/results/bf16_sweep.json``.  On the card unless
``--cpu`` (the JAX driver runs on the CPU unless ``--tpu``); the first
line names the device.
"""

import argparse
import json
import os

import numpy as np
import torch

from ..data.datasets import load_abalone, load_boston, load_co2, load_kin8nm
from ..models.model import SCFGP
from .boston_housing import RESULTS
from .precision_quality import device_record

METRICS = ("RMSE", "NMSE", "MNLP", "SCORE")
# Mid-sweep configs of the reference experiment scripts: (name, loader,
# nfeats).
DATASETS = [
    ("boston", load_boston, 30),    # boston_housing.py:23 m in {10..50}
    ("abalone", load_abalone, 57),  # abalone.py:36 sqrt(N)(i+1)/3, i=2
    ("kin8nm", load_kin8nm, 80),    # kin8nm.py:31, i=2
    ("co2", load_co2, 50),          # CO2_1d_regression.py:18
]
# (trials, max_iter) of ``--quick``, and max_iter otherwise.
QUICK = (2, 60)
MAX_ITER = 200


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print(json.dumps(device_record(torch.device(device))), flush=True)

    trials, max_iter = QUICK if args.quick else (args.trials, MAX_ITER)
    opt = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
           "max_iter": max_iter, "cvrg_tol": 1e-5, "max_cvrg": 8}

    report = {}
    for name, loader, nfeats in DATASETS:
        rows = {"f32": {m: [] for m in METRICS},
                "bf16": {m: [] for m in METRICS}}
        for t in range(trials):
            Xtr, ytr, Xte, yte, _info = loader(seed=t)
            for tag, mm in (("f32", None), ("bf16", torch.bfloat16)):
                model = SCFGP(sparsity=20, nfeats=nfeats, seed=1000 + t,
                              mm_dtype=mm, device=device)
                model.fit_fast(Xtr, ytr, **opt)
                model.predict(Xte, yte)
                for m in METRICS:
                    rows[tag][m].append(float(model.evals[m][1][-1]))
        stats = {}
        for m in METRICS:
            a = np.asarray(rows["f32"][m])
            b = np.asarray(rows["bf16"][m])
            d = b - a
            stats[m] = {
                "f32_mean": float(a.mean()), "f32_std": float(a.std()),
                "bf16_mean": float(b.mean()),
                "delta_mean": float(d.mean()), "delta_std": float(d.std()),
                "neutral": bool(abs(d.mean()) < max(a.std(), 1e-12)),
            }
        report[name] = stats
        neutral = all(stats[m]["neutral"] for m in ("RMSE", "NMSE", "MNLP"))
        print(f"{name:8s} neutral={neutral} " + " ".join(
            f"{m}: {s['f32_mean']:+.4f}->{s['bf16_mean']:+.4f} "
            f"(d={s['delta_mean']:+.2e}, seed-std={s['f32_std']:.2e})"
            for m, s in stats.items() if m in ("RMSE", "MNLP")), flush=True)

    out = args.out or RESULTS
    os.makedirs(out, exist_ok=True)
    result = {"trials": trials, "max_iter": max_iter, "datasets": report}
    with open(os.path.join(out, "bf16_sweep.json"), "w") as f:
        json.dump(result, f, indent=2)
    all_neutral = all(
        all(report[n][m]["neutral"] for m in ("RMSE", "NMSE", "MNLP"))
        for n in report)
    print(json.dumps({"all_neutral": all_neutral}))
    return result


if __name__ == "__main__":
    main()
