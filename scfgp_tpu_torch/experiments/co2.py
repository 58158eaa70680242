"""CO2 1-D regression on the port, plain and composite.

Port of ``experiments/co2.py``, which mirrors ``reference:
experiments/co2/CO2_1d_regression.py``: S=100, m=50, adamax lr 0.05 beta1
0.8, obj 'cost', max_iter 1000 (lines 14-35) by the host loop ``fit``.
The JAX driver's posterior-band rendering (``Visualizer``) is not ported
(ROADMAP.md Queue 1 item 9).  Then the composite configuration
(``experiments/co2.py:56-93``): known-annual-period seasonal and
quadratic-trend columns as ``extra_basis`` with linear y scaling, trained
by ``fit_fast``, with its NMSE over the surrogate's Bayes floor.

    python -m scfgp_tpu_torch.experiments.co2 [--quick] [--cpu] [--out DIR]

Writes ``co2_model.pkl`` and ``composite.json`` to the output directory.
"""

import argparse
import json
import math
import os

import torch

from ..data.datasets import load_co2, surrogate_floor
from ..models.model import SCFGP
from .boston_housing import RESULTS

ADAMAX = {"algo": "adamax",
          "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                          "beta2": 0.999, "epsilon": 1e-8}}


def seasonal_trend_basis(omega: float):
    """Columns [1, t, t², sin ωt, cos ωt, sin 2ωt, cos 2ωt] of the (scaled)
    time t, the JAX driver's ``seasonal_trend`` in torch."""
    def basis(Xs):
        t = Xs[:, :1]
        return torch.cat([torch.ones_like(t), t, t * t,
                          torch.sin(omega * t), torch.cos(omega * t),
                          torch.sin(2 * omega * t),
                          torch.cos(2 * omega * t)], dim=1)
    return basis


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    out = args.out or os.path.join(RESULTS, "co2")
    os.makedirs(out, exist_ok=True)

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    sparsity, nfeats = (20, 20) if args.quick else (100, 50)
    max_iter = 150 if args.quick else 1000
    model = SCFGP(sparsity=sparsity, nfeats=nfeats, seed=0, device=device)
    model.fit(Xt, yt, Xv, yv, obj="cost", algo=ADAMAX, nbatches=1,
              cvrg_tol=1e-5, max_cvrg=8, max_iter=max_iter)
    model.save(os.path.join(out, "co2_model.pkl"))
    rec = {"nmse": float(model.evals["NMSE"][1][model.min_obj_ind]),
           "mnlp": float(model.evals["MNLP"][1][model.min_obj_ind]),
           "iterations": len(model.evals["COST"][1]) - 1}
    print("NMSE:", rec["nmse"])
    print("MNLP:", rec["mnlp"])

    # Composite: the seasonal frequency (~44 cycles over the domain) is a
    # spectral mode gradient descent cannot reach from scratch, so it is
    # given as fixed columns (BASELINE config 4).
    omega = 2 * math.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0
    comp = SCFGP(sparsity=10, nfeats=20, seed=0,
                 X_scaling_method="min-max", y_scaling_method="normal",
                 extra_basis=seasonal_trend_basis(omega), device=device)
    comp.fit_fast(Xt, yt, Xv, yv, obj="cost", max_iter=max_iter,
                  algo=ADAMAX, max_cvrg=60)
    rec["composite_nmse"] = float(comp.evals["NMSE"][1][comp.min_obj_ind])
    rec["composite_iterations"] = len(comp.evals["COST"][1])
    if meta["source"] == "synthetic-surrogate":
        fl = surrogate_floor("co2", Xv, yv)
        rec["floor_nmse"] = fl["NMSE"]
        rec["nmse_over_floor"] = rec["composite_nmse"] / fl["NMSE"]
    with open(os.path.join(out, "composite.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print("composite:", rec)
    return rec


if __name__ == "__main__":
    main()
