"""kin8nm floor-closing on the port: the exact GP at two training sizes,
SCFGP at m=512 and an ensemble of k=8.

Port of ``experiments/kin8nm_floor.py``.  On one kin8nm split: the exact
ARD-RBF GP (``baselines/``, 150 ML-II steps) on the first 1000 and 2500
training rows (it is O(n³), so data-limited), SCFGP at S=20 and
``--nfeats`` features (SCORE, 500 iterations, max_cvrg 30) on all 6553,
and ``fit_ensemble(k, mix_best=k // 2)`` of the same model (max_cvrg 40,
``--max-iter``); each with its NMSE, NMSE over the surrogate's floor, MNLP
and seconds.

    python -m scfgp_tpu_torch.experiments.kin8nm_floor [--seed 0]
        [--skip-exact-gp] [--nfeats 512] [--k 8] [--max-iter 800]
        [--out kin8nm_floor.json] [--cpu]

``--out`` is the JAX driver's: the report's file name, under
``scfgp_tpu_torch/experiments/results/kin8nm_floor/`` unless it is a path
of its own (``os.path.join`` keeps an absolute one).  The report has the
keys of ``experiments/results/kin8nm_floor/kin8nm_floor.json``.  On the
card unless ``--cpu``; the first line names the device.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.datasets import load_kin8nm, surrogate_floor
from ..models.model import SCFGP
from .boston_housing import RESULTS
from .precision_quality import device_record

# The JAX driver's budgets that no option sets (experiments/
# kin8nm_floor.py:75-92): the exact GP's ML-II steps, the single fit's.
GP_STEPS = 150
FIT = dict(obj="SCORE", max_iter=500, cvrg_tol=1e-5, max_cvrg=30)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-exact-gp", action="store_true")
    ap.add_argument("--nfeats", type=int, default=512)
    ap.add_argument("--k", type=int, default=8,
                    help="ensemble restarts (mix_best = k // 2)")
    ap.add_argument("--max-iter", type=int, default=800)
    ap.add_argument("--out", default="kin8nm_floor.json",
                    help="the report's file name, or a path")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print(json.dumps(device_record(torch.device(device))), flush=True)

    Xt, yt, Xv, yv, meta = load_kin8nm(seed=args.seed)
    fl = surrogate_floor("kin8nm", Xv, yv)
    rows = {"seed": args.seed, "source": meta["source"],
            "floor_nmse": round(fl["NMSE"], 4),
            "floor_mnlp": round(fl["MNLP"], 4)}

    def record(name, nmse, mnlp, secs):
        rows[name] = {"nmse": round(nmse, 4),
                      "over_floor": round(nmse / fl["NMSE"], 3),
                      "mnlp": round(mnlp, 4), "seconds": round(secs, 1)}
        print(json.dumps({name: rows[name]}), flush=True)

    if not args.skip_exact_gp:
        from ..baselines import ExactGP
        for ntr in (1000, 2500):
            t0 = time.time()
            gp = ExactGP(steps=GP_STEPS, device=device).fit(Xt[:ntr],
                                                            yt[:ntr])
            mu, std = gp.predict(Xv)
            nmse = float(np.mean((mu - yv) ** 2) / np.var(yv))
            mnlp = float(np.mean(0.5 * ((yv - mu) / std) ** 2
                                 + 0.5 * np.log(2 * np.pi * std ** 2)))
            record(f"exact_gp_ntr{ntr}", nmse, mnlp, time.time() - t0)

    mfeat = args.nfeats
    t0 = time.time()
    m1 = SCFGP(sparsity=20, nfeats=mfeat, seed=args.seed,
               dtype=torch.float32, device=device)
    m1.fit_fast(Xt, yt, Xv, yv, **FIT)
    record(f"scfgp_m{mfeat}", m1.evals["NMSE"][1][m1.min_obj_ind],
           m1.evals["MNLP"][1][m1.min_obj_ind], time.time() - t0)

    t0 = time.time()
    m2 = SCFGP(sparsity=20, nfeats=mfeat, seed=args.seed,
               dtype=torch.float32, device=device)
    m2.fit_ensemble(Xt, yt, Xv, yv, k=args.k, mix_best=args.k // 2,
                    obj="SCORE", max_iter=args.max_iter, cvrg_tol=1e-5,
                    max_cvrg=40)
    record(f"scfgp_ensemble_k{args.k}_m{mfeat}",
           m2.evals["NMSE"][1][m2.min_obj_ind],
           m2.evals["MNLP"][1][m2.min_obj_ind], time.time() - t0)

    outdir = os.path.join(RESULTS, "kin8nm_floor")
    path = os.path.join(outdir, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
