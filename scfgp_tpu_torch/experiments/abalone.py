"""Abalone benchmark on the port: feature sizes m = sqrt(N)*(i+1)/3.

Port of ``experiments/abalone.py``, which mirrors ``reference:
experiments/abalone/abalone.py``: 30 trials, 10 feature sizes scaling with
sqrt(N) (lines 34-36), one-hot sex encoding (in the loader), full rank
S = D as the reference's legacy ``SCFGP(-1, feature_size)`` (line 58).

    python -m scfgp_tpu_torch.experiments.abalone [--quick] [--trials N]
        [--cpu] [--out DIR]
"""

import argparse
import os

import numpy as np

from ..data.datasets import load_abalone
from ..utils.experiment import run_sweep
from .boston_housing import ADAM, RESULTS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 trials x 2 sizes (smoke run)")
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)

    n_train = int(0.8 * 4177)
    all_sizes = [int(np.sqrt(n_train) * (i + 1) / 3) for i in range(10)]
    nfeats = all_sizes[:2] if args.quick else all_sizes
    trials = args.trials or (2 if args.quick else 30)
    opt_params = {"algo": ADAM, "max_iter": 200, "cvrg_tol": 1e-5,
                  "max_cvrg": 8, "obj": "SCORE"}
    summary = run_sweep("abalone", load_abalone, nfeats, sparsity=-1,
                        trials=trials, opt_params=opt_params,
                        out_dir=args.out or os.path.join(RESULTS, "abalone"),
                        device="cpu" if args.cpu else "cuda")
    print("RMSE means:", summary["metrics"]["RMSE"]["mean"])
    print("MNLP means:", summary["metrics"]["MNLP"]["mean"])
    return summary


if __name__ == "__main__":
    main()
