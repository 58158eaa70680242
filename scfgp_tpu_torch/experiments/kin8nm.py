"""kin8nm benchmark on the port: robot-arm forward kinematics regression.

Port of ``experiments/kin8nm.py``, which mirrors ``reference:
experiments/kin8nm/kin8nm.py``: 50 trials, 10 feature sizes scaling with
sqrt(N) (lines 29-31), full rank by default (``SCFGP(-1, m)``, line 53).

    python -m scfgp_tpu_torch.experiments.kin8nm [--quick] [--trials N]
        [--sparsity S] [--cpu] [--out DIR]

``--sparsity S`` other than -1 writes ``results/kin8nm_s<S>``.
"""

import argparse
import os

import numpy as np

from ..data.datasets import load_kin8nm
from ..utils.experiment import run_sweep
from .boston_housing import ADAM, RESULTS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 trials x 2 sizes (smoke run)")
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--sparsity", type=int, default=-1,
                    help="-1 = the reference's full-rank protocol")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)

    n_train = int(0.8 * 8192)
    all_sizes = [int(np.sqrt(n_train) * (i + 1) / 3) for i in range(10)]
    nfeats = all_sizes[:2] if args.quick else all_sizes
    trials = args.trials or (2 if args.quick else 50)
    opt_params = {"algo": ADAM, "max_iter": 200, "cvrg_tol": 1e-5,
                  "max_cvrg": 8, "obj": "SCORE"}
    sub = "kin8nm" if args.sparsity == -1 else f"kin8nm_s{args.sparsity}"
    summary = run_sweep("kin8nm", load_kin8nm, nfeats,
                        sparsity=args.sparsity, trials=trials,
                        opt_params=opt_params,
                        out_dir=args.out or os.path.join(RESULTS, sub),
                        device="cpu" if args.cpu else "cuda")
    print("RMSE means:", summary["metrics"]["RMSE"]["mean"])
    print("MNLP means:", summary["metrics"]["MNLP"]["mean"])
    return summary


if __name__ == "__main__":
    main()
