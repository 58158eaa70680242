"""Boston housing benchmark on the port: a sweep of Fourier feature counts.

Port of ``experiments/boston_housing.py``, which mirrors the reference
experiment (``reference: experiments/boston_housing/boston_housing.py``):
nfeats in {10..50}, S=20, adam lr 0.01, the best model kept by the SCORE
tournament, per-metric errorbar plots where matplotlib is installed.

    python -m scfgp_tpu_torch.experiments.boston_housing [--quick]
        [--trials N] [--batched] [--at-floor] [--cpu] [--out DIR]

``--batched`` trains all trials of a feature size in one batched fused
loop (``fit_fast_batch``); ``--at-floor`` is the floor-closing protocol,
``fit_ensemble(k=16, mix_best=8)`` with a linear extra basis, 1500
iterations and max_cvrg 40, written to ``results/boston_floor``.  Runs on
the card unless ``--cpu``.
"""

import argparse
import os

from ..data.datasets import load_boston
from ..utils.experiment import run_sweep

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
ADAM = {"algo": "adam",
        "algo_params": {"learning_rate": 0.01, "beta1": 0.9, "beta2": 0.999,
                        "epsilon": 1e-8}}
# The reference optimizer (boston_housing.py:24-40) with the patience of
# the JAX package's driver (max_iter 500, max_cvrg 18).
OPT = {"algo": ADAM, "max_iter": 500, "cvrg_tol": 1e-5, "max_cvrg": 18,
       "obj": "SCORE"}


def linear_basis(X):
    """The raw (scaled) inputs as fixed extra columns."""
    return X


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 trials x 2 sizes (smoke run)")
    ap.add_argument("--trials", type=int, default=None,
                    help="trials per feature size (reference: 50)")
    ap.add_argument("--batched", action="store_true",
                    help="train all trials of a size in one batched loop")
    ap.add_argument("--at-floor", action="store_true",
                    help="fit_ensemble(k=16, mix_best=8) with a linear "
                         "extra basis; writes results/boston_floor")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)

    trials = args.trials or (2 if args.quick else 50)
    nfeats = [10, 30] if args.quick else [10, 20, 30, 40, 50]
    opt_params, kw, name = dict(OPT), {}, "boston_housing"
    if args.at_floor:
        name = "boston_floor"
        opt_params.update(max_iter=1500, max_cvrg=40)
        kw = dict(ensemble=16, mix_best=8, extra_basis=linear_basis)
    elif args.batched:
        kw = dict(batched=True)
    summary = run_sweep(name, load_boston, nfeats, sparsity=20,
                        trials=trials, opt_params=opt_params,
                        out_dir=args.out or os.path.join(RESULTS, name),
                        device="cpu" if args.cpu else "cuda", **kw)
    print("NMSE means:", summary["metrics"]["NMSE"]["mean"])
    print("MNLP means:", summary["metrics"]["MNLP"]["mean"])
    print("data source:", summary["data_source"])
    return summary


if __name__ == "__main__":
    main()
