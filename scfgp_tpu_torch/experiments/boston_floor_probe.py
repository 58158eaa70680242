"""Probe: which training and model variants close the boston surrogate gap?

Port of ``experiments/boston_floor_probe.py``.  SCFGP at the boston
experiment's config plateaus at ~1.3x the closed-form floor of the boston
surrogate, where an exact ARD-RBF GP reaches ~1.0x.  Candidate fixes on
the same splits, each as NMSE over the floor:

  base       — the experiment's config (S=20, m=20, adam, 500 iterations)
  long       — more patience (2000 iterations, max_cvrg 60)
  restarts   — best of 5 random restarts by validation NMSE
  linear     — a linear extra basis (the scaled inputs as fixed columns,
               the composite model of co2's trend basis)
  linear+rs  — the linear basis and the restarts

    python -m scfgp_tpu_torch.experiments.boston_floor_probe [--seeds K]
        [--cpu]

The first line names the device, then one line a seed and variant and the
summary as JSON.  Writes no file, as the JAX probe.  On the card unless
``--cpu``.  The budgets no option sets are module constants.
"""

import argparse
import json

import numpy as np
import torch

from ..data.datasets import load_boston, surrogate_floor
from ..models.model import SCFGP
from .boston_housing import ADAM, linear_basis
from .precision_quality import device_record

# The JAX probe's budgets (experiments/boston_floor_probe.py:42-76).
FIT = dict(max_iter=500, max_cvrg=18)
LONG = dict(max_iter=2000, max_cvrg=60)
RESTARTS = 5


def split(seed):
    """The boston split of ``seed`` and the NMSE of its closed-form floor:
    ``(Xt, yt, Xv, yv, floor)``."""
    Xt, yt, Xv, yv, _ = load_boston(seed=seed)
    return Xt, yt, Xv, yv, surrogate_floor("boston_housing", Xv, yv)["NMSE"]


def nmse(mu, yv):
    return float(np.mean((np.reshape(mu, -1) - yv) ** 2) / np.var(yv))


def summary(out) -> dict:
    """``{variant: {"mean_ratio", "ratios"}}`` of the ratios a seed, printed
    as the JAX probes print it."""
    rep = {k: {"mean_ratio": float(np.mean(v)),
               "ratios": [round(r, 3) for r in v]} for k, v in out.items()}
    print(json.dumps(rep, indent=1), flush=True)
    return rep


def start(argv, doc, seeds):
    """Parse the probes' options (``--seeds``, ``--cpu``), print the device
    line; returns ``(args, device)``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=seeds)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    print(json.dumps(device_record(torch.device(device))), flush=True)
    return args, device


def fit_model(Xt, yt, Xv, yv, seed, device, basis=None, **budget):
    """One fit_fast at the boston config (FIT unless ``budget`` says
    otherwise); returns the fitted model."""
    m = SCFGP(sparsity=20, nfeats=20, seed=seed, extra_basis=basis,
              device=device)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", algo=ADAM, cvrg_tol=1e-5,
               **{**FIT, **budget})
    return m


def fit_one(*args, **kw):
    """``fit_model``'s (validation NMSE, SCORE) of the best params."""
    m = fit_model(*args, **kw)
    return (float(m.evals["NMSE"][1][m.min_obj_ind]),
            float(m.evals["SCORE"][1][m.min_obj_ind]))


def main(argv=None) -> dict:
    args, device = start(argv, __doc__, 3)
    variants = {}
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, floor = split(seed)
        data = (Xt, yt, Xv, yv)

        def rec(name, value):
            variants.setdefault(name, []).append(value / floor)
            print(f"  seed {seed} {name:10s} NMSE {value:.4f} "
                  f"ratio {value / floor:.3f}", flush=True)

        rec("base", fit_one(*data, seed, device)[0])
        rec("long", fit_one(*data, seed, device, **LONG)[0])
        best = min(fit_one(*data, 100 * seed + k, device)
                   for k in range(RESTARTS))
        rec("restarts", best[0])
        rec("linear", fit_one(*data, seed, device, basis=linear_basis)[0])
        bestl = min(fit_one(*data, 100 * seed + k, device, basis=linear_basis)
                    for k in range(RESTARTS))
        rec("linear+rs", bestl[0])
    return summary(variants)


if __name__ == "__main__":
    main()
