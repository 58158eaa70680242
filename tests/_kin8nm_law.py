"""The kin8nm IEEE quality law of both packages, on the CPU.

The kin8nm leg of the precision quality run (S=-1, M=212, 200 iterations,
SCORE, float32, IEEE products; ``experiments/tpu_precision_quality.py:
104-109`` and ``scfgp_tpu_torch/experiments/precision_quality.py:61-66``):
seed and split = the trial, in the JAX package and in the port.  A trial
ends in the bad basin when its validation NMSE exceeds BAD_NMSE.  The two
packages draw their inits and the fused loop's stall annealing from
different generators, so they are compared in law: the share of bad
trials in each, and the two-sided Fisher exact p of the 2 x 2 table.
``--jax-init`` runs the port from the JAX package's init of each trial
(its own annealing draws): it separates the inits' law from the loop's.
Torch takes THREADS threads.

    python tests/_kin8nm_law.py [--seeds 20] [--first 0] [--jax-init]

One JSON line a trial and package, then the summary.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BAD_NMSE = 0.2
MODEL = dict(sparsity=-1, nfeats=212)
FIT = dict(max_iter=200, obj="SCORE")
THREADS = 4


def trial(package, seed, jax_init=False):
    from scfgp_tpu.data.datasets import load_kin8nm
    Xt, yt, Xv, yv, _ = load_kin8nm(seed=seed)
    if package == "jax":
        from scfgp_tpu import SCFGP
        m = SCFGP(seed=seed, mm_precision=None, **MODEL)
    else:
        from scfgp_tpu_torch import SCFGP
        m = SCFGP(seed=seed, mm_precision=None, device="cpu", **MODEL)
    if package == "torch" and jax_init:
        from scfgp_tpu import SCFGP as JaxSCFGP
        from scfgp_tpu_torch.models.params import params_from_numpy
        mj = JaxSCFGP(seed=seed, mm_precision=None, **MODEL)
        mj.set_data(Xt, yt)
        m.params = params_from_numpy([np.asarray(a) for a in mj.params])
    m.fit_fast(Xt, yt, Xv, yv, **FIT)
    return {"package": package, "seed": seed,
            "NMSE": float(m.evals["NMSE"][1][m.min_obj_ind]),
            "MNLP": float(m.evals["MNLP"][1][m.min_obj_ind]),
            "iterations": len(m.evals["COST"][1])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--first", type=int, default=0, help="the first seed")
    ap.add_argument("--jax-init", action="store_true",
                    help="the port from the JAX package's init of a trial")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(THREADS)
    packages = ["jax", "torch"]
    rows = {p: [] for p in packages}
    for seed in range(args.first, args.first + args.seeds):
        for p in packages:
            rows[p].append(trial(p, seed, args.jax_init))
            print(json.dumps(rows[p][-1]), flush=True)
    out = {}
    for p, rs in rows.items():
        nmse = np.array([r["NMSE"] for r in rs])
        out[p] = {"trials": len(rs), "bad": int((nmse > BAD_NMSE).sum()),
                  "mean_nmse": float(nmse.mean()),
                  "median_nmse": float(np.median(nmse)),
                  "nmse": nmse.tolist()}
    from scipy.stats import fisher_exact
    table = [[out[p]["bad"], out[p]["trials"] - out[p]["bad"]]
             for p in packages]
    out["fisher_exact_p"] = float(fisher_exact(table)[1])
    print(json.dumps({"summary": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
