"""kin8nm Bayes probe on the port: chain-parallel samplers at the JAX
campaign's kin8nm width (S=20, M=50, D=8; sampling dimension 1163).

Port of ``experiments/kin8nm_bayes_probe.py``.  Two arms on the seed-0
split:

  tempered16   replica-exchange HMC with 16 chains, 100 + 200 steps, an
               energy-matched ladder of at most 12 rungs;
  hmc_fleet32  32 random-init HMC chains with a step size and a mass per
               chain (``shared_adaptation=False``), 300 + 300 steps.

    python -m scfgp_tpu_torch.experiments.kin8nm_bayes_probe [--quick]
        [--dataset kin8nm|boston] [--skip-tempered] [--cpu] [--out DIR]

Each arm prints one JSON line: held-out NMSE and MNLP of ``predict_bayes``
raw and with ``recalibrate=True``, NMSE over the surrogate's floor, the
sampler's acceptance and divergences, split-R-hat (coordinates and log
density), the least bulk ESS, the sampler's wall seconds and ESS a second.
Writes ``<out>/<dataset>_probe.json`` (default
``scfgp_tpu_torch/experiments/results/bayes_predictive/``).  The JAX
package's segmented runs (``segment=25``) are one-shot here: the two are
the same in law.
"""

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from ..data.datasets import load_boston, load_kin8nm, surrogate_floor
from ..utils.metrics import regression_metrics
from .boston_housing import RESULTS

S, M = 20, 50
# The JAX package's seed-0 tempered arm (experiments/results/
# bayes_predictive/results.json), the reference the arms are read against.
CAMPAIGN_REF = {"tempered8_nmse": 0.0259, "tempered8_mnlp": -1.623,
                "note": "seed-0 row of the JAX package's results.json"}


def run_arm(Xt, yt, Xv, yv, floor=None, device="cuda", seed=0,
            dtype=torch.float32, **kw):
    """One ``fit_bayes`` at S=20, M=50 and its held-out metrics: a dict of
    the fields the module docstring lists, plus the model."""
    from ..models.model import SCFGP
    m = SCFGP(sparsity=S, nfeats=M, seed=seed, device=device, dtype=dtype)
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(Xt, yt, **kw)
    wall = time.time() - t0
    ys = np.asarray(yv).reshape(-1, 1)
    raw = regression_metrics(*m.predict_bayes(Xv), ys)
    recal = regression_metrics(*m.predict_bayes(Xv, recalibrate=True), ys)
    d, res = m.bayes_diagnostics, m.bayes_result
    rec = {"NMSE": raw["NMSE"], "MNLP": raw["MNLP"],
           "recalibrated": {"NMSE": recal["NMSE"], "MNLP": recal["MNLP"]},
           "nmse_over_floor": raw["NMSE"] / floor if floor else None,
           "wall_s": wall, "sampler_wall_s": m.bayes_diagnostics_wall,
           "max_rhat": d.max_rhat, "rhat_logdensity": d.rhat_logdensity,
           "min_ess_bulk": d.min_ess_bulk,
           "ess_per_s": d.min_ess_bulk / m.bayes_diagnostics_wall,
           "divergences": int(d.divergences or 0),
           "accept": float(getattr(res, "accept_rate", float("nan"))),
           "draws": int(m.thetas.shape[0]),
           "config": {k: (v if isinstance(v, (int, float, str, bool))
                          else str(v)) for k, v in kw.items()}}
    if hasattr(res, "swap_rate"):
        rec.update(swap_rate=float(res.swap_rate),
                   rungs=int(res.step_sizes.shape[0]))
    return rec, m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="30 + 30 steps an arm (smoke run)")
    ap.add_argument("--dataset", default="kin8nm",
                    choices=["kin8nm", "boston"])
    ap.add_argument("--skip-tempered", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)

    loader = {"kin8nm": load_kin8nm, "boston": load_boston}[args.dataset]
    Xt, yt, Xv, yv, meta = loader(seed=0)
    floor = (surrogate_floor(meta["name"], Xv, yv)["NMSE"]
             if meta["source"] == "synthetic-surrogate" else None)
    w, n = (30, 30) if args.quick else (100, 200)
    wh, nh = (30, 30) if args.quick else (300, 300)
    out = {"seed": 0, "source": meta["source"], "floor_nmse": floor,
           "campaign_ref": CAMPAIGN_REF, "arms": {}}
    outdir = args.out or os.path.join(RESULTS, "bayes_predictive")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, f"{args.dataset}_probe.json")
    device = "cpu" if args.cpu else "cuda"

    def run(tag, **kw):
        rec, _ = run_arm(Xt, yt, Xv, yv, floor, device, **kw)
        out["arms"][tag] = rec
        with open(outpath, "w") as f:
            json.dump(out, f, indent=2)
        print(json.dumps({tag: rec}), flush=True)

    if not args.skip_tempered:
        run("tempered16", sampler="tempered", chains=16, num_warmup=w,
            num_samples=n, num_integration_steps=16, init_step_size=0.003,
            max_rungs=12)
    run("hmc_fleet32", sampler="hmc", chains=32, num_warmup=wh,
        num_samples=nh, num_integration_steps=16, init_step_size=0.003,
        shared_adaptation=False)
    print("wrote", outpath)
    return out


if __name__ == "__main__":
    main()
