"""The ESS/s-optimal tempered-HMC configuration, against plain HMC.

Port of ``experiments/tpu_tempering_sweep.py``.  The energy-matched pooled
ladder mixes (swap rates 0.58-0.76) on the trig-multimodal SCFGP
posterior where plain HMC's chains sit in separate basins; what is
ESS/s-optimal?  Rungs cost linearly a draw, so a coarser ladder (a larger
target gap, fewer rungs) may buy more min-ESS a second at a lower swap
rate, and a larger draw budget amortises the warmup.  Each leg is scored
by the cold chain's min bulk ESS a second (rank-normalised split-R-hat
and Geyer ESS, ``bayes/diagnostics.py``):

  plain-{base}           plain HMC, ``--base-samples`` draws
  tempered-g0.75-{base}  tempered, target gap 0.75
  tempered-g1.5-{base}   tempered, target gap 1.5
  plain-{big}            plain HMC, ``--big-samples`` draws
  tempered-g{w}-{big}    the ESS/s winner of the two gaps, ``--big-samples``

Data, width and inits as ``tempering_probe``; one shared pre-warmup
(PRE_WARMUP transitions, then PRE_SAMPLES draws) gives the inits and the
pooled ladder positions, cached in ``<out>/tempering_warm_{n}_{P}.npz``
(``--no-reuse-warm`` ignores the cache).  Each leg runs twice from those
inits, seeds 2 and 3: the first call's wall is ``first_call_s``, the
second's (to the host's read of its result) ``steady_run_s``, and the
second is scored.  JAX runs the tempered legs past 100 draws in segments
(``tempered_hmc_sample_segmented``, for a TPU worker's limit on one
execution); the port runs each leg in one call, the same in law.  The
report is rewritten after each leg; a run finds the legs a crashed run
measured in it (same dimension) and skips them.

    python -m scfgp_tpu_torch.experiments.tempering_sweep [--chains 8]
        [--n 2048] [--sparsity 20] [--nfeats 50] [--beta-min 0.6]
        [--max-rungs 12] [--no-reuse-warm] [--warmup 100]
        [--base-samples 100] [--big-samples 400] [--cpu] [--out DIR]

One JSON line a leg; writes ``<out>/tempering_sweep.json`` (default
``scfgp_tpu_torch/experiments/results/hmc/``) with the keys of the JAX
driver's.  On the card unless ``--cpu``; the first line names the device.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..bayes import (diagnose, energy_matched_ladder, hmc_sample,
                     tempered_hmc_sample)
from .boston_housing import RESULTS
from .tempering_probe import (HMC, add_width, posterior, pre_warmup,
                              random_inits)

# The shared pre-warmup (tpu_tempering_sweep.py:120-122).
PRE_WARMUP = 100


def warm_start(args, logpost, P, device, outdir, reuse=True):
    """The pre-warmup's draws (PRE_SAMPLES, C, P) on the host, from
    ``<outdir>/tempering_warm_{n}_{P}.npz`` if ``reuse`` and it is there,
    else run from ``args.chains`` random inits (seed 0) and saved there."""
    path = os.path.join(outdir, f"tempering_warm_{args.n}_{P}.npz")
    if reuse and os.path.exists(path):
        print(json.dumps({"pre_warmup": "cached", "path": path}), flush=True)
        return np.load(path)["warm_draws"]
    init = random_inits(args, args.chains, 0, device)
    draws, accept, wall = pre_warmup(logpost, init, PRE_WARMUP)
    np.savez_compressed(path, warm_draws=draws)
    print(json.dumps({"pre_warmup_s": round(wall, 1),
                      "accept": round(accept, 3)}), flush=True)
    return draws


def parse(argv=None):
    """The driver's options, the JAX driver's and ``--cpu``, ``--out``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_width(ap)
    ap.add_argument("--beta-min", type=float, default=0.6)
    ap.add_argument("--max-rungs", type=int, default=12,
                    help="ladder cap (12 x 8 chains: a batch of 96)")
    ap.add_argument("--no-reuse-warm", action="store_true",
                    help="ignore any cached pre-warmup positions")
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--base-samples", type=int, default=100)
    ap.add_argument("--big-samples", type=int, default=400)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device, logpost, P = posterior(args)
    print(json.dumps({"config": {"n": args.n, "dim": P,
                                 "chains": args.chains,
                                 "backend": device.type}}), flush=True)

    outdir = args.out or os.path.join(RESULTS, "hmc")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, "tempering_sweep.json")
    results = {"config": {"n": args.n, "dim": P, "chains": args.chains,
                          "warmup": args.warmup, "beta_min": args.beta_min,
                          "backend": device.type},
               "legs": []}
    if os.path.exists(outpath):  # crash-resume: keep the measured legs
        try:
            with open(outpath) as f:
                prev = json.load(f)
            if prev.get("config", {}).get("dim") == P:
                results["legs"] = prev.get("legs", [])
                print(json.dumps({"resumed_legs":
                                  [l["leg"] for l in results["legs"]]}),
                      flush=True)
        except (OSError, ValueError):
            pass
    done = {l["leg"]: l for l in results["legs"]}

    def save():
        with open(outpath, "w") as f:
            json.dump(results, f, indent=2)

    warm_draws = warm_start(args, logpost, P, device, outdir,
                            reuse=not args.no_reuse_warm)
    warm = torch.as_tensor(warm_draws[-1], device=device)
    ladder_pos = torch.as_tensor(warm_draws.reshape(-1, P), device=device)

    def leg(tag, samples, run, ladder=None):
        """Run ``run(seed)`` twice and score the second call; ``ladder``:
        (target gap, rungs) of a tempered leg."""
        if tag in done:
            print(json.dumps({"skipped_cached": tag}), flush=True)
            return done[tag]
        t0 = time.time()
        float(run(2).accept_rate)  # the host read ends the clock
        first = time.time() - t0
        t0 = time.time()
        r = run(3)
        rate = float(r.swap_rate if ladder else r.accept_rate)
        dt = time.time() - t0
        d = diagnose(r.samples.cpu().numpy(), int(r.divergences),
                     logdensities=r.logdensities.cpu().numpy())
        if ladder:
            out = {"leg": tag, "kind": "tempered", "target_gap": ladder[0],
                   "rhat_logdensity": round(d.rhat_logdensity, 4),
                   "rungs": ladder[1], "samples": samples,
                   "swap_rate": round(rate, 4),
                   "accept_rate": round(float(r.accept_rate), 3),
                   "cold_draws_per_s": round(samples * args.chains / dt, 2)}
        else:
            out = {"leg": tag, "kind": "plain", "samples": samples,
                   "rhat_logdensity": round(d.rhat_logdensity, 4),
                   "draws_per_s": round(samples * args.chains / dt, 2),
                   "accept_rate": round(rate, 3)}
        out.update(max_rhat=round(d.max_rhat, 4),
                   min_ess_bulk=round(d.min_ess_bulk, 1),
                   min_ess_tail=round(d.min_ess_tail, 1),
                   min_ess_bulk_per_s=round(d.min_ess_bulk / dt, 3),
                   divergences=d.divergences, steady_run_s=round(dt, 1),
                   first_call_s=round(first, 1))
        print(json.dumps(out), flush=True)
        results["legs"].append(out)
        save()
        return out

    def run_plain(samples):
        return leg(f"plain-{samples}", samples, lambda seed: hmc_sample(
            logpost, warm, seed, num_warmup=args.warmup,
            num_samples=samples, **HMC))

    def run_tempered(gap, samples):
        tag = f"tempered-g{gap}-{samples}"
        if tag in done:
            return leg(tag, samples, None)
        betas = energy_matched_ladder(logpost, ladder_pos,
                                      beta_min=args.beta_min,
                                      target_gap=gap,
                                      max_rungs=args.max_rungs)
        print(json.dumps({"leg": tag, "rungs_planned": int(betas.shape[0]),
                          "beta_last": round(float(betas[-1]), 4)}),
              flush=True)
        return leg(tag, samples, lambda seed: tempered_hmc_sample(
            logpost, warm, seed, betas=betas, num_warmup=args.warmup,
            num_samples=samples, **HMC), (gap, int(betas.shape[0])))

    ns = args.base_samples
    run_plain(ns)
    a = run_tempered(0.75, ns)
    b = run_tempered(1.5, ns)
    winner_gap = (0.75 if a["min_ess_bulk_per_s"] >= b["min_ess_bulk_per_s"]
                  else 1.5)
    run_plain(args.big_samples)
    run_tempered(winner_gap, args.big_samples)
    results["winner_gap_at_100"] = winner_gap
    save()
    print(json.dumps({"done": True, "out": outpath}), flush=True)
    return results


if __name__ == "__main__":
    main()
