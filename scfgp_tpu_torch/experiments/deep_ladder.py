"""Cross-basin ESS: a deep tempering ladder against many-chains HMC.

Port of ``experiments/tpu_deep_ladder.py``.  On the dimension-1163
trig-multimodal SCFGP posterior every 100-400-draw leg of the sweep
measures min-ESS-bulk ~ #chains (8): each chain gives about one effective
draw of cross-basin information.  This campaign runs the prescribed
experiment:

  tempered  ``--rungs`` (24) energy-matched rungs down to ``--beta-min``
            (0.3), target gap 0.75, ``--samples`` (2000) draws of
            ``--chains`` (8) chains from the shared pre-warmup's last draw;
  plain     ``--plain-chains`` (64) random-init chains of plain HMC, their
            own warmup, then chunks of SEG_DRAWS draws continued from the
            adapted step size and mass (``adapted=``) until the tempered
            leg's wall time is spent: once with the adaptation shared by
            the chains, once per chain (``shared_adaptation=False``).

Verdict: whether the tempered leg's min-ESS-bulk is far above its chain
count, and which leg has the larger min-ESS a second.  JAX runs the
tempered leg in segments of ``--segment`` draws
(``tempered_hmc_sample_segmented``, for a TPU worker's limit on one
execution); the port runs it in one call, the same in law, and keeps
``--segment`` in the config and the leg as ``fit_bayes(segment=)`` does.
Data, width and the pre-warmup cache as ``tempering_sweep``'s (a cache it
left is used; else the pre-warmup runs from ``--chains`` random inits,
PRE_WARMUP transitions).  Seeds: the tempered leg 11, the plain inits 5,
their warmup 12, the chunks 13, 14, ...  The report is rewritten after
each leg; a run finds the legs a crashed run measured in it (same
dimension) and skips them.

    python -m scfgp_tpu_torch.experiments.deep_ladder [--chains 8]
        [--plain-chains 64] [--n 2048] [--sparsity 20] [--nfeats 50]
        [--rungs 24] [--beta-min 0.3] [--samples 2000] [--warmup 100]
        [--segment 50] [--cpu] [--out DIR]

One JSON line a leg and the verdict; writes
``<out>/deep_ladder_campaign.json`` (default
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
from .tempering_probe import HMC, add_width, posterior, random_inits
from .tempering_sweep import warm_start

# The tempered leg's ladder spacing (tpu_deep_ladder.py:127) and the plain
# legs' continuation chunk (:178).
TARGET_GAP = 0.75
SEG_DRAWS = 200


def score(draws, lds, ndiv, wall, extra):
    """A leg's diagnostics (tpu_deep_ladder.py:87-103)."""
    d = diagnose(draws, ndiv, logdensities=lds)
    leg = {"max_rhat": round(d.max_rhat, 4),
           "rhat_logdensity": round(d.rhat_logdensity, 4),
           "min_ess_bulk": round(d.min_ess_bulk, 1),
           "min_ess_tail": round(d.min_ess_tail, 1),
           "ess_logdensity": round(d.ess_bulk_logdensity, 1)
           if np.isfinite(d.ess_bulk_logdensity) else None,
           "min_ess_bulk_per_s": round(d.min_ess_bulk / wall, 3),
           "divergences": d.divergences, "wall_s": round(wall, 1),
           "chains": int(draws.shape[1]),
           "draws_per_chain": int(draws.shape[0])}
    leg.update(extra)
    return leg


def parse(argv=None):
    """The driver's options, the JAX driver's and ``--cpu``, ``--out``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_width(ap)
    ap.add_argument("--plain-chains", type=int, default=64)
    ap.add_argument("--rungs", type=int, default=24)
    ap.add_argument("--beta-min", type=float, default=0.3)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--segment", type=int, default=50,
                    help="JAX's segment length; recorded, one call here")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device, logpost, P = posterior(args)

    outdir = args.out or os.path.join(RESULTS, "hmc")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, "deep_ladder_campaign.json")
    config = {k: v for k, v in vars(args).items() if k != "out"}
    results = {"config": config | {"dim": P, "backend": device.type},
               "legs": {}}
    if os.path.exists(outpath):  # crash-resume: keep the measured legs
        try:
            with open(outpath) as f:
                prev = json.load(f)
            if prev.get("config", {}).get("dim") == P:
                results["legs"] = prev.get("legs", {})
                print(json.dumps({"resumed": list(results["legs"])}),
                      flush=True)
        except (OSError, ValueError):
            pass

    def save():
        with open(outpath, "w") as f:
            json.dump(results, f, indent=2)

    warm_draws = warm_start(args, logpost, P, device, outdir)
    warm = torch.as_tensor(warm_draws[-1][:args.chains], device=device)
    ladder_pos = torch.as_tensor(warm_draws.reshape(-1, P), device=device)

    # -- leg 1: the deep tempered ladder -----------------------------------
    tag_t = f"tempered-{args.rungs}r-b{args.beta_min}-{args.samples}"
    if tag_t not in results["legs"]:
        betas = energy_matched_ladder(
            logpost, ladder_pos, beta_min=args.beta_min,
            target_gap=TARGET_GAP, max_rungs=args.rungs)
        print(json.dumps({"rungs_planned": int(betas.shape[0]),
                          "betas_head": [round(float(b), 3)
                                         for b in betas[:4]]}), flush=True)
        t0 = time.time()
        r = tempered_hmc_sample(logpost, warm, 11, betas=betas,
                                num_warmup=args.warmup,
                                num_samples=args.samples, **HMC)
        draws = r.samples.cpu().numpy()  # the host read ends the clock
        wall = time.time() - t0
        leg = score(draws, r.logdensities.cpu().numpy(), int(r.divergences),
                    wall, {"kind": "tempered", "rungs": int(betas.shape[0]),
                           "swap_rate": round(float(r.swap_rate), 4),
                           "accept_rate": round(float(r.accept_rate), 3),
                           "segment": args.segment,
                           "wall_incl_warmup_compile_s": round(wall, 1)})
        results["legs"][tag_t] = leg
        save()
        print(json.dumps({tag_t: leg}), flush=True)
        tempered_wall = wall
    else:
        tempered_wall = results["legs"][tag_t]["wall_s"]

    # -- legs 2 and 3: many-chains plain HMC at equal wall time ------------
    def plain_leg(tag_p, shared):
        init_many = random_inits(args, args.plain_chains, 5, device)
        budget = tempered_wall
        t_start = time.time()
        r0 = hmc_sample(logpost, init_many, 12, num_warmup=args.warmup,
                        num_samples=1, shared_adaptation=shared, **HMC)
        r0.samples.cpu()  # host read
        adapted = (r0.step_size, r0.inv_mass)
        q, seed, rate_wall = r0.final_positions, 13, None
        chunks, lds, ndiv = [], [], 0
        # The first chunk calibrates the rate and counts toward the budget.
        while (rate_wall is None
               or time.time() - t_start + rate_wall * 0.9 < budget):
            t0 = time.time()
            r = hmc_sample(logpost, q, seed, num_warmup=0,
                           num_samples=SEG_DRAWS, adapted=adapted, **HMC)
            chunks.append(r.samples.cpu().numpy())
            lds.append(r.logdensities.cpu().numpy())
            ndiv += int(r.divergences)
            q, seed = r.final_positions, seed + 1
            if rate_wall is None:
                rate_wall = time.time() - t0
        wall = time.time() - t_start
        leg = score(np.concatenate(chunks), np.concatenate(lds), ndiv, wall,
                    {"kind": "plain-many-chains",
                     "shared_adaptation": shared,
                     "accept_rate": round(float(r.accept_rate), 3),
                     "budget_from": tag_t,
                     "budget_s": round(budget, 1)})
        results["legs"][tag_p] = leg
        save()
        print(json.dumps({tag_p: leg}), flush=True)

    tag_p = f"plain-{args.plain_chains}c-equal-time"
    if tag_p not in results["legs"]:
        plain_leg(tag_p, True)
    tag_f = f"plain-{args.plain_chains}c-fleet-equal-time"
    if tag_f not in results["legs"]:
        plain_leg(tag_f, False)

    # -- the verdict -------------------------------------------------------
    lt = results["legs"][tag_t]
    lp = results["legs"].get(tag_f, results["legs"][tag_p])
    results["verdict"] = {
        "criterion": f"min_ess_bulk >> chains ({args.chains}) for tempered",
        "tempered_min_ess_bulk": lt["min_ess_bulk"],
        "tempered_ess_ld": lt.get("ess_logdensity"),
        "plain_many_min_ess_bulk": lp["min_ess_bulk"],
        "plain_many_ess_ld": lp.get("ess_logdensity"),
        "winner_min_ess_per_s": (
            "tempered" if lt["min_ess_bulk_per_s"]
            > lp["min_ess_bulk_per_s"] else "plain-many-chains"),
    }
    save()
    print(json.dumps({"verdict": results["verdict"]}), flush=True)
    return results


if __name__ == "__main__":
    main()
