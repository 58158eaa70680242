"""Tempered HMC with an energy-matched ladder, against plain HMC.

Port of ``experiments/tpu_tempering_probe.py``.  A geometric ladder of a
few rungs never swaps on this posterior (at N=2048, std(E) ~ 45 makes
adjacent-rung energy gaps of 10 or more); ``energy_matched_ladder``
(``bayes/tempering.py``) spaces the rungs by the measured std of the
untempered log posterior so the expected swap exponent is near
``--target-gap``.  Protocol, on ``synthetic_gp_rff`` data (N=2048, D=8,
S=20, M=50: sampling dimension 1163), C chains from random inits:

  1. plain HMC, warmup only, to reach the typical set (``--pre-warmup``
     transitions, then PRE_SAMPLES draws);
  2. the ladder from std(E) over those draws, within a chain or pooled
     (``--ladder-source``);
  3. replica-exchange HMC from the last pre-warmup draw, twice: the first
     call (``first_call_s``; the port compiles nothing, so this is a first
     call's wall) and a second one with another seed (``steady_run_s``),
     each timed to the host's read of its swap rate; rungs, swap rate,
     acceptance, cold-rung draws/s, R-hat and bulk ESS of the cold rung;
  4. plain HMC at the same draw budget from the same positions, scored
     the same way: the second call's only (JAX's first call compiled the
     program; the port has nothing to compile), timed to the host's read
     of its draws (JAX's clock also holds the diagnostics' host time).

Seeds 0 (the inits), 1 (step 1), 2 and 3 (the two calls of steps 3 and
4), as the JAX driver's keys.

    python -m scfgp_tpu_torch.experiments.tempering_probe [--chains 8]
        [--n 2048] [--samples 100] [--warmup 100] [--pre-warmup 100]
        [--target-gap 1.5] [--beta-min 0.2] [--max-rungs 48]
        [--sparsity 20] [--nfeats 50] [--ladder-source within|pooled]
        [--cpu] [--out DIR]

One JSON line a step; writes ``<out>/tempering_probe.json`` (default
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
                     make_logposterior, reduced_dim, tempered_hmc_sample)
from ..bayes.predictive import logdensity_in_chunks
from ..data.datasets import synthetic_gp_rff
from ..models.params import init_params, pack_params
from .boston_housing import RESULTS
from .precision_quality import device_record

D = 8
# Draws the pre-warmup keeps after its warmup (tpu_tempering_probe.py:83).
PRE_SAMPLES = 16
# The samplers' settings throughout the JAX campaigns.
HMC = dict(num_integration_steps=16, init_step_size=0.003)


def add_width(ap, chains=8):
    """The campaigns' shared options: the data and the model's width."""
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--chains", type=int, default=chains)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--sparsity", type=int, default=20,
                    help="S (smaller: a cheaper posterior for CPU runs)")
    ap.add_argument("--nfeats", type=int, default=50)
    ap.add_argument("--out", default=None, help="output directory")


def posterior(args):
    """``(device, logpost, P)``: the campaigns' log posterior on
    ``synthetic_gp_rff`` data (noise 0.1, seed 0), on the card unless
    ``--cpu``."""
    device = torch.device("cpu" if args.cpu else "cuda")
    print(json.dumps(device_record(device)), flush=True)
    X, y = synthetic_gp_rff(n=args.n, d=D, s=args.sparsity, m=args.nfeats,
                            noise_std=0.1, seed=0, dtype=np.float32)
    X, y = (torch.as_tensor(a, device=device) for a in (X, y))
    return (device, make_logposterior(X, y, D, args.sparsity, args.nfeats),
            reduced_dim(D, args.sparsity, args.nfeats))


def random_inits(args, chains, seed, device):
    """``chains`` positions (chains, P) from ``init_params``, drawn in turn
    from one generator seeded ``seed``."""
    S, M = args.sparsity, args.nfeats
    gen = torch.Generator().manual_seed(seed)
    P = reduced_dim(D, S, M)
    return torch.stack([pack_params(init_params(gen, D, S, M))[:P]
                        for _ in range(chains)]).to(device)


def pre_warmup(logpost, init, warmup):
    """Plain HMC to the typical set: ``warmup`` transitions, then
    PRE_SAMPLES draws (seed 1).  Returns the draws (PRE_SAMPLES, C, P) on
    the host, the acceptance rate and the wall seconds."""
    t0 = time.time()
    res = hmc_sample(logpost, init, 1, num_warmup=warmup,
                     num_samples=PRE_SAMPLES, **HMC)
    draws = res.samples.cpu().numpy()
    return draws, float(res.accept_rate), time.time() - t0


def parse(argv=None):
    """The driver's options, the JAX driver's and ``--cpu``, ``--out``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_width(ap)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--pre-warmup", type=int, default=100,
                    help="plain-HMC warmup used only to measure std(E)")
    ap.add_argument("--target-gap", type=float, default=1.5)
    ap.add_argument("--beta-min", type=float, default=0.2)
    ap.add_argument("--max-rungs", type=int, default=48)
    ap.add_argument("--ladder-source", choices=["within", "pooled"],
                    default="pooled",
                    help="energy scale for rung spacing: within-chain std "
                         "(unimodal fluctuation) or pooled std (includes "
                         "the cross-basin offsets that dominate swap "
                         "exponents on this trig-multimodal posterior)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device, logpost, P = posterior(args)
    init = random_inits(args, args.chains, 0, device)
    backend = device.type
    print(json.dumps({"config": {"n": args.n, "dim": P,
                                 "chains": args.chains,
                                 "backend": backend}}), flush=True)

    # 1. plain HMC to the typical set
    warm_draws, accept, wall = pre_warmup(logpost, init, args.pre_warmup)
    warm = torch.as_tensor(warm_draws[-1], device=device)
    print(json.dumps({"pre_warmup_s": round(wall, 1),
                      "accept": round(accept, 3)}), flush=True)

    # 2. the ladder from the draws' energy scale
    draws_t = torch.as_tensor(warm_draws, device=device)
    ladder_pos = (draws_t if args.ladder_source == "within"
                  else draws_t.reshape(-1, P))
    betas = energy_matched_ladder(
        logpost, ladder_pos, beta_min=args.beta_min,
        target_gap=args.target_gap, max_rungs=args.max_rungs)
    lds = logdensity_in_chunks(logpost, draws_t.reshape(-1, P), 32)
    lds = lds.cpu().numpy().astype(np.float64).reshape(PRE_SAMPLES, -1)
    std_within = round(float(np.median(np.std(lds, axis=0))), 2)
    std_pooled = round(float(np.std(lds)), 2)
    print(json.dumps({"std_E_within": std_within,
                      "std_E_pooled": std_pooled,
                      "rungs": int(betas.shape[0]),
                      "dbeta": round(float(betas[0] - betas[1]), 5)}),
          flush=True)

    # 3. replica exchange, a first and a second call
    def run(seed):
        return tempered_hmc_sample(
            logpost, warm, seed, betas=betas, num_warmup=args.warmup,
            num_samples=args.samples, **HMC)

    t0 = time.time()
    res = run(2)
    float(res.swap_rate)  # the host read ends the clock
    first = time.time() - t0
    t0 = time.time()
    res = run(3)
    swap = float(res.swap_rate)
    dt = time.time() - t0
    out = {
        "rungs": int(betas.shape[0]),
        "chains": args.chains,
        "dim": P,
        "n": args.n,
        "std_E_within": std_within,
        "std_E_pooled": std_pooled,
        "target_gap": args.target_gap,
        "swap_rate": round(swap, 4),
        "accept_rate": round(float(res.accept_rate), 3),
        "cold_draws_per_s": round(args.samples * args.chains / dt, 2),
        "steady_run_s": round(dt, 1),
        "first_call_s": round(first, 1),
        "backend": backend,
    }
    d_t = diagnose(res.samples.cpu().numpy(), int(res.divergences))
    out.update(max_rhat=round(d_t.max_rhat, 4),
               min_ess_bulk=round(d_t.min_ess_bulk, 1),
               min_ess_bulk_per_s=round(d_t.min_ess_bulk / dt, 3),
               divergences=d_t.divergences)
    print(json.dumps({"tempered": out}), flush=True)

    # 4. plain HMC at the same draw budget, the second call's seed
    t0 = time.time()
    r0 = hmc_sample(logpost, warm, 3, num_warmup=args.warmup,
                    num_samples=args.samples, **HMC)
    draws = r0.samples.cpu().numpy()
    dt_p = time.time() - t0
    d_p = diagnose(draws, int(r0.divergences))
    plain_out = {
        "draws_per_s": round(args.samples * args.chains / dt_p, 2),
        "max_rhat": round(d_p.max_rhat, 4),
        "min_ess_bulk": round(d_p.min_ess_bulk, 1),
        "min_ess_bulk_per_s": round(d_p.min_ess_bulk / dt_p, 3),
        "divergences": d_p.divergences,
        "accept_rate": round(float(r0.accept_rate), 3),
    }
    print(json.dumps({"plain_hmc_same_budget": plain_out}), flush=True)
    out["plain_hmc_same_budget"] = plain_out

    outdir = args.out or os.path.join(RESULTS, "hmc")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "tempering_probe.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
