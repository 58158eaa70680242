"""Sampler throughput on the port: samples and effective samples a second
of the chain-parallel samplers over the SCFGP posterior.

Port of ``experiments/bench_hmc.py``: the kin8nm campaign's width (D=8,
S=20, M=50, sampling dimension 1163) on ``synthetic_gp_rff`` data (N=2048),
C chains from random inits.  Legs:

  hmc          HMC, 16 leapfrog steps a transition, shared adaptation
  nuts         the dynamic NUTS, max_depth 6
  nuts_static  the fixed-budget NUTS, depth 5
  sgld_b256    pSGLD on 256-row minibatches, 10x the transitions of HMC

JAX's ``--mode fused`` compiles each sampler into one program and its
``--mode host`` loops over one compiled transition.  The port's samplers
are host loops either way (its ``*_host_looped`` entries are the same
samplers under JAX's signatures), so the two modes are one here:
``--mode`` is accepted for JAX's command line and changes nothing.
``--mm-precision`` (``experiments/bench_hmc.py:32-43``) sets the log
posterior's GEMM arithmetic (``ops/dispatch.py``): "global" (the
default) leaves it IEEE, the arithmetic ``fit_bayes`` gives its samplers
under "auto"; "default" takes the Gram and Φ·L⁻ᵀ in TF32, the explicit
speed lever; "highest" IEEE again.
Each leg runs once, timed to the host's read of its draws; one batched
gradient before the legs builds the kernels.

    python -m scfgp_tpu_torch.experiments.bench_hmc [--chains 8]
        [--n 2048] [--warmup 100] [--samples 100] [--mode fused|host]
        [--legs hmc,nuts,...] [--skip-nuts]
        [--mm-precision global|default|highest] [--cpu] [--out DIR]

One JSON line a leg; writes ``<out>/bench_hmc.json`` (default
``scfgp_tpu_torch/experiments/results/hmc/``).  On the card unless
``--cpu``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..bayes import (batched_value_and_grad, diagnose, hmc_sample,
                     make_logposterior, make_minibatch_value_and_grad,
                     nuts_sample, nuts_sample_static, reduced_dim,
                     sgld_sample)
from ..data.datasets import synthetic_gp_rff
from ..models.params import init_params, pack_params
from .boston_housing import RESULTS

D, S, M = 8, 20, 50
LEGS = ("hmc", "nuts", "nuts_static", "sgld_b256")


def legs(args, logpost, X, y, mm_precision=None):
    """``{name: run(init, generator) -> result}`` of the legs."""
    w, n = args.warmup, args.samples
    out = {"hmc": lambda q, g: hmc_sample(
        logpost, q, g, num_warmup=w, num_samples=n,
        num_integration_steps=16, init_step_size=0.003)}
    if not args.skip_nuts:
        out["nuts"] = lambda q, g: nuts_sample(
            logpost, q, g, num_warmup=w, num_samples=n, max_depth=6,
            init_step_size=0.003)
        out["nuts_static"] = lambda q, g: nuts_sample_static(
            logpost, q, g, num_warmup=w, num_samples=n, depth=5,
            init_step_size=0.003)
    out["sgld_b256"] = lambda q, g: sgld_sample(
        make_minibatch_value_and_grad(X, y, D, S, M, 256,
                                      mm_precision=mm_precision), q, g,
        num_warmup=w * 10, num_samples=n * 10, step_size=1e-5)
    return out


def gradients(name, res, args):
    """Batched gradients the leg took."""
    steps = args.warmup + args.samples
    if name == "hmc":
        return steps * 17
    if name == "nuts_static":
        return steps * 2 ** 5
    if name == "sgld_b256":
        return steps * 10
    return res.gradients


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--mode", choices=["fused", "host"], default="fused",
                    help="JAX's; one and the same host loop here")
    ap.add_argument("--skip-nuts", action="store_true")
    ap.add_argument("--mm-precision", default="global",
                    choices=["default", "highest", "global"],
                    help="the log posterior's GEMM arithmetic: 'global' "
                         "leaves it IEEE (fit_bayes's under 'auto'), "
                         "'default' takes TF32")
    ap.add_argument("--legs", default=None,
                    help="comma-separated subset of " + ",".join(LEGS))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    Xn, yn = synthetic_gp_rff(n=args.n, d=D, s=S, m=M, noise_std=0.1,
                              seed=0, dtype=np.float32)
    X, y = (torch.as_tensor(a, device=dev) for a in (Xn, yn))
    mp = None if args.mm_precision == "global" else args.mm_precision
    logpost = make_logposterior(X, y, D, S, M, mm_precision=mp)
    P = reduced_dim(D, S, M)
    gen = torch.Generator().manual_seed(0)
    init = torch.stack([pack_params(init_params(gen, D, S, M))[:P]
                        for _ in range(args.chains)]).to(dev)
    batched_value_and_grad(logpost)(init)  # builds the kernels
    runs = legs(args, logpost, X, y, mp)
    if args.legs:
        wanted = {s.strip() for s in args.legs.split(",")}
        runs = {k: v for k, v in runs.items() if k in wanted}
    results = {}
    for name, run in runs.items():
        g = torch.Generator(device=dev).manual_seed(2)
        t0 = time.time()
        res = run(init, g)
        draws = res.samples.cpu().numpy()  # the host read ends the clock
        dt = time.time() - t0
        ndiv = getattr(res, "divergences", None)
        diag = diagnose(draws, None if ndiv is None else int(ndiv),
                        logdensities=res.logdensities.cpu().numpy())
        accept = float(getattr(res, "accept_rate", float("nan")))
        grads = gradients(name, res, args)
        results[name] = {
            "rhat_logdensity": diag.rhat_logdensity,
            "samples_per_s": draws.shape[0] * args.chains / dt,
            "min_ess_bulk_per_s": diag.min_ess_bulk / dt,
            "min_ess_bulk": diag.min_ess_bulk,
            "min_ess_tail": diag.min_ess_tail, "max_rhat": diag.max_rhat,
            "divergences": diag.divergences,
            "accept_rate": accept if np.isfinite(accept) else None,
            "mean_depth": (float(res.mean_depth)
                           if hasattr(res, "mean_depth") else None),
            "gradients": grads, "gradients_per_s": grads / dt,
            "seconds": dt, "chains": args.chains, "dim": P, "n": args.n,
            "mm_precision": args.mm_precision}
        print(json.dumps({name: results[name]}), flush=True)
    outdir = args.out or os.path.join(RESULTS, "hmc")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "bench_hmc.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
