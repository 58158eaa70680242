"""SGLD at the BASELINE synthetic scale on the port: large-N Bayes
throughput on one card.

Port of ``experiments/tpu_sgld_scale.py``.  At N=1e6, D=256, S=M=128
(2K = 512, sampling dimension 49,155) and C chains it times three legs of
``bayes/sgld.py``:

  psgld-b4096, psgld-b16384   minibatch pSGLD: a step is one gather of B
                              rows and one B-row batched gradient;
  ula-streaming               full-batch ULA: a step is one streaming
                              gradient of all chains (blocks of
                              ``--streaming-block`` rows, each block copied
                              per chain inside the block).

Data are made on the device from ``--seed`` (X uniform, y standard normal:
the cost of a step does not depend on the values).  Each leg runs once,
timed to the host's read of its draws, with the peak memory it allocated
over what was resident before it (X and y).  One gradient of a few rows
before the legs builds the kernels.

    python -m scfgp_tpu_torch.experiments.sgld_scale [--n 1000000]
        [--d 256] [--chains 4] [--warmup 20] [--samples 50]
        [--streaming-block 16384] [--legs psgld-b4096,...] [--seed 0]
        [--cpu] [--out DIR]

One JSON line for the configuration and one a leg; writes
``<out>/sgld_scale.json`` (default
``scfgp_tpu_torch/experiments/results/hmc/``).  On the card unless
``--cpu``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..bayes import make_minibatch_value_and_grad, reduced_dim, sgld_sample
from ..models.params import init_params, pack_params
from .boston_housing import RESULTS

BATCHES = (4096, 16384)  # the pSGLD legs' minibatch rows


def problem(n, d, s, m, chains, seed, dev):
    """X (n, d) uniform and y (n,) standard normal, made on ``dev`` from
    ``seed``, and ``chains`` initial positions (chains, P)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.rand((n, d), generator=gen, device=dev)
    y = torch.randn((n,), generator=gen, device=dev)
    pgen = torch.Generator().manual_seed(seed + 1)
    P = reduced_dim(d, s, m)
    init = torch.stack([pack_params(init_params(pgen, d, s, m))[:P]
                        for _ in range(chains)]).to(dev)
    return X, y, init


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--sparsity", type=int, default=128)
    ap.add_argument("--nfeats", type=int, default=128)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--streaming-block", type=int, default=16384)
    ap.add_argument("--step-size", type=float, default=1e-6)
    ap.add_argument("--legs", default=None,
                    help="comma-separated subset of the legs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    D, S, M, n, C = args.d, args.sparsity, args.nfeats, args.n, args.chains
    X, y, init = problem(n, D, S, M, C, args.seed, dev)
    out = {"n": n, "d": D, "s": S, "m": M, "dim": init.shape[1], "chains": C,
           "samples": args.samples, "warmup": args.warmup,
           "device": str(dev), "legs": []}
    print(json.dumps({"config": out}), flush=True)
    make_minibatch_value_and_grad(X[:64], y[:64], D, S, M, 0)(init, None)
    outdir = args.out or os.path.join(RESULTS, "hmc")
    os.makedirs(outdir, exist_ok=True)
    plan = [(f"psgld-b{b}", b, 0) for b in BATCHES]
    plan.append(("ula-streaming", 0, args.streaming_block))
    if args.legs:
        wanted = {s.strip() for s in args.legs.split(",")}
        plan = [leg for leg in plan if leg[0] in wanted]
    warmup, samples = args.warmup, args.samples
    for tag, batch, block in plan:
        vg = make_minibatch_value_and_grad(X, y, D, S, M, batch,
                                           streaming_block=block)
        _sync(dev)
        resident = peak = None
        if dev.type == "cuda":
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        r = sgld_sample(vg, init, torch.Generator(device=dev).manual_seed(
            args.seed + 2), num_warmup=warmup, num_samples=samples,
            step_size=args.step_size)
        ld = r.logdensities.cpu().numpy()  # the host read ends the clock
        dt = time.time() - t0
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated() - resident
        row = {"leg": tag, "batch_size": batch, "streaming_block": block,
               "warmup": warmup, "samples": samples,
               "draws_per_s": samples * C / dt,
               "steps_per_s": (samples + warmup) / dt,
               "nonfinite": int(r.nonfinite),
               "logdensity_finite": bool(np.isfinite(ld).all()),
               "run_s": dt, "resident_bytes": resident,
               "peak_bytes_over_resident": peak}
        print(json.dumps(row), flush=True)
        out["legs"].append(row)
        with open(os.path.join(outdir, "sgld_scale.json"), "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
