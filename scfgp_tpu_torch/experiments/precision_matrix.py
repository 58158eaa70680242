"""Training steps/s under IEEE, TF32 and bf16 GEMMs by (N x 2K) cell: the
card's own crossover for ``mm_dtype="auto"``.

Port of ``experiments/tpu_precision_matrix.py``: at each cell, adam steps
of the objective (D=8, lr 0.01, data and params from seed 0) with the Gram
and Φ·L⁻ᵀ GEMMs in IEEE float32 (``mm_precision=None``), in TF32
(``mm_precision="default"``) and in bf16 with float32 output
(``mm_dtype=torch.bfloat16``; ``ops/dispatch.py``).  Steps/s is the median
of 3 sequences of REPS runs of ``--steps`` steps, timed by CUDA
events in turns over the legs, after one run of warm-up; the device ms a
step is that of one profiled run (torch.profiler).  The cells are the JAX
package's: 2K = 500 at N = 2048, 8192, 65536 and 2K = 1024 at N = 8192.
The rule ``auto_mm_dtype`` takes bf16 from N·(2K)² >= 6.8e10; this driver
records where the card's winner changes and changes no threshold.

    python -m scfgp_tpu_torch.experiments.precision_matrix [--steps 50]
        [--cpu] [--out DIR]

One JSON line a cell; writes ``<out>/precision_matrix.json`` (default
``scfgp_tpu_torch/experiments/results/precision/``).  On the card unless
``--cpu`` (then on the host clock, and no card number).
"""

import argparse
import json
import os

import torch

from ..ops.dispatch import BF16_GEMM_WORK_THRESHOLD
from .boston_housing import RESULTS
from .precision_quality import bench_run, device_record, timed_legs

# (N, S, M): 2K = 2 (S + M) (``experiments/tpu_precision_matrix.py:49-54``).
CELLS = [(2048, 50, 200), (8192, 50, 200), (8192, 112, 400),
         (65536, 50, 200)]
D = 8
# Runs of --steps steps in each timed sequence.
REPS = 3
LEGS = {"ieee": {}, "tf32": {"mm_precision": "default"},
        "bf16": {"mm_dtype": torch.bfloat16}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("precision_matrix: no CUDA device (use --cpu)")
    clock = "call" if device.type == "cuda" else "host"
    out = {**device_record(device), "steps": args.steps, "reps": REPS,
           "clock": clock, "cells": []}
    for N, S, M in CELLS:
        two_k = 2 * (S + M)
        cell = {"n": N, "two_k": two_k, "work": N * two_k ** 2,
                "auto_bf16": N * two_k ** 2 >= BF16_GEMM_WORK_THRESHOLD}
        legs = timed_legs({leg: bench_run(device, steps=args.steps, N=N,
                                          D=D, S=S, M=M, **kw)
                           for leg, kw in LEGS.items()},
                          args.steps, iters=REPS)
        for leg, r in legs.items():
            cell[leg] = r["steps_per_s"]
            cell[leg + "_device_ms_per_step"] = r["device_ms_per_step"]
        cell["tf32_speedup"] = cell["tf32"] / cell["ieee"]
        cell["bf16_speedup"] = cell["bf16"] / cell["ieee"]
        cell["winner"] = max(LEGS, key=lambda leg: cell[leg])
        out["cells"].append(cell)
        print(json.dumps(cell), flush=True)
    outdir = args.out or os.path.join(RESULTS, "precision")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "precision_matrix.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
