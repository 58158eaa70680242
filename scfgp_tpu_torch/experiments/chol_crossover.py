"""The Cholesky crossover: the blocked kernels K4 and K3 against torch's
pair, by matrix size.

The port of ``experiments/tpu_chol_crossover.py``, with the checks of
``experiments/tpu_chol_probe.py:38-54``.  Legs, at each n:

  torch_chol      ``cholesky_ref`` (torch.linalg.cholesky_ex)
  torch_chol_inv  ``cholesky_inverse_ref``: chol, then a triangular solve
                  against the identity (the port's production pair)
  neumann_inv     chol, then ``tri_inverse_blocked`` with blocks of
                  gcd(n, 256) (256 at every default size)
  kernel_chol     ``cholesky_kernel`` (K4)
  kernel_fused    ``cholesky_inverse_kernel`` (K3)

The kernel legs run at every size: the matrix lives in global memory, so
there is no bound like the Pallas kernels' whole-matrix VMEM residency.
The input is the JAX script's: ``B = randn(n, n) / sqrt(n)`` from
``np.random.RandomState(0)``, ``A = B Bᵀ + I``, float32.

Each leg reports ``call_ms``, the time per call as a caller sees it (CUDA
events on the card, the host clock on the CPU), and on the card
``device_ms``, the device's work alone (``utils/profiling.py::time_fn``),
each the median of ``reps`` runs of ``iters`` calls.  The kernel legs also
report ``max_abs_err``, their largest difference from the plain leg
(kernel_chol's L from torch_chol's, kernel_fused's L and L⁻¹ from
torch_chol_inv's); each size reports ``neumann_err``, the largest
difference of neumann_inv's L⁻¹ from torch_chol_inv's.

    python -m scfgp_tpu_torch.experiments.chol_crossover [--cpu]
        [--sizes 512 1024 2048 4096] [--iters 10] [--reps 3] [--out path]

prints one JSON line per (size, leg) and a last line with the card (or
"cpu"); it writes the whole result to ``--out`` only when given one.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.cholesky import (cholesky_inverse_kernel, cholesky_inverse_ref,
                            cholesky_kernel, cholesky_ref,
                            tri_inverse_blocked)
from ..utils.profiling import time_fn

SIZES = (512, 1024, 2048, 4096)
NEUMANN_BLOCK = 256


def spd_input(n: int, device) -> torch.Tensor:
    """``B Bᵀ + I`` with ``B = randn(n, n) / sqrt(n)`` from
    ``RandomState(0)``, float32 (``tpu_chol_crossover.py:108-110``)."""
    rng = np.random.RandomState(0)
    B = rng.randn(n, n).astype(np.float32) / np.float32(np.sqrt(n))
    return torch.as_tensor(B @ B.T + np.eye(n, dtype=np.float32),
                           device=device)


def _neumann_inv(A):
    L = cholesky_ref(A)
    return L, tri_inverse_blocked(L, block=math.gcd(A.shape[0],
                                                    NEUMANN_BLOCK))


LEGS = {"torch_chol": cholesky_ref, "torch_chol_inv": cholesky_inverse_ref,
        "neumann_inv": _neumann_inv, "kernel_chol": cholesky_kernel,
        "kernel_fused": cholesky_inverse_kernel}
# The plain leg each kernel leg is held against.
PLAIN = {"kernel_chol": "torch_chol", "kernel_fused": "torch_chol_inv"}


def _max_diff(a, b) -> float:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def crossover(sizes=SIZES, device="cuda", iters: int = 10, reps: int = 3,
              report: Optional[Callable[[dict], None]] = None) -> dict:
    """Run every leg at every size on ``device`` ("cuda" or "cpu"); returns
    ``{"device": ..., "sizes": {n: {"neumann_err": ..., "legs": {leg:
    {"call_ms", "device_ms", ["max_abs_err"]}}}}}`` and passes each (size,
    leg) line to ``report``.  On "cuda" there is no fallback: no card
    raises."""
    device = torch.device(device)
    card = device.type == "cuda"
    if card and not torch.cuda.is_available():
        raise RuntimeError("crossover: no CUDA device")
    out = {"device": torch.cuda.get_device_name(device) if card else "cpu",
           "sizes": {}}
    for n in sizes:
        A = spd_input(n, device)
        with torch.no_grad():
            got = {name: fn(A) for name, fn in LEGS.items()}
            neumann_err = _max_diff(got["neumann_inv"][1],
                                    got["torch_chol_inv"][1])
            cell = out["sizes"][n] = {"neumann_err": neumann_err, "legs": {}}
            for name, fn in LEGS.items():
                row = {"call_ms": statistics.median(
                    time_fn(fn, A, iters=iters, warmup=1,
                            clock="call" if card else "host")["ms_per_call"]
                    for _ in range(reps))}
                row["device_ms"] = statistics.median(
                    time_fn(fn, A, iters=iters, warmup=0,
                            clock="device")["ms_per_call"]
                    for _ in range(reps)) if card else None
                if name in PLAIN:
                    row["max_abs_err"] = _max_diff(got[name],
                                                   got[PLAIN[name]])
                cell["legs"][name] = row
                if report is not None:
                    report({"n": n, "leg": name, **row,
                            "neumann_err": neumann_err})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions)")
    ap.add_argument("--sizes", nargs="*", type=int, default=list(SIZES))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="write the result as JSON to this path")
    args = ap.parse_args(argv)
    res = crossover(args.sizes, "cpu" if args.cpu else "cuda", args.iters,
                    args.reps,
                    report=lambda line: print(json.dumps(line), flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    print(json.dumps({"device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
