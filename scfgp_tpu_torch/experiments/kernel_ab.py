"""Time the feature-map and Gram kernels K1f, K1b, K2f and K2b of any
``csrc`` directory, so that two trees can be compared in one run.

    python -m scfgp_tpu_torch.experiments.kernel_ab [--csrc DIR]
        [--kernels phi_fwd phi_bwd gram_fwd gram_bwd] [--shapes block ...]
        [--tag NAME]

Builds ``DIR/<kernel>.cu`` (default: this package's ``csrc``) with the
package's nvcc flags and ``-I DIR`` into a temporary directory, so a parent
tree unpacked by ``git archive`` is timed with its own headers.  The C
interfaces are this package's (``ops/phi.py``, ``ops/gram.py``): K1f's and
K1b's take a trial count, so a tree whose K1f/K1b entries take none cannot
be timed for those two.  SHAPES are 2-D calls (N, D, K); BATCH_SHAPES
(B, N, D, K) are K1f and K1b with a trial axis, B trials in one launch
(K2f and K2b take none and skip them).  For each kernel and shape it prints
one JSON line: ``ms``, the device time per call
(``utils/profiling.py::time_fn``, the host's enqueue hidden, median of
REPS), ``max_abs_err`` of each output against the plain PyTorch version on
the same inputs (made from seed 0), ``digest``, a hash of the output's
bytes, equal for two trees exactly when their outputs are bitwise equal,
and ``kernels``, each CUDA kernel's launches per call and µs per launch
under torch.profiler.  A first line gives the ptxas report (registers,
shared memory, spills) of each library.  Run the trees in turns (parent,
new, new, parent) in one call to compare them.  The card only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops.build import CSRC_DIR, NVCC_FLAGS, find_nvcc
from ..ops.gram import _SIGNATURES as GRAM_SIGNATURES
from ..ops.gram import gram_bwd_ref, sufficient_stats_ref
from ..ops.phi import _SIGNATURES as PHI_SIGNATURES
from ..ops.phi import fourier_features_ref, phi_bwd_ref
from ..utils.profiling import time_fn
from .chol_variants import by_kernel

KERNELS = ("phi_fwd", "phi_bwd", "gram_fwd", "gram_bwd")
# (N, D, K): the served kin8nm model, the bench configuration, D = 256 with
# K = 500, and the streaming block of chip_smoke.py's phase 9.
SHAPES = {"kin8nm": (6553, 8, 277), "bench": (8192, 8, 250),
          "d256": (4096, 256, 500), "block": (16384, 256, 256)}
# (B, N, D, K) of K1f and K1b with a trial axis: the boston sweep's 50
# trials, the Bayes fleet's 32 chains and tempering's 8 chains x 12 rungs
# (chip_smoke.py BATCH_SHAPES).
BATCH_SHAPES = {"batch-boston": (50, 455, 13, 70),
                "batch-bayes": (32, 6553, 8, 50),
                "batch-tempered": (96, 6553, 8, 50)}
REPS = 7
PROFILED_CALLS = 5


def build(csrc: Path, name: str, out_dir: Path):
    """Compile ``csrc/<name>.cu``; returns the loaded library and ptxas's
    lines naming each kernel and its registers, shared memory and spills."""
    so = out_dir / f"lib{name}.so"
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o",
                          str(so), str(csrc / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n"
                           f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    sigs = {**PHI_SIGNATURES, **GRAM_SIGNATURES}[name]
    for fn, (args, restype) in sigs.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = restype
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    return lib, ptxas


def inputs(n, d, k, dev, trials=None):
    """Inputs from seed 0, frequencies of scale 3 (|T| reaches tens); with
    ``trials`` a leading trial axis on X, F, p, g and one scale a trial."""
    rng = np.random.RandomState(0)
    lead = () if trials is None else (trials,)
    X, F, p, g = (
        torch.as_tensor(a, dtype=torch.float32, device=dev)
        for a in (rng.rand(*lead, n, d), 3.0 * rng.randn(*lead, d, k),
                  rng.uniform(0, 2 * np.pi, (*lead, k)),
                  rng.randn(*lead, n, 2 * k)))
    if trials is not None:
        s = torch.as_tensor(rng.uniform(0.5, 1.5, trials),
                            dtype=torch.float32, device=dev)
        return dict(X=X, F=F, p=p, s=s, g=g)
    y, cbar, pbar = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (rng.randn(n), rng.randn(2 * k, 2 * k),
                               rng.randn(2 * k)))
    return dict(X=X, F=F, p=p, s=torch.tensor(0.7, device=dev), g=g, y=y,
                cbar=cbar, pbar=pbar)


def digest(outs) -> str:
    """A hash of the outputs' bytes: two trees' digests on the same inputs
    are equal exactly when their outputs are bitwise equal."""
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def call_and_ref(lib, name, t, n, d, k, trials=1):
    """(the kernel's call, its output tensors, the plain version's).  K1f
    and K1b take ``trials`` problems at once; K2f and K2b one."""
    dev = t["X"].device
    X, F, p, s = t["X"], t["F"], t["p"], t["s"]
    ptr = [X.data_ptr(), F.data_ptr(), p.data_ptr(), s.data_ptr()]
    k2 = 2 * k
    lead = X.shape[:-2]
    if name == "phi_fwd":
        out = torch.empty(*lead, n, k2, device=dev)
        args = ptr + [out.data_ptr()]
        fn, outs = lib.scfgp_phi_fwd_f32, [out]
        ref = [fourier_features_ref(X, F, p, s)]
    elif name == "phi_bwd":
        out = torch.empty(*lead, d * k + k + 1, device=dev)
        work = torch.empty(lib.scfgp_phi_bwd_workspace(trials, n, d, k),
                           device=dev)
        args = ptr + [t["g"].data_ptr(), work.data_ptr(), out.data_ptr()]
        fn = lib.scfgp_phi_bwd_f32
        outs = [out[..., :d * k].view(*lead, d, k), out[..., d * k:d * k + k],
                out[..., -1]]
        ref = phi_bwd_ref(X, F, p, s, t["g"])
    elif name == "gram_fwd":
        out = torch.empty(k2 * k2 + k2 + 2, device=dev)
        work = torch.empty(lib.scfgp_gram_fwd_workspace(n, d, k), device=dev)
        args = [X.data_ptr(), t["y"].data_ptr(), None, F.data_ptr(),
                p.data_ptr(), s.data_ptr(), work.data_ptr(), out.data_ptr()]
        fn = lib.scfgp_gram_fwd_f32
        outs = [out[:k2 * k2].view(k2, k2), out[k2 * k2:k2 * k2 + k2]]
        ref = sufficient_stats_ref(X, t["y"], None, F, p, s)[:2]
    else:
        out = torch.empty(d * k + k + 1, device=dev)
        work = torch.empty(lib.scfgp_gram_bwd_workspace(n, d, k), device=dev)
        args = [X.data_ptr(), t["y"].data_ptr(), None, F.data_ptr(),
                p.data_ptr(), s.data_ptr(), t["cbar"].data_ptr(),
                t["pbar"].data_ptr(), work.data_ptr(), out.data_ptr()]
        fn = lib.scfgp_gram_bwd_f32
        outs = [out[:d * k].view(d, k), out[d * k:d * k + k], out[-1]]
        ref = gram_bwd_ref(X, t["y"], None, F, p, s, t["cbar"], t["pbar"])

    ints = (trials, n, d, k) if name.startswith("phi") else (n, d, k)

    def call():
        rc = fn(*args, *ints, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} failed: cuda error {rc}")
    return call, outs, ref


def run(csrc: Path, kernels, shapes, report) -> None:
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name in kernels:
            libs[name], ptxas = build(csrc, name, Path(tmp))
            report(dict(kernel=name, ptxas=ptxas))
        for shape in shapes:
            if shape in BATCH_SHAPES:
                trials, n, d, k = BATCH_SHAPES[shape]
            else:
                trials, (n, d, k) = None, SHAPES[shape]
            t = inputs(n, d, k, dev, trials)
            for name in kernels:
                if trials is not None and not name.startswith("phi"):
                    continue  # K2f and K2b take no trial axis
                call, outs, ref = call_and_ref(libs[name], name, t, n, d, k,
                                               trials or 1)
                call()
                torch.cuda.synchronize()
                err = [float((a - b).abs().max()) for a, b in zip(outs, ref)]
                first = digest(outs)
                ms = statistics.median(
                    time_fn(call, iters=10, warmup=0,
                            clock="device")["ms_per_call"]
                    for _ in range(REPS))
                report(dict(kernel=name, shape=shape, b=trials or 1, n=n,
                            d=d, k=k, ms=ms, max_abs_err=err,
                            digest=first,
                            kernels=by_kernel(call, PROFILED_CALLS)))
            del t
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=CSRC_DIR)
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS),
                    choices=KERNELS)
    ap.add_argument("--shapes", nargs="*",
                    default=[*SHAPES, *BATCH_SHAPES],
                    choices=[*SHAPES, *BATCH_SHAPES])
    ap.add_argument("--tag", default="", help="copied into every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    head = dict(tag=args.tag, csrc=str(args.csrc),
                device=torch.cuda.get_device_name(0))
    run(args.csrc.resolve(), args.kernels, args.shapes,
        lambda line: print(json.dumps({**head, **line}), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
