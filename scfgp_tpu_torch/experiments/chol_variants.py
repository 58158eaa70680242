"""Where the blocked Cholesky kernels' time goes, by kernel, for a given
``cholesky.cu``, whole or with stages cut out.

    python -m scfgp_tpu_torch.experiments.chol_variants [--source FILE]
        [--drop A-B ...] [--replace OLD NEW ...] [--sizes 64 554 4096]

Builds FILE (default: this package's ``csrc/cholesky.cu``) with the
package's nvcc flags into a temporary directory, after deleting the 1-based,
inclusive line ranges given by ``--drop`` and then replacing each OLD text
(which must occur once; ``\n`` is a newline) by NEW.  One source can so be
timed whole, without a stage or with a change, to see what that costs; a
variant's results may be wrong and are only timed (the line says whether
they stayed finite).  At each n it runs K4 and K3 (``scfgp_chol_f32``,
``scfgp_chol_inv_f32``) on ``spd_input(n)`` and prints one JSON line per
(n, entry): ``ms``, the device time per call (``utils/profiling.py::
time_fn``, the host's enqueue hidden, median of 5), and ``kernels``, each
kernel's launches per call and µs per launch under ``torch.profiler`` over
PROFILED_CALLS calls.  The card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops.build import CSRC_DIR, NVCC_FLAGS, find_nvcc
from ..ops.cholesky import _SIGNATURES
from ..utils.profiling import time_fn
from .chol_crossover import spd_input

ENTRIES = {"k4": "scfgp_chol_f32", "k3": "scfgp_chol_inv_f32"}
PROFILED_CALLS = 5


def edit_source(text: str, drop=(), replace=()) -> str:
    """``text`` without the 1-based inclusive line ranges ``drop``
    ([(a, b)]), then with each ``(old, new)`` of ``replace`` applied
    (``\\n`` in either is a newline).  Raises ``ValueError`` unless each
    ``old`` occurs exactly once."""
    lines = text.splitlines(keepends=True)
    cut = {k for a, b in drop for k in range(a - 1, b)}
    text = "".join(ln for k, ln in enumerate(lines) if k not in cut)
    for old, new in replace:
        old, new = (t.replace("\\n", "\n") for t in (old, new))
        if text.count(old) != 1:
            raise ValueError(f"--replace: {old!r} occurs {text.count(old)} "
                             "times, not once")
        text = text.replace(old, new)
    return text


def build_variant(source: Path, drop, replace, out_dir: Path):
    """Compile ``edit_source`` of ``source`` into ``out_dir``; returns the
    loaded library and ptxas's register lines."""
    src = out_dir / "variant.cu"
    src.write_text(edit_source(source.read_text(), drop, replace))
    so = out_dir / "libvariant.so"
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(source.parent),
                          "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant of {source}:\n"
                           f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, (args, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = restype
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, ptxas


def _kernel_name(key: str) -> str:
    """``diag_kernel`` from ``(anonymous namespace)::diag_kernel(float*...``;
    other events (a memset) keep their key."""
    m = re.search(r"(\w+)\(", key.replace("(anonymous namespace)", ""))
    return m.group(1) if m else key


def by_kernel(fn, calls: int) -> dict:
    """Each kernel's launches per call and µs per launch over ``calls``
    calls of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            out[_kernel_name(e.key)] = dict(
                launches=e.count / calls,
                us=e.self_device_time_total / e.count)
    return out


def run(lib, sizes, report) -> None:
    dev = torch.device("cuda")
    for n in sizes:
        A = spd_input(n, dev)
        outs = {"k4": (torch.empty_like(A),),
                "k3": (torch.empty_like(A), torch.empty_like(A))}
        work = torch.empty(lib.scfgp_chol_workspace(n), dtype=torch.float32,
                           device=dev)
        for entry, fn_name in ENTRIES.items():
            def call(entry=entry, fn_name=fn_name):
                stream = torch.cuda.current_stream().cuda_stream
                rc = getattr(lib, fn_name)(
                    A.data_ptr(), *[t.data_ptr() for t in outs[entry]],
                    work.data_ptr(), n, stream)
                if rc != 0:
                    raise RuntimeError(f"{fn_name} failed: cuda error {rc}")
            call()
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all()) for t in outs[entry])
            ms = statistics.median(
                time_fn(call, iters=3, warmup=0, clock="device")["ms_per_call"]
                for _ in range(5))
            report(dict(n=n, entry=entry, ms=ms, finite=finite,
                        kernels=by_kernel(call, PROFILED_CALLS)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=CSRC_DIR / "cholesky.cu")
    ap.add_argument("--drop", nargs="*", default=[],
                    help="1-based inclusive line ranges A-B to delete")
    ap.add_argument("--replace", nargs=2, action="append", default=[],
                    metavar=("OLD", "NEW"))
    ap.add_argument("--sizes", nargs="*", type=int, default=[64, 554, 4096])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chol_variants: no CUDA device", file=sys.stderr)
        return 1
    drop = [tuple(int(x) for x in r.split("-")) for r in args.drop]
    head = dict(source=str(args.source), drop=args.drop,
                replace=args.replace, device=torch.cuda.get_device_name(0))
    with tempfile.TemporaryDirectory() as tmp:
        lib, ptxas = build_variant(args.source.resolve(), drop,
                                   args.replace, Path(tmp))
        print(json.dumps({**head, "ptxas": ptxas}), flush=True)
        run(lib, args.sizes,
            lambda line: print(json.dumps({**head, **line}), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
