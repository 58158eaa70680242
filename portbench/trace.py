"""The traced stretches: ``torch.profiler`` traces of a few units after
the window, and their reduction to what the per-layer readers read.

The first stretch records device activity alone: the device's busy time
over the stretch's length on the host's clock (``busy_s``, ``window_s``)
and the time of each kernel by name.  Recording every host op as well
slows a host-paced step (by ~2x at 6,000 launches a step), so the second
stretch, which records them, gives only what the host's speed does not
move: each kernel's device time and bound, launches, GEMM and NCCL time,
and what the host was doing in each idle gap.

While tracing, each entry point of the port's hand-written kernels is
wrapped in a ``record_function`` span of the benchmark's own
(``portbench.K1f#<i>`` and so on), which also notes the launch's shape.
A device kernel belongs to the span whose host interval holds the runtime
call that launched it (matched by the profiler's correlation id), so a
kernel's device time and its roofline bound come from the same launches.
Nothing of this is installed outside the traced stretch.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import math
import re
from collections import defaultdict

from .work import KERNEL_WORK, bound

# The port's kernel entry points: (module, function, index of Fcat).  X is
# the first argument, (rows, D) or (B, rows, D); K is Fcat's last axis.
KERNEL_ENTRIES = {
    "K1f": ("scfgp_tpu_torch.ops.phi", "_phi_fwd", 1),
    "K1b": ("scfgp_tpu_torch.ops.phi", "_phi_bwd", 1),
    "K2f": ("scfgp_tpu_torch.ops.gram", "_gram_fwd", 3),
    "K2b": ("scfgp_tpu_torch.ops.gram", "_gram_bwd", 3),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GEMM = re.compile(r"gemm|gemv|nvjet|xmma", re.IGNORECASE)
NCCL = re.compile(r"nccl", re.IGNORECASE)
WINDOW = "portbench.window"


@contextlib.contextmanager
def kernel_spans(calls: list):
    """Wrap the port's kernel entry points in spans for the duration;
    ``calls`` receives (kernel, flops, bytes) for each launch."""
    import torch
    saved = []
    for kernel, (mod_name, fn_name, f_arg) in KERNEL_ENTRIES.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def wrapped(*args, _fn=fn, _kernel=kernel, _f=f_arg):
            X, Fcat = args[0], args[_f]
            *lead, n, d = X.shape
            trials = math.prod(lead)
            flops, nbytes = KERNEL_WORK[_kernel](n, d, Fcat.shape[-1])
            calls.append((_kernel, trials * flops, trials * nbytes))
            with torch.profiler.record_function(
                    f"portbench.{_kernel}#{len(calls) - 1}"):
                return _fn(*args)

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


class Reading:
    """What a traced stretch shows: the window, the device's busy time,
    each kernel's device time and bound, launches, GEMM and NCCL time,
    the idle gaps by host op.  ``run.py`` replaces ``busy_s``,
    ``window_s`` and ``by_name`` with the device-only stretch's."""

    def __init__(self, events: list, calls: list, units: int, steps: int):
        self.units, self.steps = units, steps
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the traced stretch has no window span")
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
        kernels = [e for e in dev if e["cat"] == "kernel"]
        self.launches = len(kernels)
        per_device = defaultdict(list)
        for e in dev:
            per_device[e.get("args", {}).get("device", e.get("pid"))].append(
                (max(e["ts"], w0), min(e["ts"] + e["dur"], w1)))
        busy, gaps = [], []
        for spans in per_device.values():
            union = _union(spans)
            busy.append(sum(b - a for a, b in union) * 1e-6)
            gaps.extend(_gaps(union, w0, w1))
        self.devices = max(len(per_device), 1)
        self.busy_s = sum(busy) / self.devices
        # Each kernel to the benchmark span (if any) that launched it.
        owner = _owners(events, calls)
        self.kernel_ms = defaultdict(float)
        self.bound_ms = defaultdict(float)
        self.gemm_ms = self.nccl_ms = 0.0
        self.by_name = defaultdict(float)
        for e in kernels:
            ms = e["dur"] * 1e-3
            self.by_name[e["name"]] += ms * 1e-3
            corr = e.get("args", {}).get("correlation")
            span = owner.get(corr)
            if span is not None:
                self.kernel_ms[calls[span][0]] += ms
            elif NCCL.search(e["name"]):
                self.nccl_ms += ms
            elif GEMM.search(e["name"]):
                self.gemm_ms += ms
        launched = {owner[c] for c in owner}
        for i in launched:
            kernel, flops, nbytes = calls[i]
            self.bound_ms[kernel] += bound(flops, nbytes)[0]
        self.idle_gaps = _label_gaps(gaps, events)

    def roofline_pct(self, kernel):
        t = self.kernel_ms.get(kernel, 0.0)
        if t <= 0.0:
            return None
        return 100.0 * self.bound_ms[kernel] / t

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": self.idle_gaps[:10]}


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(union, w0, w1):
    gaps, t = [], w0
    for a, b in union:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _owners(events, calls):
    """correlation id -> index of the benchmark span whose host interval
    holds the launching runtime call."""
    spans = defaultdict(list)
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(
                "portbench.K") and "#" in name:
            spans[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], int(name.split("#")[1])))
    for v in spans.values():
        v.sort()
    starts = {k: [s[0] for s in v] for k, v in spans.items()}
    owner = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        key = (e["pid"], e["tid"])
        if corr is None or key not in spans:
            continue
        i = bisect.bisect_right(starts[key], e["ts"]) - 1
        if i >= 0 and e["ts"] <= spans[key][i][1]:
            owner[corr] = spans[key][i][2]
    return owner


def _label_gaps(gaps, events):
    """Idle time of the device summed by what the host was doing: the
    innermost host op (or benchmark span) open at each gap's midpoint."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("name") != WINDOW
                  and not e.get("name", "").startswith("portbench.K"))
    starts = [h[0] for h in host]
    total = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "host: python (no op)"
        i = bisect.bisect_right(starts, mid) - 1
        best = None
        # Walk back over ops that started before the midpoint; the
        # innermost one holding it is the latest such start.
        for j in range(i, max(i - 2000, -1), -1):
            s, e, name = host[j]
            if e >= mid:
                best = name
                break
        if best is not None:
            label = best
        total[label] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def read_trace(path: str, calls: list, units: int, steps: int) -> Reading:
    return Reading(_events(path), calls, units, steps)


def device_busy(path: str):
    """(busy_s averaged over the devices, {kernel name: seconds}) of a
    trace of device activity alone, taken without host ops so that the
    profiler adds little to the host's time."""
    per_device, by_name = defaultdict(list), defaultdict(float)
    for e in _events(path):
        if e.get("cat") in DEVICE_CATS:
            per_device[e.get("args", {}).get("device", e.get("pid"))].append(
                (e["ts"], e["ts"] + e["dur"]))
            if e["cat"] == "kernel":
                by_name[e["name"]] += e["dur"] * 1e-6
    busy = [sum(b - a for a, b in _union(v)) * 1e-6
            for v in per_device.values()]
    return (sum(busy) / len(busy) if busy else 0.0), by_name
