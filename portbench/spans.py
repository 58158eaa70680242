"""The program's own spans in the traced stretch, and the device work each
launched.

The port records a span at each layer boundary (``scfgp.<layer>.<what>``,
``scfgp_tpu_torch/utils/profiling.py::span``) whenever a profiler
records, so the host-and-device trace that ``run.py`` writes holds them
on the clock of the device activity.  The per-layer readers are not given
the cell's name, so this module reads the newest
``traces/*.r<rank>.json`` (not ``.device.json``): the trace of the run
that is reading.

A device operation (kernel, copy or memset) belongs to the innermost
program span whose host interval holds the runtime call that launched it,
matched by the profiler's correlation id, on the launching thread; a
launch on a thread with no program span open (autograd runs a CUDA
backward on a thread of its own) belongs to the innermost span open on
any thread at that instant.  A span's parent is found by the same rule at
its start, and a span's device time holds its descendants'.  Only what
was launched inside the ``portbench.window`` span counts.

A trace with no program span (a program that has none) gives None, and
the harness then leaves the metric out.

    python -m portbench.spans [TRACE] [--steps N]

prints one JSON object: each span name's count, device ms and self ms a
step, the share of device time inside some span, and the device's idle
time by the innermost span open on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

from .trace import DEVICE_CATS, LAUNCH_CATS, WINDOW, _gaps, _union

HERE = Path(__file__).resolve().parent
PREFIX = "scfgp."
HOST_CATS = ("cpu_op", "user_annotation")
NO_SPAN = "(no program span)"


class _Span:
    __slots__ = ("name", "tid", "start", "end", "parent")

    def __init__(self, name, tid, start, end):
        self.name, self.tid, self.start, self.end = name, tid, start, end
        self.parent = None


class _Open:
    """The program spans open at a point that moves forward in time."""

    def __init__(self, spans):
        self.spans, self.next, self.open = spans, 0, []

    def at(self, t, tid):
        """The innermost span open at ``t`` on thread ``tid``, else on any
        thread; None where none is."""
        while self.next < len(self.spans) and self.spans[self.next].start <= t:
            self.open.append(self.spans[self.next])
            self.next += 1
        self.open = [s for s in self.open if s.end >= t]
        pool = [s for s in self.open if s.tid == tid] or self.open
        return max(pool, key=lambda s: s.start) if pool else None


class SpanReading:
    """The device work of a traced stretch by program span."""

    def __init__(self, events: list, base_ns: int = 0):
        self.base_ns = base_ns
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        self.w0, self.w1 = ((win[0]["ts"], win[0]["ts"] + win[0]["dur"])
                            if win else (float("-inf"), float("inf")))
        spans = sorted(
            (_Span(e["name"], (e["pid"], e["tid"]), e["ts"],
                   e["ts"] + e["dur"]) for e in events
             if e.get("cat") in HOST_CATS
             and e.get("name", "").startswith(PREFIX)),
            key=lambda s: (s.start, -s.end))
        opened = []
        for s in spans:
            # Only spans before this one in (start, -end) order may hold it.
            opened = [o for o in opened if o.end >= s.start]
            own = [o for o in opened if o.tid == s.tid]
            pool = own or opened
            s.parent = max(pool, key=lambda o: o.start) if pool else None
            opened.append(s)
        self.spans = spans
        launch = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launch[corr] = (e["ts"], (e["pid"], e["tid"]))
        work = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            at = launch.get(e.get("args", {}).get("correlation"))
            t = at[0] if at is not None else e["ts"]
            if self.w0 <= t <= self.w1:
                work.append((t, at, e))
        work.sort(key=lambda w: w[0])
        scan = _Open(spans)
        self.count = defaultdict(int)
        for s in spans:
            self.count[s.name] += 1
        self.ms, self.self_ms = defaultdict(float), defaultdict(float)
        self.device_ms = self.covered_ms = 0.0
        busy = []
        for t, at, e in work:
            ms = e.get("dur", 0.0) * 1e-3
            self.device_ms += ms
            busy.append((max(e["ts"], self.w0), min(e["ts"] + e.get(
                "dur", 0.0), self.w1)))
            owner = scan.at(t, at[1]) if at is not None else None
            if owner is None:
                continue
            self.covered_ms += ms
            self.self_ms[owner.name] += ms
            names, s = set(), owner
            while s is not None:
                names.add(s.name)
                s = s.parent
            for name in names:
                self.ms[name] += ms
        self._busy = _union(busy)

    def idle_by_span(self) -> list:
        """[label, seconds] of the device's idle time in the window, each
        gap labelled by the innermost program span open on the host at its
        midpoint, largest first."""
        if not self._busy:
            return []
        w0 = self.w0 if self.w0 > float("-inf") else self._busy[0][0]
        w1 = self.w1 if self.w1 < float("inf") else self._busy[-1][1]
        total = defaultdict(float)
        scan = _Open(self.spans)
        for a, b in _gaps(self._busy, w0, w1):
            s = scan.at(0.5 * (a + b), None)
            total[s.name if s is not None else NO_SPAN] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])

    def in_window(self, start_ns: int) -> bool:
        """Whether a store record's start lies in the window."""
        t = (start_ns - self.base_ns) * 1e-3
        return self.w0 <= t <= self.w1


def load(path) -> SpanReading | None:
    """The reading of a chrome trace; None if it holds no program span."""
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    reading = SpanReading(events, int(doc.get("baseTimeNanoseconds", 0)))
    return reading if reading.spans else None


def _rank() -> int:
    import torch
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def latest_trace(folder=HERE / "traces", rank=None):
    """The newest host-and-device trace of ``rank`` (this process's)."""
    rank = _rank() if rank is None else rank
    paths = [p for p in Path(folder).glob(f"*.r{rank}.json")
             if not p.name.endswith(".device.json")]
    return max(paths, key=lambda p: p.stat().st_mtime) if paths else None


_cache: dict = {}


def current() -> SpanReading | None:
    """The reading of the newest trace, parsed once per file."""
    path = latest_trace()
    if path is None:
        return None
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _cache:
        _cache.clear()
        _cache[key] = load(path)
    return _cache[key]


def device_ms(name: str):
    """A reader: device ms a step (or draw) of the work launched inside
    the spans ``name``, their descendants' included."""
    def read(reading, run):
        spans = current()
        if spans is None or not spans.count.get(name) or not reading.steps:
            return None
        return spans.ms[name] / reading.steps
    return read


def store_gb_per(copy: str, unit: str):
    """A reader: Σ ``bytes`` of the program's store records ``copy`` in
    the window, in GB, over the count of its ``unit`` records there."""
    def read(reading, run):
        try:
            from scfgp_tpu_torch.utils.profiling import spans as records
        except ImportError:
            return None
        spans = current()
        if spans is None:
            return None
        nbytes, units = 0, 0
        for r in records():
            if not spans.in_window(r.start_ns):
                continue
            if r.name == copy:
                nbytes += r.attrs.get("bytes", 0)
            elif r.name == unit:
                units += 1
        return nbytes / units / 1e9 if units else None
    return read


def summary(reading: SpanReading, steps: int = 1) -> dict:
    names = sorted(reading.count, key=lambda n: -reading.ms[n])
    return {
        "steps": steps,
        "device_ms": reading.device_ms / steps,
        "covered_pct": (100.0 * reading.covered_ms / reading.device_ms
                        if reading.device_ms else None),
        "spans": {n: {"count": reading.count[n] / steps,
                      "ms": reading.ms[n] / steps,
                      "self_ms": reading.self_ms[n] / steps}
                  for n in names},
        "idle_s": [[k, v / steps] for k, v in reading.idle_by_span()],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", nargs="?", help="default: the newest of rank 0")
    ap.add_argument("--steps", type=int, default=1,
                    help="units x steps a unit in the traced stretch")
    args = ap.parse_args(argv)
    path = args.trace or latest_trace(rank=0)
    if path is None:
        print("portbench.spans: no trace", file=sys.stderr)
        return 1
    reading = load(path)
    if reading is None:
        print(f"portbench.spans: no program span in {path}", file=sys.stderr)
        return 1
    print(json.dumps(summary(reading, args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
