"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is ``portbench/workloads/<cell>.json``: its configuration
(``configs/<name>.json``), its chips, its traffic parameters, its driver
(``drivers/<kind>.py``), the end-to-end metric it reports and the limits
of its correctness numbers.  The per-layer metrics a traced run reports
are those ``BENCHMARK.json`` lists for the cell, each read by
``metrics/<metric>.py``.

A run: set-up (imports, the card, data and params from the seed, the
driver's warm-up of the cell's own shapes), then units of work until
``--seconds`` have passed on the host's clock, synchronised at the end;
the rate is the work of every unit over the whole window.  With
``--trace 1`` a few more units then run under ``torch.profiler``, and the
per-layer metrics are read from that trace.  Then the program's state is
freed and the plain reference checks what the timed path produced.  The
last line of standard output is one JSON object.

The run needs the card: without CUDA, or with fewer cards than the cell
asks for, it exits 3 and prints no result.  It exits 4, with no result, if
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "scfgp_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str):
    """``metrics/<name>.py`` (the name may hold dots) as a module."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: dict) -> tuple:
    """(end-to-end, per-layer) entries of ``BENCHMARK.json`` this cell
    reports."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    name, e2e_name = cell["name"], cell["metric"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])
           and m["name"] in (e2e_name, "setup_s")]
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] == e2e_name)]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trace(sess, workload, tunits, dev, rank):
    """``tunits`` more units under the profiler, twice: device activity
    alone (busy time, the stretch's length, kernels by name), then with
    host ops and the kernel spans (``trace.py``)."""
    import torch

    from .trace import device_busy, kernel_spans, read_trace

    folder = HERE / "traces"
    folder.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    busy_s, by_name, window_s = 0.0, {}, 0.0
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        path = folder / f"{workload}.r{rank}.device.json"
        with torch.profiler.profile(activities=acts[1:]) as prof:
            t1 = time.perf_counter()
            for _ in range(tunits):
                sess.unit()
            _sync(dev)
            window_s = time.perf_counter() - t1
        prof.export_chrome_trace(str(path))
        busy_s, by_name = device_busy(str(path))
    calls = []
    path = folder / f"{workload}.r{rank}.json"
    with kernel_spans(calls), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.window"):
            for _ in range(tunits):
                sess.unit()
            _sync(dev)
    prof.export_chrome_trace(str(path))
    reading = read_trace(str(path), calls, tunits,
                         tunits * sess.steps_per_unit)
    reading.busy_s, reading.window_s = busy_s, window_s
    reading.by_name = by_name
    return reading


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, overrides=None, fault=None, log=sys.stderr) -> dict:
    """One run of a cell; returns the result object.  ``device``,
    ``overrides`` (keys of the configuration and traffic to change) and
    ``fault`` serve the CPU tests and the calibration, never the
    command line."""
    import torch

    from . import check

    cell = load_json("workloads", workload)
    cfg = dict(load_json("configs", cell["config"]))
    mix = dict(cell["traffic"])
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else mix)[key] = value
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    world, rank = 1, 0
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        rank = torch.distributed.get_rank()
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.reset_peak_memory_stats(dev)
    ctx = SimpleNamespace(config=cfg, traffic=mix, seed=int(seed),
                          device=dev, fault=fault, chips=cell["chips"],
                          world=world, rank=rank)
    t_imports = time.perf_counter() - T_START
    sess = driver.setup(ctx)
    _sync(dev)
    setup_s = time.perf_counter() - T_START
    print(f"portbench: set-up {setup_s:.3f} s, of it imports and the card "
          f"{t_imports:.3f} s", file=log)

    # On several cards every rank runs the same count of units: rank 0's
    # estimate from one more warm unit, so that the window lasts about
    # --seconds with no agreement inside it.
    planned = None
    if ctx.world > 1:
        t1 = time.perf_counter()
        sess.unit()
        _sync(dev)
        est = torch.tensor([time.perf_counter() - t1], device=dev)
        torch.distributed.broadcast(est, 0)
        planned = max(1, math.ceil(seconds / float(est)))
        setup_s = time.perf_counter() - T_START
    units = 0
    t0 = time.perf_counter()
    while True:
        sess.unit()
        units += 1
        if planned is not None:
            if units >= planned:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window = time.perf_counter() - t0
    rate = units * sess.work_per_unit / window

    reading = (_trace(sess, workload, int(mix.get("trace_units", 1)),
                      dev, rank) if trace else None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    failed = sess.failed()
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=log)
        raise SystemExit(4)

    sess.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = sess.readings()
    correct, rows = check.judge(numbers, cell["limits"])

    e2e, layer = cell_metrics(cell)
    metrics = {}
    if not trace:
        values = {cell["metric"]: rate, "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run_info = SimpleNamespace(
            session=sess, steps_per_s=units * sess.steps_per_unit / window,
            rate=rate, chips=cell["chips"])
        for m in layer:
            value = load_metric(m["name"]).read(reading, run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": units,
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if reading is not None:
        result["device"]["busy_s"] = reading.busy_s
        result["device"]["window_s"] = reading.window_s
        result["breakdown"] = reading.breakdown()
    result["checks"] = rows
    return result


def _rank_run(workload, seed, seconds, trace, t_start, device=None,
              overrides=None, fault=None):
    """One rank of a cell on several cards (``launch.run`` calls it in each
    spawned process, joined into one process group): its set-up is timed
    from the parent's start."""
    global T_START
    T_START = t_start
    return run(workload, seed, seconds, trace, device, overrides, fault)


def merge(results: list) -> dict:
    """The result of a cell on several cards: rank 0's metrics and
    checks, the peak memory of the fullest card, the busy time averaged
    over the cards."""
    out = results[0]
    out["device"]["memory_peak_bytes"] = max(
        r["device"]["memory_peak_bytes"] for r in results)
    if "busy_s" in out["device"]:
        out["device"]["busy_s"] = sum(
            r["device"]["busy_s"] for r in results) / len(results)
    checks = out.pop("checks")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    cell = load_json("workloads", args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    if cell["chips"] > 1:
        from scfgp_tpu_torch.parallel import launch
        result = merge(launch.run(
            _rank_run, cell["chips"], args.workload, args.seed,
            args.seconds, bool(args.trace), T_START, timeout=330.0))
    else:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"portbench: run {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
