"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size, in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1 2 ...
        [--control-seeds 1 2 3] [--faults frozen half] [--fault-seeds 4 5 6]
        [--units 4] [--out FILE]

For each seed: the cell's set-up (the program's first steps through the
timed call), ``--units`` units of the timed work, the program's state
freed, then its numbers against the reference (the lower readings).  For
each control seed, the same session also gives the control's numbers: the
reference in TF32 put in the program's place (the upper readings).  For
each fault and fault seed, a session with the fault planted in the
program's feed (``half``: half the rows, the mean over the rest) or in its
update (``frozen``: the state left unchanged).  One JSON line a reading;
the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from types import SimpleNamespace

from .run import load_json


def session(cell, seed, dev, fault=None):
    import torch.distributed as dist
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    ctx = SimpleNamespace(config=load_json("configs", cell["config"]),
                          traffic=dict(cell["traffic"]), seed=seed,
                          device=dev, fault=fault, chips=cell["chips"],
                          world=world, rank=rank)
    return driver.setup(ctx)


def readings(workload, plan, control_seeds, units, detail_on):
    """The plan's readings in this process (or rank): a list of
    (seed, kind, numbers, seconds)."""
    import torch
    dev = torch.device("cuda", torch.cuda.current_device())
    cell = load_json("workloads", workload)
    rows = []
    for seed, fault in plan:
        t0 = time.perf_counter()
        sess = session(cell, seed, dev, fault)
        for _ in range(units):
            sess.unit()
        torch.cuda.synchronize()
        sess.release()
        gc.collect()
        torch.cuda.empty_cache()
        detail = [] if detail_on else None
        numbers = (sess.readings(detail=detail) if detail is not None
                   else sess.readings())
        got = [("fault:" + fault if fault else "program", numbers)]
        if detail:
            got.append(("detail", _detail(detail)))
        if fault is None and seed in control_seeds:
            cdet = [] if detail_on else None
            got.append(("control:tf32", sess.control_readings(detail=cdet)
                        if cdet is not None else sess.control_readings()))
            if cdet:
                got.append(("control_detail", _detail(cdet)))
        rows += [(seed, kind, n, time.perf_counter() - t0)
                 for kind, n in got]
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _detail(detail: list) -> dict:
    """Each leaf's gaps, and which leaves the change counts."""
    return dict(detail[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--detail", action="store_true",
                    help="also each leaf's gaps (training cells)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_json("workloads", args.workload)
    plan = [(s, None) for s in args.seeds]
    plan += [(s, f) for f in args.faults for s in args.fault_seeds]
    call = (args.workload, plan, args.control_seeds, args.units, args.detail)
    if cell["chips"] > 1:
        from scfgp_tpu_torch.parallel import launch
        rows = launch.run(readings, cell["chips"], *call,
                          timeout=3000.0)[0]
    else:
        rows = readings(*call)
    out = open(args.out, "a") if args.out else None
    for seed, kind, numbers, secs in rows:
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "kind": kind, "numbers": numbers, "s": secs})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
