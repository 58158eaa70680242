"""Weak scaling of data-parallel train steps a second over rank counts.

Port of ``experiments/synthetic_scaling.py``.  Rows of X are split over a
1-D ``data`` mesh of W ranks (``parallel/launch.py``), the sufficient
statistics and the expected-NLL sum are all-reduced, and the time of
``--steps`` DP train steps (loss, gradient, adam) is taken at W = 1, 2,
4, ... ranks with ``--rows-per-device`` rows a rank (weak scaling: the
rows a rank stay constant), at the JAX driver's defaults (8192 rows a
rank, D=64, S=50, M=200, 30 steps).  Data are made with
``RandomState(0)`` as the JAX driver makes them.

Ranks that share a card (more ranks than cards) join over gloo and take
turns on that card: their steps/s is no scaling result, and each point
says so (``shared_card``).

    python -m scfgp_tpu_torch.experiments.synthetic_scaling [--ranks 1 2]
        [--rows-per-device 8192] [--dim 64] [--sparsity 50]
        [--nfeats 200] [--steps 30] [--cpu] [--out DIR]

One JSON line a point, with each rank's kernel launches in its timed
steps; writes ``<out>/weak_scaling.json`` (default
``scfgp_tpu_torch/experiments/results/scaling/``).  On the card unless
``--cpu``; the default ranks are 1, 2, 4, ... up to the cards there are
(on the CPU, up to 8).
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from .boston_housing import RESULTS


def scaling_rank(cfg: dict) -> dict:
    """One rank's point: ``cfg["steps"]`` DP train steps, timed after one
    warm-up step, with every kernel's launches in the timed steps."""
    import torch.distributed as dist
    from ..models.params import init_params
    from ..ops.cholesky import cholesky_cuda, cholesky_inverse_cuda
    from ..ops.gram import sufficient_stats_bwd_cuda, sufficient_stats_cuda
    from ..ops.phi import fourier_features_bwd_cuda, fourier_features_cuda
    from ..opt.optimizers import make_optimizer
    from ..parallel import launch, make_dp_train_step, make_mesh, shard_rows

    dev = torch.device(cfg["device"])
    W = dist.get_world_size()
    D, S, M = cfg["dim"], cfg["sparsity"], cfg["nfeats"]
    N = cfg["rows_per_device"] * W
    rng = np.random.RandomState(0)
    X = rng.rand(N, D).astype(np.float32)
    y = rng.randn(N).astype(np.float32)
    mesh = make_mesh()
    Xs, ys, ws = shard_rows(mesh, X, y, device=dev)
    p0 = init_params(torch.Generator().manual_seed(0), D, S, M)
    params = type(p0)(*(t.to(dev) for t in p0))
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    step = make_dp_train_step(tx, mesh)
    state = tx.init(params)
    params, state, cost, _ = step(params, state, Xs, ys, ws)  # warm-up

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    sync()
    dist.barrier()
    kernels = {"phi_fwd": fourier_features_cuda,
               "phi_bwd": fourier_features_bwd_cuda,
               "gram_fwd": sufficient_stats_cuda,
               "gram_bwd": sufficient_stats_bwd_cuda,
               "cholesky": cholesky_cuda,
               "cholesky_inverse": cholesky_inverse_cuda}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(cfg["steps"]):
        params, state, cost, _ = step(params, state, Xs, ys, ws)
    sync()
    dt = time.perf_counter() - t0
    return {"rank": dist.get_rank(), "steps_per_s": cfg["steps"] / dt,
            "seconds": dt, "cost": float(cost),
            "backend": launch.backend_for(cfg["device"], W),
            "launches": {name: fn.launches for name, fn in kernels.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=None)
    ap.add_argument("--rows-per-device", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--sparsity", type=int, default=50)
    ap.add_argument("--nfeats", type=int, default=200)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo) instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    from ..parallel import launch

    device = "cpu" if args.cpu else "cuda"
    cards = 0 if args.cpu else torch.cuda.device_count()
    if not args.cpu and not cards:
        raise RuntimeError("synthetic_scaling: CUDA is not available; "
                           "pass --cpu")
    ranks = args.ranks
    if ranks is None:
        top = cards if cards else 8
        ranks = [1 << i for i in range(top.bit_length()) if 1 << i <= top]
    cfg = {"device": device, "rows_per_device": args.rows_per_device,
           "dim": args.dim, "sparsity": args.sparsity,
           "nfeats": args.nfeats, "steps": args.steps}
    report = {"config": dict(cfg, ranks=ranks,
                             card=torch.cuda.get_device_name(0)
                             if cards else None), "points": []}
    print(json.dumps(report["config"]), flush=True)
    base = None
    for W in ranks:
        res = launch.run(scaling_rank, W, cfg, device=device,
                         threads=1 if args.cpu else 0)
        rate = res[0]["steps_per_s"]
        base = rate if base is None else base
        point = {"ranks": W, "rows_total": args.rows_per_device * W,
                 "steps_per_s": rate, "weak_scaling_efficiency": rate / base,
                 "backend": res[0]["backend"],
                 "shared_card": device == "cuda" and W > cards,
                 "launches": [r["launches"] for r in res],
                 "costs_equal": len({r["cost"] for r in res}) == 1}
        if point["shared_card"]:
            point["note"] = (f"{W} ranks share {cards} card(s): the steps/s "
                             "is no scaling result")
        report["points"].append(point)
        print(json.dumps(point), flush=True)
    out = args.out or os.path.join(RESULTS, "scaling")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "weak_scaling.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
