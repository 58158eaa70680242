"""The precision policy measured on the card: speed and quality of TF32
GEMMs against IEEE float32, and the co2 composite.

Port of ``experiments/tpu_precision_quality.py``.  ``mm_precision=
"default"`` runs the objective's Gram and Φ·L⁻ᵀ GEMMs, forward and
backward, in TF32 on the card (``ops/dispatch.py``); ``None`` keeps them
IEEE.  Three parts, same seeds and splits in every leg:

1. speed at the bench cell (N=8192, D=8, S=50, M=200, adam lr 0.01, 50
   steps a run): steps/s with the two GEMMs in TF32 ("default"), in IEEE
   ("highest"), with TF32 switched on for every float32 GEMM of the step
   (``global_tf32``) and with none (``global_ieee``); CUDA events, the
   median of 3 runs taken in turns over the legs, and the device ms a
   step of one profiled run;
2. quality: boston, abalone and kin8nm under None and "default", T trials
   each (seed and split = the trial), at the JAX configs
   (``experiments/tpu_precision_quality.py:101-109``): mean and std of
   NMSE and MNLP, and the JAX package's criterion
   (``scfgp_tpu/ops/dispatch.py:103-111``): TF32 is neutral for a class
   when the mean NMSE of "default" minus that of None lies within one
   trial standard deviation (of the IEEE leg's NMSE);
3. the co2 composite: {raw, orthonormalised basis} x {IEEE, TF32}, NMSE
   and MNLP, and NMSE over the surrogate's Bayes floor.

    python -m scfgp_tpu_torch.experiments.precision_quality [--trials 5]
        [--co2-bases raw,ortho] [--skip-speed] [--cpu] [--out DIR]

Prints one JSON line a part and writes ``<out>/precision_quality.json``
(default ``scfgp_tpu_torch/experiments/results/precision/``).
``--co2-bases ""`` skips the co2 legs.  On the card unless ``--cpu``; the
record names the device, and on the card its name and power limit
(nvidia-smi).
"""

import argparse
import json
import math
import os
import statistics
import subprocess

import numpy as np
import torch

from ..data.datasets import (load_abalone, load_boston, load_co2,
                             load_kin8nm, surrogate_floor)
from ..data.scaler import Scaler
from ..models.model import SCFGP
from ..models.objective import loss_and_grad
from ..models.params import init_params
from ..opt.optimizers import make_optimizer, tree_add
from ..ops.dispatch import matmul_tf32
from ..utils.profiling import kernel_profile, time_fn
from .boston_housing import RESULTS
from .co2 import ADAMAX, seasonal_trend_basis

# The bench cell of ``bench.py:62-69``.
BENCH = dict(N=8192, D=8, S=50, M=200, steps=50)
# (loader, model, fit) of ``experiments/tpu_precision_quality.py:101-109``.
QUALITY = {
    "boston": (load_boston, dict(sparsity=20, nfeats=50),
               dict(max_iter=500, obj="SCORE")),
    "abalone": (load_abalone, dict(sparsity=20, nfeats=56),
                dict(max_iter=200, obj="SCORE")),
    "kin8nm": (load_kin8nm, dict(sparsity=-1, nfeats=212),
               dict(max_iter=200, obj="SCORE")),
}
# The two legs: IEEE (the port's arithmetic without the policy) and TF32.
LEGS = {"highest": None, "default": "default"}
CO2_FIT = dict(obj="cost", max_iter=1000, max_cvrg=60, algo=ADAMAX)


def device_record(device) -> dict:
    """Where the numbers were taken: the device and, on the card, its name
    and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.splitlines()[0]}


def timed_legs(runs, steps, iters=1, turns=3):
    """``{leg: {"steps_per_s", "device_ms_per_step"}}`` of ``runs`` (each a
    ``run()`` of ``steps`` steps): after one warm-up run each, ``turns``
    turns over the legs, forward then backward (a, b, b, a, ...), each
    timing ``iters`` runs by CUDA events on the card (host work included,
    as a caller sees it) or by the host clock on the CPU; the median turn,
    and the device time of one profiled run."""
    clock = "call" if torch.cuda.is_initialized() else "host"
    for run in runs.values():
        run()
    rates = {leg: [] for leg in runs}
    for turn in range(turns):
        for leg in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            ms = time_fn(runs[leg], iters=iters, warmup=0,
                         clock=clock)["ms_per_call"]
            rates[leg].append(steps * 1e3 / ms)
    return {leg: {"steps_per_s": statistics.median(rates[leg]),
                  "turns": rates[leg],
                  "device_ms_per_step": (
                      kernel_profile(run, warmup=0)["device_ms"] / steps
                      if clock == "call" else None)}
            for leg, run in runs.items()}


def bench_run(device, mm_dtype=None, mm_precision=None, steps=50, N=8192,
              D=8, S=50, M=200):
    """``run()``: ``steps`` adam steps of the objective at (N, D, S, M), on
    data and params from seed 0, the state carried from call to call."""
    rng = np.random.RandomState(0)
    X = torch.as_tensor(rng.rand(N, D), dtype=torch.float32, device=device)
    y = torch.as_tensor(np.sin(rng.rand(N) * 6) + 0.1 * rng.randn(N),
                        dtype=torch.float32, device=device)
    p0 = init_params(torch.Generator().manual_seed(0), D, S, M)
    params = type(p0)(*[t.to(device) for t in p0])
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    state = [params, tx.init(params)]

    def run():
        p, st = state
        for _ in range(steps):
            (_, _), g = loss_and_grad(p, X, y, mm_dtype=mm_dtype,
                                      mm_precision=mm_precision)
            d, st = tx.update(g, st, p)
            p = tree_add(p, d)
        state[:] = [p, st]
    return run


def bench_speed_legs(device) -> dict:
    """Bench-cell steps/s and device ms a step: the two GEMMs in TF32
    ("default") or IEEE ("highest"), and every float32 GEMM of the step in
    TF32 (the switch on around the whole run) or in IEEE."""
    steps = BENCH["steps"]
    cell = {k: BENCH[k] for k in ("N", "D", "S", "M")}
    tf32_all = bench_run(device, steps=steps, **cell)

    def global_tf32():
        with matmul_tf32(True):
            tf32_all()
    return timed_legs({
        "perdot_default": bench_run(device, mm_precision="default",
                                    steps=steps, **cell),
        "perdot_highest": bench_run(device, mm_precision="highest",
                                    steps=steps, **cell),
        "global_tf32": global_tf32,
        "global_ieee": bench_run(device, steps=steps, **cell)}, steps)


def quality_matrix(trials, device) -> dict:
    """Each class's fits under IEEE and TF32, T trials, and the verdict of
    the JAX package's criterion."""
    out = {}
    for name, (loader, model_kw, fit_kw) in QUALITY.items():
        legs = {leg: {"NMSE": [], "MNLP": []} for leg in LEGS}
        for rep in range(trials):
            Xt, yt, Xv, yv, _ = loader(seed=rep)
            for leg, precision in LEGS.items():
                m = SCFGP(seed=rep, mm_precision=precision, device=device,
                          **model_kw)
                m.fit_fast(Xt, yt, Xv, yv, **fit_kw)
                for k in ("NMSE", "MNLP"):
                    legs[leg][k].append(float(m.evals[k][1][m.min_obj_ind]))
        rec = {leg: {k: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                         "trials": v} for k, v in vals.items()}
               for leg, vals in legs.items()}
        for k in ("NMSE", "MNLP"):
            rec["delta_" + k.lower()] = (rec["default"][k]["mean"]
                                         - rec["highest"][k]["mean"])
        rec["neutral"] = bool(abs(rec["delta_nmse"])
                              <= rec["highest"]["NMSE"]["std"])
        out[name] = rec
        print(json.dumps({"quality": name, **rec}), flush=True)
    return out


def co2_composite_matrix(device, bases=("raw", "ortho")) -> dict:
    """The co2 composite with its basis raw or orthonormalised (QR of the
    train split's basis block in the model's min-max-scaled time, columns
    at unit RMS: the same span), under IEEE and TF32."""
    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    omega = 2 * math.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0
    raw = seasonal_trend_basis(omega)
    sc = Scaler("min-max")
    sc.fit(Xt)
    B = raw(sc.forward_transform(torch.as_tensor(Xt)).double()).numpy()
    _, R = np.linalg.qr(B)
    Rinv = np.linalg.inv(R) * math.sqrt(B.shape[0])

    def ortho(Xs):
        return raw(Xs) @ torch.as_tensor(Rinv, dtype=Xs.dtype,
                                         device=Xs.device)

    floor = (surrogate_floor("co2", Xv, yv)["NMSE"]
             if meta["source"] == "synthetic-surrogate" else None)
    out = {}
    for basis_name in bases:
        for leg, precision in LEGS.items():
            m = SCFGP(sparsity=10, nfeats=20, seed=0,
                      X_scaling_method="min-max", y_scaling_method="normal",
                      extra_basis={"raw": raw, "ortho": ortho}[basis_name],
                      mm_precision=precision, device=device)
            m.fit_fast(Xt, yt, Xv, yv, **CO2_FIT)
            nmse = float(m.evals["NMSE"][1][m.min_obj_ind])
            rec = {"NMSE": nmse,
                   "MNLP": float(m.evals["MNLP"][1][m.min_obj_ind]),
                   "iterations": len(m.evals["COST"][1])}
            if floor is not None:
                rec["floor_nmse"] = floor
                rec["nmse_over_floor"] = (nmse / floor if math.isfinite(nmse)
                                          else None)
            out[f"{basis_name}_{leg}"] = rec
            print(json.dumps({"co2": f"{basis_name}_{leg}", **rec}),
                  flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--co2-bases", default="raw,ortho",
                    help="comma-separated subset of raw,ortho; empty skips")
    ap.add_argument("--skip-speed", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("precision_quality: no CUDA device (use --cpu)")
    rec = {**device_record(device), "trials": args.trials}
    if not args.skip_speed:
        rec["speed_bench_cell"] = bench_speed_legs(device)
        print(json.dumps({"speed": rec["speed_bench_cell"]}), flush=True)
    rec["quality"] = quality_matrix(args.trials, device)
    rec["default_neutral"] = all(q["neutral"]
                                 for q in rec["quality"].values())
    print(json.dumps({"default_neutral": rec["default_neutral"]}),
          flush=True)
    bases = [b for b in args.co2_bases.split(",") if b]
    rec["co2_composite"] = co2_composite_matrix(device, bases)
    out = args.out or os.path.join(RESULTS, "precision")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "precision_quality.json"), "w") as f:
        json.dump(rec, f, indent=2)
    return rec


if __name__ == "__main__":
    main()
