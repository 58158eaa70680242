"""Config-driven run CLI: ``python -m scfgp_tpu_torch [--config cfg.json]``.

Port of ``scfgp_tpu/run.py:47-182``, with the same flags, config-file keys
and branches: a JSON config (or flags) selects the dataset, the model and
the training knobs; the run prints one JSON line of final metrics and can
write a checkpoint and a JSONL metric log.  Config file keys map onto
``config.ModelConfig`` / ``config.TrainConfig``:

    {"dataset": "kin8nm", "model": {"sparsity": 20, "nfeats": 50},
     "train": {"max_iter": 200, "fused": true}, "seed": 0}

The model lives on the card unless ``--cpu`` is given; without a card and
without ``--cpu`` the run raises, it does not fall back to the CPU.  The
CLI only drives: its metrics are those of the direct ``SCFGP`` call with
``TrainConfig.as_optimize_kwargs()``.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os

from .config import ModelConfig, OptimizerConfig, TrainConfig, make_model

# optimize() arguments that the fused loop and the ensemble do not take.
_HOST_LOOP_ONLY = ("nbatches", "batchsize", "log_file")


def _build(cfg_cls, d: dict):
    names = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = set(d) - names
    if unknown:
        raise SystemExit(f"unknown {cfg_cls.__name__} keys: {sorted(unknown)}")
    return cfg_cls(**d)


def load_dataset(name: str, seed=None):
    from .data import datasets
    loaders = {"boston": datasets.load_boston,
               "boston_housing": datasets.load_boston,
               "abalone": datasets.load_abalone,
               "kin8nm": datasets.load_kin8nm,
               "co2": datasets.load_co2}
    if name in loaders:
        return loaders[name](seed=seed)
    raise SystemExit(f"unknown dataset '{name}' "
                     f"(choose from {sorted(loaders)})")


def _fit_bayes(model, raw, args, data):
    """The ``--bayes`` branch: ``fit_bayes`` with the config's ``bayes``
    keys (``true`` or a dict, validated against its signature) and the
    flags; returns the result's ``bayes`` record."""
    raw_b = raw.get("bayes")
    bcfg = dict(raw_b) if isinstance(raw_b, dict) else {}
    allowed = set(inspect.signature(model.fit_bayes).parameters) - {
        "X", "y", "Xv", "yv"}
    unknown = set(bcfg) - allowed
    if unknown:
        raise SystemExit(f"unknown bayes config keys: {sorted(unknown)} "
                         f"(allowed: {sorted(allowed)})")
    if args.bayes:
        bcfg["sampler"] = args.bayes
    bcfg.setdefault("sampler", "hmc")
    bcfg.setdefault("chains", args.chains)
    bcfg.setdefault("num_samples", args.samples)
    bcfg.setdefault("num_warmup", args.warmup)
    model.fit_bayes(*data, **bcfg)
    res = model.bayes_result
    info = {"sampler": bcfg["sampler"],
            "accept_rate": round(float(res.accept_rate), 3),
            "draws": int(model.thetas.shape[0])}
    if hasattr(res, "swap_rate"):
        info["swap_rate"] = round(float(res.swap_rate), 4)
    diag = model.bayes_diagnostics
    if diag is not None:
        wall = model.bayes_diagnostics_wall
        info.update(
            max_rhat=round(diag.max_rhat, 4),
            min_ess_bulk=round(diag.min_ess_bulk, 1),
            min_ess_tail=round(diag.min_ess_tail, 1),
            min_ess_bulk_per_s=round(diag.min_ess_bulk / max(wall, 1e-9), 2),
            divergences=diag.divergences)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m scfgp_tpu_torch",
        description="Train an SCFGP model from a typed config.")
    ap.add_argument("--config", help="JSON config file")
    ap.add_argument("--dataset", default=None,
                    help="boston|abalone|kin8nm|co2 (overrides config)")
    ap.add_argument("--sparsity", type=int, default=None)
    ap.add_argument("--nfeats", type=int, default=None)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--fused", action="store_true",
                    help="early-stopping loop on the device (fit_fast)")
    ap.add_argument("--ensemble", type=int, default=None,
                    help="deep-ensemble fit: K restarts trained as one "
                         "batch, GP-mixture prediction (fit_ensemble)")
    ap.add_argument("--mix-best", type=int, default=None,
                    help="with --ensemble: mix only the J best members by "
                         "the validation objective")
    ap.add_argument("--bayes", choices=["hmc", "nuts", "tempered", "vi"],
                    default=None,
                    help="sample the hyperparameter posterior instead of "
                         "MAP training; metrics use the posterior-"
                         "predictive mixture")
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="output dir for checkpoint + metrics JSONL")
    args = ap.parse_args(argv)

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    model_d = dict(raw.get("model", {}))
    train_d = dict(raw.get("train", {}))
    opt_d = train_d.pop("optimizer", {})
    if args.sparsity is not None:
        model_d["sparsity"] = args.sparsity
    if args.nfeats is not None:
        model_d["nfeats"] = args.nfeats
    if args.seed is not None:
        model_d["seed"] = args.seed
    if args.max_iter is not None:
        train_d["max_iter"] = args.max_iter
    if args.fused:
        train_d["fused"] = True
    dataset = args.dataset or raw.get("dataset")
    if not dataset:
        raise SystemExit("no dataset: pass --dataset or 'dataset' in config")

    mcfg = _build(ModelConfig, model_d)
    tcfg = _build(TrainConfig, train_d)
    tcfg.optimizer = _build(OptimizerConfig, opt_d)

    Xt, yt, Xv, yv, meta = load_dataset(dataset, seed=mcfg.seed)
    model = make_model(mcfg, device="cpu" if args.cpu else "cuda")

    kwargs = tcfg.as_optimize_kwargs()
    out_dir = args.out or raw.get("out")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        kwargs["log_file"] = os.path.join(out_dir, "metrics.jsonl")
    bayes_info = None
    if args.bayes or raw.get("bayes"):
        bayes_info = _fit_bayes(model, raw, args, (Xt, yt, Xv, yv))
    elif args.ensemble or raw.get("ensemble"):
        k = int(args.ensemble or raw.get("ensemble"))
        mix = (args.mix_best if args.mix_best is not None
               else raw.get("mix_best"))
        for key in _HOST_LOOP_ONLY:
            kwargs.pop(key, None)
        model.fit_ensemble(Xt, yt, Xv, yv, k=k, mix_best=mix, **kwargs)
    elif tcfg.fused:
        for key in _HOST_LOOP_ONLY:
            kwargs.pop(key, None)
        model.fit_fast(Xt, yt, Xv, yv, **kwargs)
    else:
        model.fit(Xt, yt, Xv, yv, **kwargs)

    result = {
        "dataset": dataset, "source": meta.get("source"),
        "model": dataclasses.asdict(mcfg),
        "metrics": {k: float(model.evals[k][1][model.min_obj_ind])
                    for k in ("MAE", "NMSE", "RMSE", "MNLP", "SCORE")
                    if model.evals[k][1]},
    }
    if bayes_info:
        result["bayes"] = bayes_info
    if out_dir:
        ckpt = os.path.join(out_dir, "model.pkl")
        model.save(ckpt)
        result["checkpoint"] = ckpt
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
