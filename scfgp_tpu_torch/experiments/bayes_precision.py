"""Why the samplers' log posterior takes its data-fit term from the
residuals (``loss_fn(residual_fit=True)``, ``bayes/predictive.py``).

The reference's term ``(yᵀy - βᵀβ) / σ²`` subtracts two sums of size
``yᵀy`` and divides by the noise variance σ², which is ~1e-3 where the
kin8nm posterior lives; in float32 it is then off by up to a few nats,
noise that stalls HMC.  Two modes, one JSON line a reading:

    python -m scfgp_tpu_torch.experiments.bayes_precision --mode fleet
        [--seeds 0 1] [--quick] [--rows N] [--cpu]

runs the kin8nm fleet (``kin8nm_bayes_probe``'s ``hmc_fleet32``: 32
random-init chains, 300 + 300 transitions) with the reference's term in
float32, then the same fleet in float64 on the plain feature map; at the
float32 run's final positions it reads the log posterior's error against
float64 for both forms of the term, the adapted step sizes, and the
float32 draws' mixture computed in float64.  On the card by default.

    python -m scfgp_tpu_torch.experiments.bayes_precision --mode terms
        [--rows 2000] [--cpu]

fits a MAP in float64 on the plain feature map (S=20, M=50, a subsample of
kin8nm rows) and, at noise variances lowered from the MAP's, reads each
term's float32 error against float64: the reference's data-fit term, the
residual form, the expected NLL and the log determinant.  The float32 terms
take the samplers' arithmetic (K1f and cuBLAS on the card).  On the card by
default, as fleet mode; ``--cpu`` runs either mode on the CPU.
"""

import argparse
import contextlib
import json
import math
import warnings

import numpy as np
import torch

from ..bayes import predictive
from ..data.datasets import load_kin8nm, surrogate_floor
from ..models import objective
from ..models.params import pack_params, unpack_params
from ..utils.metrics import regression_metrics
from .kin8nm_bayes_probe import M, S, run_arm

FLEET = dict(sampler="hmc", chains=32, num_warmup=300, num_samples=300,
             num_integration_steps=16, init_step_size=0.003,
             shared_adaptation=False)


@contextlib.contextmanager
def reference_form():
    """The samplers' log posterior with the reference's data-fit term."""
    loss_fn = predictive.loss_fn
    predictive.loss_fn = lambda *a, **k: loss_fn(
        *a, **{**k, "residual_fit": False})
    try:
        yield
    finally:
        predictive.loss_fn = loss_fn


@contextlib.contextmanager
def plain_feature_map():
    """The objective on the plain PyTorch feature map (any dtype): the
    kernels take float32 only."""
    from ..ops.phi import fourier_features_ref
    kernel = objective.fourier_features

    def plain(p, X):
        fr = objective.derive_frequencies(p)
        scale = torch.exp(p.b) * math.sqrt(2.0 / p.M)
        return fourier_features_ref(X, fr.Fcat, fr.pcat, scale)

    objective.fourier_features = plain
    try:
        yield
    finally:
        objective.fourier_features = kernel


def half_n_cost(theta, X, y, residual_fit):
    """``N cost / 2`` (minus the log posterior) at reduced positions
    (C, P), without gradients."""
    C = theta.shape[0]
    full = torch.cat([theta, theta.new_zeros(C, S + M)], dim=1)
    Xc = X.expand(C, *X.shape).contiguous()
    yc = y.reshape(-1).expand(C, -1).contiguous()
    with torch.no_grad():
        cost, _ = objective.loss_fn(unpack_params(full, X.shape[1], S, M),
                                    Xc, yc, residual_fit=residual_fit)
    return 0.5 * X.shape[0] * cost.double()


def fleet(args, device):
    Xt, yt, Xv, yv, meta = load_kin8nm(seed=0)
    Xt, yt = Xt[:args.rows], yt[:args.rows]
    floor = surrogate_floor(meta["name"], Xv, yv)["NMSE"]
    kw = dict(FLEET, **(dict(num_warmup=30, num_samples=30)
                        if args.quick else {}))
    ys = np.reshape(yv, (-1, 1))
    for seed in args.seeds:
        with reference_form():
            rec, m = run_arm(Xt, yt, Xv, yv, floor, device, seed, **kw)
        rec.pop("config")
        res = m.bayes_result
        q = res.final_positions
        X64, y64 = m.X.double(), m.y.double()
        err = {}
        for rf in (False, True):
            with plain_feature_map():
                ref = half_n_cost(q.double(), X64, y64, rf)
            err["residual" if rf else "reference"] = (
                half_n_cost(q, m.X, m.y, rf) - ref).abs().cpu().tolist()
        m.dtype, m.thetas, m.X, m.y = (torch.float64, m.thetas.double(),
                                       X64, y64)
        with plain_feature_map():
            mixed = regression_metrics(*m.predict_bayes(Xv), ys)
        print(json.dumps({
            "fleet": "float32, reference form", "seed": seed, **rec,
            "step_size_quantiles": np.quantile(
                res.step_size.cpu().numpy(), [0, .25, .5, .75, 1]).tolist(),
            "nll_abs_err_at_final_positions": err,
            "float64_mixture": {"NMSE": mixed["NMSE"],
                                "MNLP": mixed["MNLP"]}}), flush=True)
    with plain_feature_map():
        rec, _ = run_arm(Xt, yt, Xv, yv, floor, device, args.seeds[0],
                         dtype=torch.float64, **kw)
    rec.pop("config")
    print(json.dumps({"fleet": "float64, plain map", "seed": args.seeds[0],
                      **rec}), flush=True)


def terms(args, device):
    """One JSON line a noise variance; returns the lines."""
    from ..models.model import SCFGP
    Xt, yt, _, _, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=S, nfeats=M, seed=0, device=device,
              dtype=torch.float64)
    with plain_feature_map():  # the kernels take float32 only
        m.fit_fast(Xt[:args.rows], yt[:args.rows], obj="COST", max_iter=300)
    theta = pack_params(m.params)

    def parts(dt, shift):
        with (plain_feature_map() if dt == torch.float64
              else contextlib.nullcontext()):
            return terms_at(dt, shift)

    def terms_at(dt, shift):
        th = theta.to(dt).clone()
        th[0] += shift
        p = unpack_params(th, m.D, S, M)
        X, y = m.X.to(dt), m.y.to(dt).reshape(-1)
        Phi = objective.fourier_features(p, X)
        sig2 = torch.exp(2.0 * p.a)
        stats = objective.sufficient_stats(Phi, y)
        post = objective.solve_posterior(stats, sig2)
        mu, var = objective.latent_moments(Phi, post)
        r = mu - y
        return {
            "reference": (stats.yTy - torch.sum(post.beta ** 2)) / sig2,
            "residual": (torch.sum(r * r) + (sig2 + objective.EPSILON)
                         * torch.sum(post.alpha ** 2)) / sig2,
            "enll": 2.0 * torch.sum(objective.expected_nll_rows(
                mu, var, y, objective.softplus(p.c))),
            "logdet": 2.0 * torch.sum(post.log_diag_L),
            "sig2": sig2}

    lines = []
    for shift in (0.0, -1.0, -2.0, -3.0):
        a, b = parts(torch.float64, shift), parts(torch.float32, shift)
        lines.append({"shift_a": shift, "sig2": float(a["sig2"]),
                      "device": str(b["sig2"].device), **{
                          k + "_f32_err": float(b[k]) - float(a[k])
                          for k in ("reference", "residual", "enll",
                                    "logdet")}})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["fleet", "terms"], default="fleet")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rows", type=int, default=None,
                    help="training rows (default: all; terms: 2000)")
    ap.add_argument("--quick", action="store_true",
                    help="30 + 30 transitions (smoke run)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    warnings.simplefilter("ignore")
    device = "cpu" if args.cpu else "cuda"
    if args.mode == "terms":
        args.rows = args.rows or 2000
        return terms(args, device)
    fleet(args, device)


if __name__ == "__main__":
    main()
