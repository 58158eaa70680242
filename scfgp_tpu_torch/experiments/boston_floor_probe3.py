"""Probe 3: ensemble size, feature count and patience on the boston floor.

Port of ``experiments/boston_floor_probe3.py``.  Each ensemble trains as
one batched fused loop of k trials (``fit_fast_batch``) and predicts by
the mean of its members' predictive means; all with the linear extra basis
of probes 1 and 2:

  ens5_m20   — 5 members, m=20, 500 iterations (probe 2's winner: ~1.14)
  ens8_m20   — 8 members
  ens8_m50   — 8 members, m=50
  ens8_long  — 8 members, 1500 iterations, max_cvrg 40
  ens8_ynorm — 8 members, y_scaling_method="normal" (no Box-Cox on y)

    python -m scfgp_tpu_torch.experiments.boston_floor_probe3 [--seeds K]
        [--cpu]

Prints as ``boston_floor_probe``; writes no file.  On the card unless
``--cpu``.
"""

import numpy as np

from ..models.model import SCFGP, fit_fast_batch
from .boston_floor_probe import nmse, split, start, summary
from .boston_housing import linear_basis

# An ensemble's settings, the JAX probe's defaults
# (experiments/boston_floor_probe3.py:42-43): members k, the best ``top``
# of them by validation NMSE mixed (None: all), m, the fused loop's
# budget, the target's scaling and adam's learning rate.
ENSEMBLE = dict(k=5, top=None, nfeats=20, max_iter=500, max_cvrg=18,
                y_scaling="auto-normal", lr=0.01)
# The variants (experiments/boston_floor_probe3.py:67-71).
VARIANTS = {"ens5_m20": dict(ENSEMBLE),
            "ens8_m20": dict(ENSEMBLE, k=8),
            "ens8_m50": dict(ENSEMBLE, k=8, nfeats=50),
            "ens8_long": dict(ENSEMBLE, k=8, max_iter=1500, max_cvrg=40),
            "ens8_ynorm": dict(ENSEMBLE, k=8, y_scaling="normal")}


def ens_nmse(Xt, yt, Xv, yv, seed, device, k, top, nfeats, max_iter,
             max_cvrg, y_scaling, lr):
    """Validation NMSE of the mean prediction of k members (seeds 100 *
    seed + j) trained in one batch, or of the ``top`` best of them."""
    models = [SCFGP(sparsity=20, nfeats=nfeats, seed=100 * seed + j,
                    extra_basis=linear_basis, y_scaling_method=y_scaling,
                    device=device) for j in range(k)]
    algo = {"algo": "adam", "algo_params": {
        "learning_rate": lr, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}
    fit_fast_batch(models, [(Xt, yt, Xv, yv)] * k, obj="SCORE", algo=algo,
                   max_iter=max_iter, cvrg_tol=1e-5, max_cvrg=max_cvrg)
    mus = [np.reshape(m.predict(Xv)[0], -1) for m in models]
    if top:
        keep = np.argsort([float(np.mean((mu - yv) ** 2)) for mu in mus])
        mus = [mus[i] for i in keep[:top]]
    return nmse(np.mean(mus, axis=0), yv)


def run(argv, doc, variants):
    """The probes' loop: each variant's ensemble on each seed's split."""
    args, device = start(argv, doc, 3)
    out = {}
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, floor = split(seed)
        for name, kw in variants.items():
            r = ens_nmse(Xt, yt, Xv, yv, seed, device, **kw) / floor
            out.setdefault(name, []).append(r)
            print(f"  seed {seed} {name:16s} ratio {r:.3f}", flush=True)
    return summary(out)


def main(argv=None) -> dict:
    return run(argv, __doc__, VARIANTS)


if __name__ == "__main__":
    main()
