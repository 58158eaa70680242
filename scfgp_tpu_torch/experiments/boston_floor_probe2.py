"""Probe 2: averaging restarts against picking the best one, on boston.

Port of ``experiments/boston_floor_probe2.py``.  Continues
``boston_floor_probe``: best of 5 restarts with a linear extra basis
reached the floor x1.17; here the predictions of the same restarts are
averaged (the mixture's mean), and one fit gets longer patience, on the
same splits:

  best_of_5    — the restart of least validation NMSE
  ens5         — the mean of all 5 restarts' predictive means
  ens_top3     — the mean of the 3 restarts of least validation NMSE
  linear_long  — one fit, 2000 iterations, max_cvrg 60

    python -m scfgp_tpu_torch.experiments.boston_floor_probe2 [--seeds K]
        [--cpu]

Prints as ``boston_floor_probe``; writes no file.  On the card unless
``--cpu``.
"""

import numpy as np

from .boston_floor_probe import (FIT, LONG, fit_model, nmse, split, start,
                                 summary)
from .boston_housing import linear_basis

# The JAX probe's budgets (experiments/boston_floor_probe2.py:38-76).
RESTARTS = 5
TOP = 3


def main(argv=None) -> dict:
    args, device = start(argv, __doc__, 2)
    out = {}
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, floor = split(seed)
        data = (Xt, yt, Xv, yv)
        models = [fit_model(*data, 100 * seed + k, device,
                            basis=linear_basis, **FIT)
                  for k in range(RESTARTS)]
        mus = [np.reshape(m.predict(Xv)[0], -1) for m in models]
        nmses = [nmse(mu, yv) for mu in mus]

        out.setdefault("best_of_5", []).append(min(nmses) / floor)
        out.setdefault("ens5", []).append(
            nmse(np.mean(mus, axis=0), yv) / floor)
        order = np.argsort(nmses)
        out.setdefault("ens_top3", []).append(
            nmse(np.mean([mus[i] for i in order[:TOP]], axis=0), yv) / floor)
        m = fit_model(*data, seed, device, basis=linear_basis, **LONG)
        out.setdefault("linear_long", []).append(
            nmse(m.predict(Xv)[0], yv) / floor)

        for k, v in out.items():
            print(f"  seed {seed} {k:12s} ratio {v[-1]:.3f}", flush=True)
    return summary(out)


if __name__ == "__main__":
    main()
