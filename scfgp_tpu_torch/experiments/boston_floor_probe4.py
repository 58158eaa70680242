"""Probe 4: probe 3's winners combined on the boston floor.

Port of ``experiments/boston_floor_probe4.py``, through probe 3's batched
ensembles (linear extra basis, m=20):

  ens8_long_ynorm — 8 members, 1500 iterations, y_scaling_method="normal"
  ens16_top8      — 16 members, the best 8 by validation NMSE mixed
  ens8_lr005      — 8 members, adam lr 0.005, 2000 iterations

    python -m scfgp_tpu_torch.experiments.boston_floor_probe4 [--seeds K]
        [--cpu]

Prints as ``boston_floor_probe``; writes no file.  On the card unless
``--cpu``.
"""

from .boston_floor_probe3 import ENSEMBLE, run

# The JAX probe's defaults (experiments/boston_floor_probe4.py:37-39) and
# variants (:62-64).
ENSEMBLE4 = dict(ENSEMBLE, k=8, max_iter=1500, max_cvrg=40)
VARIANTS = {"ens8_long_ynorm": dict(ENSEMBLE4, y_scaling="normal"),
            "ens16_top8": dict(ENSEMBLE4, k=16, top=8),
            "ens8_lr005": dict(ENSEMBLE4, lr=0.005, max_iter=2000)}


def main(argv=None) -> dict:
    return run(argv, __doc__, VARIANTS)


if __name__ == "__main__":
    main()
