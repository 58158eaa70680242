"""The port's four boston floor probes against the JAX package's, on the
CPU at cut budgets.

``scfgp_tpu_torch/experiments/boston_floor_probe{,2,3,4}.py``, each run
once with ``--cpu --seeds 1`` and the budgets no option sets cut by
patching the module's constants (``FIT``, ``LONG``, ``VARIANTS``); the JAX
probe ``experiments/boston_floor_probe{,2,3,4}.py`` runs through its own
``main`` on the same split at the same budgets, its fit functions wrapped
to take them.  At the JAX budgets the four take several minutes of CPU
time.

Both packages run in float64 with the stall annealing held off
(``max_cvrg`` twice ``max_iter``), and each port model starts from the θ
that the JAX package draws for the same seed (``_jax_theta``): the
annealing's uniform comes from each package's own generator, so it and a
package's own init would each split the trials.  So each ratio is
deterministic and must equal the JAX probe's: a restart seed, a member's
order, the basis, the target's scaling or the learning rate passed wrong
shows as a ratio that differs.

Exact: each report's variants are those the JAX probe reports (its own
``main`` run with its fits replaced by stubs, so its keys come from its
code), the floor each ratio divides by is the JAX package's
``surrogate_floor`` on the same split, to 1e-12, and each ratio is the JAX
probe's to RATIO_RTOL.
"""

import functools
import io
import json
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu import SCFGP as JaxSCFGP
from scfgp_tpu.data import datasets as jds
from scfgp_tpu.models.params import init_params as jax_init_params
from test_torch_sampling_campaigns import _defaults, _jax_driver
from scfgp_tpu_torch.experiments import (boston_floor_probe,
                                         boston_floor_probe2,
                                         boston_floor_probe3,
                                         boston_floor_probe4)
from scfgp_tpu_torch.models import model as torch_model
from scfgp_tpu_torch.models.params import params_from_numpy

torch.set_num_threads(1)

PROBES = {"boston_floor_probe": boston_floor_probe,
          "boston_floor_probe2": boston_floor_probe2,
          "boston_floor_probe3": boston_floor_probe3,
          "boston_floor_probe4": boston_floor_probe4}

# The cut budgets: 30 iterations a fit (60 the long ones), ensembles of at
# most 3 (probe 3) and 4 (probe 4) members mixing half of them where the
# probe mixes a top; max_cvrg at twice max_iter, so no stall annealing.
FIT = dict(max_iter=30, max_cvrg=60)
LONG = dict(max_iter=60, max_cvrg=120)
MEMBERS = {"boston_floor_probe3": 3, "boston_floor_probe4": 4}
# Each ratio against the JAX probe's: the two float64 fits from one θ
# agree to ~1e-9 in cost (tests/test_torch_train_loops.py); the ratios
# here to ~5e-13.
RATIO_RTOL = 1e-9


def _cut(variants, members):
    return {k: dict(v, max_iter=FIT["max_iter"], max_cvrg=FIT["max_cvrg"],
                    k=min(v["k"], members), top=v["top"] and members // 2)
            for k, v in variants.items()}


def _jax_theta(generator, D, S, M, dtype=torch.float32, device="cpu"):
    """The port's ``init_params`` in the JAX package's draw: the θ that
    ``jax.random.PRNGKey`` of the generator's seed gives."""
    jdtype = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    theta = jax_init_params(jax.random.PRNGKey(generator.initial_seed()), D,
                            S, M, jdtype)
    return params_from_numpy([np.asarray(a) for a in theta], dtype=dtype,
                             device=device)


def _jax_cut(probe, name):
    """The JAX probe's fit functions wrapped to take the cut budgets, its
    models in float64 and IEEE."""
    def fit(fn):
        def cut(*a, max_iter=500, max_cvrg=18, **kw):
            return fn(*a, **(LONG if max_iter == 2000 else FIT), **kw)
        return cut

    def ens(fn):
        members = MEMBERS[name]

        def cut(*a, k=5, top=None, max_iter=500, max_cvrg=18, **kw):
            if top:
                kw["top"] = members // 2
            return fn(*a, k=min(k, members), **FIT, **kw)
        return cut

    wraps = {"fit_one": fit, "fit_model": fit, "ens_nmse": ens, "ens": ens}
    out = {fn: wrap(getattr(probe, fn)) for fn, wrap in wraps.items()
           if hasattr(probe, fn)}
    out["SCFGP"] = functools.partial(JaxSCFGP, dtype=jnp.float64,
                                     mm_precision=None)
    return out


@pytest.fixture(scope="module")
def reports():
    """Each probe's report, the floors its ratios were divided by, and the
    JAX probe's report at the same budgets."""
    floors, out = [], {}
    split = boston_floor_probe.split

    def recorded(seed):
        data = split(seed)
        floors.append(data[-1])
        return data

    budgets = {
        "boston_floor_probe": dict(FIT=FIT, LONG=LONG),
        "boston_floor_probe2": dict(FIT=FIT, LONG=LONG),
        "boston_floor_probe3": dict(VARIANTS=_cut(
            boston_floor_probe3.VARIANTS, MEMBERS["boston_floor_probe3"])),
        "boston_floor_probe4": dict(VARIANTS=_cut(
            boston_floor_probe4.VARIANTS, MEMBERS["boston_floor_probe4"])),
    }
    f64 = functools.partial(torch_model.SCFGP, dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_model, "init_params", _jax_theta)
        for name in ("boston_floor_probe", "boston_floor_probe2",
                     "boston_floor_probe3"):
            mp.setattr(PROBES[name], "split", recorded)
        for name in ("boston_floor_probe", "boston_floor_probe3"):
            mp.setattr(PROBES[name], "SCFGP", f64)
        for name, module in PROBES.items():
            for const, value in budgets[name].items():
                mp.setattr(module, const, value)
            out[name] = module.main(["--cpu", "--seeds", "1"])
            out[name + "_floors"] = list(floors)
            floors.clear()
            probe = _jax_driver(name)
            for fn, value in _jax_cut(probe, name).items():
                mp.setattr(probe, fn, value)
            mp.setattr(sys, "argv", [name, "--seeds", "1"])
            with redirect_stdout(io.StringIO()) as text:
                probe.main()
            text = text.getvalue()
            out[name + "_jax"] = json.loads(text[text.rindex("\n{") + 1:])
    return out


def _jax_probe_keys(name, monkeypatch, capsys):
    """The variants the JAX probe ``experiments/<name>.py`` reports, from
    its own ``main`` on one seed, its fits replaced by stubs."""
    probe = _jax_driver(name)

    class Fitted:
        def predict(self, Xv):
            return np.zeros((len(Xv), 1)), np.ones((len(Xv), 1))

    stubs = {"fit_one": lambda *a, **k: (0.3, 0.1),
             "fit_model": lambda *a, **k: Fitted(),
             "ens_nmse": lambda *a, **k: 0.3,
             "ens": lambda *a, **k: 0.3}
    for fn, stub in stubs.items():
        if hasattr(probe, fn):
            monkeypatch.setattr(probe, fn, stub)
    monkeypatch.setattr(sys, "argv", [name, "--seeds", "1"])
    capsys.readouterr()
    probe.main()
    text = capsys.readouterr().out
    return set(json.loads(text[text.rindex("\n{") + 1:]))


@pytest.mark.parametrize("name", list(PROBES))
def test_variants_are_the_jax_probes(reports, name, monkeypatch, capsys):
    got = reports[name]
    assert set(got) == _jax_probe_keys(name, monkeypatch, capsys)
    assert list(got) == list(
        {"boston_floor_probe": ["base", "long", "restarts", "linear",
                                "linear+rs"],
         "boston_floor_probe2": ["best_of_5", "ens5", "ens_top3",
                                 "linear_long"],
         "boston_floor_probe3": list(boston_floor_probe3.VARIANTS),
         "boston_floor_probe4": list(boston_floor_probe4.VARIANTS)}[name])
    for row in got.values():
        assert set(row) == {"mean_ratio", "ratios"} and len(row["ratios"]) == 1


@pytest.mark.parametrize("name", list(PROBES))
def test_floor_equals_jax(reports, name):
    """The floor each ratio divides by: one split of seed 0 a probe."""
    _, _, Xv, yv, _ = jds.load_boston(seed=0)
    want = jds.surrogate_floor("boston_housing", Xv, yv)["NMSE"]
    floors = reports[name + "_floors"]
    assert len(floors) == 1
    np.testing.assert_allclose(floors[0], want, rtol=0, atol=1e-12)
    _, _, Xv_t, yv_t, _ = boston_floor_probe.split(0)
    np.testing.assert_array_equal(Xv_t, Xv)
    np.testing.assert_array_equal(yv_t, yv)


@pytest.mark.parametrize("name", list(PROBES))
def test_ratios_in_law(reports, name):
    """Each ratio finite and the JAX probe's on the same split, θ and
    budgets, to RATIO_RTOL."""
    want = reports[name + "_jax"]
    assert list(reports[name]) == list(want)
    for variant, row in reports[name].items():
        ratio = row["mean_ratio"]
        assert np.isfinite(ratio), variant
        np.testing.assert_allclose(ratio, want[variant]["mean_ratio"],
                                   rtol=RATIO_RTOL, err_msg=variant)


@pytest.mark.parametrize("name", list(PROBES))
def test_options_and_defaults_are_the_jax_probes(name, monkeypatch):
    """Each probe takes its JAX probe's options with their defaults, and
    ``--cpu``."""
    want = _defaults(_jax_driver(name).main, monkeypatch)
    got = _defaults(PROBES[name].main, monkeypatch)
    assert got.pop("cpu") is False
    assert got == want
