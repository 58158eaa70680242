"""The port's three tempering campaigns against the JAX drivers' reports,
on the CPU at a tiny width.

``scfgp_tpu_torch/experiments/{tempering_probe,tempering_sweep,
deep_ladder}.py`` at ``--n 256 --sparsity 4 --nfeats 8`` (sampling
dimension 67), 3 chains, a few rungs and draws, the budgets no option sets
cut by patching the modules' constants (``PRE_SAMPLES``, ``PRE_WARMUP``,
``SEG_DRAWS``).  All in one module-scoped fixture, in one output
directory, as the JAX campaigns share theirs: the sweep, the sweep again
(its legs found in its report, its pre-warmup rerun by
``--no-reuse-warm``), then the deep ladder on the sweep's cached
pre-warmup.

Exact: every report's keys, and each leg's, are those of the JAX driver's
committed report (``experiments/results/hmc/tempering_probe.json``,
``tempering_sweep.json``, ``deep_ladder_campaign.json``; where the JAX run
resumed legs of an older version of its driver, the leg of that kind
with the driver's full set of keys); each leg's counts (draws a chain,
chains, rungs) are the options'; the deep ladder's equal-time legs stop
within one chunk of the tempered leg's wall time.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from scfgp_tpu_torch.experiments import (deep_ladder, tempering_probe,
                                         tempering_sweep)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--cpu", "--n", "256", "--sparsity", "4", "--nfeats", "8",
         "--chains", "3"]
DIM = 3 + 8 * 4 + 8 * 4
PROBE = ["--samples", "8", "--warmup", "4", "--pre-warmup", "4",
         "--max-rungs", "4"]
SWEEP = ["--warmup", "3", "--base-samples", "8", "--big-samples", "10",
         "--max-rungs", "3"]
LADDER = ["--plain-chains", "6", "--rungs", "3", "--samples", "16",
          "--warmup", "4"]
SEG_DRAWS = 2


def _jax_report(name):
    with open(os.path.join(ROOT, "experiments", "results", "hmc",
                           name)) as f:
        return json.load(f)


def _run(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(argv)
    return out, [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hmc"))
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempering_probe, "PRE_SAMPLES", 8)
        mp.setattr(tempering_sweep, "PRE_WARMUP", 4)
        mp.setattr(deep_ladder, "SEG_DRAWS", SEG_DRAWS)
        res["probe"] = _run(tempering_probe, WIDTH + PROBE + ["--out", out])
        res["sweep"] = _run(tempering_sweep, WIDTH + SWEEP + ["--out", out])
        res["sweep_again"] = _run(tempering_sweep, WIDTH + SWEEP + [
            "--out", out, "--no-reuse-warm"])
        res["ladder"] = _run(deep_ladder, WIDTH + LADDER + ["--out", out])
    res["files"] = {name: json.load(open(os.path.join(out, name)))
                    for name in ("tempering_probe.json",
                                 "tempering_sweep.json",
                                 "deep_ladder_campaign.json")}
    return res


def _fullest(legs, kind):
    """The key set of the JAX report's leg of ``kind`` with most keys."""
    return max((set(l) for l in legs if l["kind"] == kind), key=len)


def test_probe_keys_and_counts(campaigns):
    got, lines = campaigns["probe"]
    want = _jax_report("tempering_probe.json")
    assert set(got) == set(want)
    assert set(got["plain_hmc_same_budget"]) == set(
        want["plain_hmc_same_budget"])
    assert campaigns["files"]["tempering_probe.json"] == json.loads(
        json.dumps(got))
    assert (got["chains"], got["dim"], got["n"], got["rungs"]) == (3, DIM,
                                                                   256, 4)
    assert lines[0] == {"device": "cpu"} and got["backend"] == "cpu"
    assert 0 < got["swap_rate"] <= 1
    for key in ("max_rhat", "min_ess_bulk", "cold_draws_per_s",
                "std_E_within", "std_E_pooled"):
        assert np.isfinite(got[key]), key


def test_sweep_keys_and_counts(campaigns):
    got, _ = campaigns["sweep"]
    want = _jax_report("tempering_sweep.json")
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert got["config"]["dim"] == DIM and got["config"]["chains"] == 3
    assert [l["leg"] for l in got["legs"]] == [
        "plain-8", "tempered-g0.75-8", "tempered-g1.5-8", "plain-10",
        f"tempered-g{got['winner_gap_at_100']}-10"]
    for leg in got["legs"]:
        assert set(leg) == _fullest(want["legs"], leg["kind"]), leg["leg"]
        assert leg["samples"] == int(leg["leg"].rsplit("-", 1)[1])
        if leg["kind"] == "tempered":
            assert leg["rungs"] == 3 and 0 < leg["swap_rate"] <= 1
        assert np.isfinite([leg["max_rhat"], leg["min_ess_bulk"],
                            leg["rhat_logdensity"]]).all(), leg["leg"]
    assert campaigns["files"]["tempering_sweep.json"] == json.loads(
        json.dumps(got))


def test_sweep_resumes_its_legs_and_reruns_the_prewarmup(campaigns):
    again, lines = campaigns["sweep_again"]
    first, _ = campaigns["sweep"]
    assert again["legs"] == json.loads(json.dumps(first["legs"]))
    assert [l["skipped_cached"] for l in lines if "skipped_cached" in l] \
        == [l["leg"] for l in first["legs"]]
    assert any("pre_warmup_s" in l for l in lines)
    assert not any("pre_warmup" in l for l in lines)


def test_deep_ladder_keys_and_counts(campaigns):
    got, lines = campaigns["ladder"]
    want = _jax_report("deep_ladder_campaign.json")
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert set(got["verdict"]) == set(want["verdict"])
    assert any(l.get("pre_warmup") == "cached" for l in lines)
    legs = got["legs"]
    assert list(legs) == ["tempered-3r-b0.3-16", "plain-6c-equal-time",
                          "plain-6c-fleet-equal-time"]
    want_legs = list(want["legs"].values())
    for tag, leg in legs.items():
        assert set(leg) == _fullest(want_legs, leg["kind"]), tag
        assert np.isfinite([leg["max_rhat"], leg["min_ess_bulk"]]).all()
    t = legs["tempered-3r-b0.3-16"]
    assert (t["chains"], t["draws_per_chain"], t["rungs"], t["segment"]) \
        == (3, 16, 3, 50)
    assert 0 < t["swap_rate"] <= 1
    for tag in ("plain-6c-equal-time", "plain-6c-fleet-equal-time"):
        assert legs[tag]["chains"] == 6
        assert legs[tag]["draws_per_chain"] % SEG_DRAWS == 0
    assert campaigns["files"]["deep_ladder_campaign.json"] == json.loads(
        json.dumps(got))


@pytest.mark.parametrize("tag", ["plain-6c-equal-time",
                                 "plain-6c-fleet-equal-time"])
def test_deep_ladder_equal_time_stops_within_one_chunk(campaigns, tag):
    """A plain leg runs chunks until the next would pass the tempered leg's
    wall time: it ends within one chunk of that budget (a chunk's wall at
    most the leg's wall over its chunks; walls rounded to 0.1 s)."""
    leg = campaigns["ladder"][0]["legs"][tag]
    chunks = leg["draws_per_chain"] // SEG_DRAWS
    assert chunks >= 2
    chunk = leg["wall_s"] / chunks
    assert leg["budget_s"] == campaigns["ladder"][0]["legs"][
        "tempered-3r-b0.3-16"]["wall_s"]
    assert abs(leg["wall_s"] - leg["budget_s"]) <= chunk + 0.1


class _Parsed(Exception):
    pass


def _jax_driver(name):
    """The JAX package's driver ``experiments/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(ROOT, "experiments", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _defaults(main, monkeypatch):
    """The options ``main`` parses from an empty command line."""
    import argparse
    import sys
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(vars(parse(self, args, namespace)))

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        mp.setattr(sys, "argv", ["driver"])
        with pytest.raises(_Parsed) as got:
            main()
    return got.value.args[0]


@pytest.mark.parametrize("name,module", [
    ("tpu_tempering_probe", tempering_probe),
    ("tpu_tempering_sweep", tempering_sweep),
    ("tpu_deep_ladder", deep_ladder)])
def test_options_and_defaults_are_the_jax_drivers(name, module,
                                                  monkeypatch):
    """Each campaign takes its JAX driver's options with their defaults
    (``--cpu`` switches the device there and here), and ``--out``."""
    want = _defaults(_jax_driver(name).main, monkeypatch)
    got = _defaults(module.main, monkeypatch)
    assert got.pop("out") is None
    assert got == want
    assert vars(module.parse([])) == dict(want, out=None)
