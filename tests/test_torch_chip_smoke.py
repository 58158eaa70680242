"""chip_smoke.py and experiments/kernel_ab.py keep timing the kernels where
the streaming path runs them: K1f and K1b (pass 2) and K2f and K2b (pass 1)
at one block of phase 9, (block, D, S + M)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from scfgp_tpu_torch.experiments import kernel_ab  # noqa: E402

BLOCK = (chip_smoke.STREAM["block"], chip_smoke.STREAM["D"],
         chip_smoke.STREAM["S"] + chip_smoke.STREAM["M"])


@pytest.mark.parametrize("shapes", ["K1_SHAPES", "K2_SHAPES"])
def test_chip_smoke_times_the_kernels_at_the_streaming_block(shapes):
    assert chip_smoke.STREAM_BLOCK == BLOCK
    assert BLOCK in [tuple(row[1:4]) for row in getattr(chip_smoke, shapes)]


@pytest.mark.parametrize("kernel,shapes", [("phi_fwd", "K1_SHAPES"),
                                           ("gram_fwd", "K2_SHAPES")])
def test_kernels_line_reports_the_forward_kernels_at_the_streaming_block(
        kernel, shapes):
    """The kernels line's first reading of K1f and K2f is one block of phase
    9, with the served kin8nm model beside it (and, for K1f, the batched
    shapes of phase 11a)."""
    first, *beside = chip_smoke.KERNELS_LINE_SHAPES[kernel]
    rows = {row[0]: tuple(row[1:4]) for row in getattr(chip_smoke, shapes)}
    rows.update({"batch-" + row[0]: tuple(row[2:5])
                 for row in chip_smoke.BATCH_SHAPES})
    assert rows[first] == BLOCK
    assert "kin8nm" in beside and all(at in rows for at in beside)


def test_kernel_ab_times_the_streaming_block_and_the_kernels_line_shapes():
    assert kernel_ab.SHAPES["block"] == BLOCK
    assert set(kernel_ab.KERNELS) == {"phi_fwd", "phi_bwd", "gram_fwd",
                                      "gram_bwd"}
    k1 = {row[0]: tuple(row[1:]) for row in chip_smoke.K1_SHAPES}
    for name in ("kin8nm", "bench", "d256", "block"):
        assert kernel_ab.SHAPES[name] == k1[name]


@pytest.mark.parametrize("obj", ["COST", "SCORE"])
def test_per_trial_products_replay_sequential_fits_bitwise(obj):
    """Phase 11b's witness: a float32 fit_fast_batch whose products past Phi
    run per trial replays each trial's sequential fit_fast bit for bit, so
    the loop's masks, generators and optimizer state are per trial."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
    from scfgp_tpu_torch.models.model import fit_fast_batch
    opt = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
           "max_iter": 60, "cvrg_tol": 1e-5, "max_cvrg": 8, "obj": obj}
    data = []
    for b in range(3):
        X, y = synthetic_gp_rff(n=150, d=3, s=3, m=6, seed=b)
        data.append((X[:120], y[:120], X[120:], y[120:]))

    def models():
        return [SCFGP(sparsity=3, nfeats=8, seed=10 + b, device="cpu",
                      dtype=torch.float32) for b in range(3)]
    seq = models()
    for m, d in zip(seq, data):
        m.fit_fast(*d, **opt)
    bat = models()
    with chip_smoke.per_trial_products():
        fit_fast_batch(bat, data, **opt)
    assert len({len(m.evals["COST"][1]) for m in seq}) > 1
    for mb, ms in zip(bat, seq):
        assert mb.evals["COST"][1] == ms.evals["COST"][1]
        assert chip_smoke.params_equal(mb.params, ms.params)
        assert chip_smoke.params_equal(mb.post, ms.post)
        assert [a.stride() for a in mb.post] == [a.stride() for a in ms.post]
        for metric in ("NMSE", "MNLP", "SCORE", "RMSE"):
            assert mb.evals[metric][1] == ms.evals[metric][1]


def test_kernel_ab_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    assert kernel_ab.main(["--shapes", "kin8nm"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
