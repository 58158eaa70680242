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
    9, with the served kin8nm model beside it."""
    first, *beside = chip_smoke.KERNELS_LINE_SHAPES[kernel]
    rows = {row[0]: tuple(row[1:4]) for row in getattr(chip_smoke, shapes)}
    assert rows[first] == BLOCK
    assert "kin8nm" in beside and all(at in rows for at in beside)


def test_kernel_ab_times_the_streaming_block_and_the_kernels_line_shapes():
    assert kernel_ab.SHAPES["block"] == BLOCK
    assert set(kernel_ab.KERNELS) == {"phi_fwd", "phi_bwd", "gram_fwd",
                                      "gram_bwd"}
    k1 = {row[0]: tuple(row[1:]) for row in chip_smoke.K1_SHAPES}
    for name in ("kin8nm", "bench", "d256", "block"):
        assert kernel_ab.SHAPES[name] == k1[name]


def test_kernel_ab_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    assert kernel_ab.main(["--shapes", "kin8nm"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
