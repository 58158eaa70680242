"""The frozen operation and byte arithmetic equals the smoke's, and the
model FLOPs of a step are pinned by hand at one small shape."""

import pytest

import chip_smoke
from portbench import work

SHAPES = [(6553, 8, 277), (16384, 256, 256), (4096, 256, 500), (1, 1, 1)]


@pytest.mark.parametrize("name", ["k1f_work", "k1b_work", "k2f_work",
                                  "k2b_work"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_work_matches_the_smoke(name, shape):
    assert getattr(work, name)(*shape) == getattr(chip_smoke, name)(*shape)


@pytest.mark.parametrize("n", [1, 554, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_chol_work_and_bound_match_the_smoke(n, inverse):
    assert work.chol_work(n, inverse) == chip_smoke.chol_work(n, inverse)
    assert work.bound(*work.chol_work(n, inverse)) == chip_smoke.bound(
        *chip_smoke.chol_work(n, inverse))
    assert (work.PEAK_FP32, work.PEAK_HBM) == (chip_smoke.PEAK_FP32,
                                               chip_smoke.PEAK_HBM)


def test_model_flops_by_hand():
    # n=10 rows, d=3, s=1, m=1: K=2, 2K=4.
    # forward:  XF 2*10*3*2=120; Gram 10*4*5=200; Φᵀy 2*10*4=80;
    #           chol + L⁻¹ 2*64/3; ΦL⁻ᵀ 2*10*16=320; Φα 80
    # backward: ΦL⁻ᵀ 640; Φα 160; Gram 320; Φᵀy 80; chol 10*64=640;
    #           XᵀdT 120
    by_hand = (120 + 200 + 80 + 128 / 3 + 320 + 80
               + 640 + 160 + 320 + 80 + 640 + 120)
    assert work.model_flops(10, 3, 1, 1) == pytest.approx(by_hand)
    assert work.model_flops(10, 3, 1, 1, trials=4) == pytest.approx(
        4 * by_hand)
