"""The yardstick's arithmetic: the card's peaks, each kernel's operations and
bytes, and the model FLOPs of one step.

The peaks and the ``*_work`` functions are frozen copies of
``chip_smoke.py:226-227`` and ``chip_smoke.py:647-680`` (``bound``,
``k1f_work``, ``k1b_work``, ``k2f_work``, ``k2b_work``, ``chol_work``), so
that a later change to the smoke or to the port cannot move the yardstick.
Nothing here imports the port.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at its 700 W limit: FP32 outside
# the tensor cores, and HBM3 bandwidth.  The configurations run float32
# with TF32 off, so FP32 is the peak their arithmetic can reach.
PEAK_FP32 = 67e12  # FLOP/s
PEAK_HBM = 3.35e12  # bytes/s


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time an H100 could take for work of
    ``flops`` FP32 operations moving ``nbytes``, the larger of the two at
    the card's peak rates."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


# (FP32 operations, bytes) of each kernel's function at (N, D, K) or n,
# float32: each input read once and each output written once.  sin and cos
# are not counted.
def k1f_work(n, d, k):  # T = X F + p; Φ (N, 2K) written
    return 2 * n * d * k, 4 * (n * d + d * k + k + 1 + 2 * n * k)


def k1b_work(n, d, k):  # T again, then Xᵀ dT; reads the gradient of Φ
    return 4 * n * d * k, 4 * (n * d + 2 * (d * k + k + 1) + 2 * n * k)


def k2f_work(n, d, k):  # T, then the upper triangle of ΦᵀΦ
    return (2 * n * d * k + n * 2 * k * (2 * k + 1),
            4 * (n * d + n + d * k + k + 1 + 4 * k * k + 2 * k + 2))


def k2b_work(n, d, k):  # T, Φ Ā (N, 2K) x (2K, 2K), then Xᵀ dT
    return (4 * n * d * k + 2 * n * (2 * k) ** 2,
            4 * (n * d + n + 2 * (d * k + k + 1) + 4 * k * k + 2 * k))


def chol_work(n, inverse):  # n³/3 for L, as much again for L⁻¹
    return ((2 if inverse else 1) * n ** 3 / 3,
            4 * n * n * (3 if inverse else 2))


KERNEL_WORK = {"K1f": k1f_work, "K1b": k1b_work, "K2f": k2f_work,
               "K2b": k2b_work}


def model_flops(n, d, s, m, trials=1):
    """FLOPs of one loss and gradient of the SCFGP objective over ``n``
    rows of width ``d`` with ``s`` + ``m`` = K frequencies (2K features),
    for each of ``trials`` independent trials.

    Counted once from the shapes: the products the objective's forward and
    backward need, 2 FLOPs a multiply-add, and the Cholesky factor and
    inverse at m³/3 each.  Elementwise work and sin/cos are not counted, nor
    work an implementation repeats (a checkpoint's recompute, a second
    T = X F in pass 2), nor the O(K²) products of the 2K-vectors.

    forward:  T = X F              2 n d K
              Φᵀ Φ (symmetric)     n 2K (2K + 1)
              Φᵀ y                 2 n 2K
              chol, L⁻¹            2 (2K)³ / 3
              Φ L⁻ᵀ                2 n (2K)²
              Φ α                  2 n 2K
    backward: Φ L⁻ᵀ → Φ, L⁻¹       2 · 2 n (2K)²
              Φ α → Φ, α           2 · 2 n 2K
              Φᵀ Φ → Φ             2 n (2K)²
              Φᵀ y → Φ             2 n 2K
              chol, L⁻¹            5 GEMMs of (2K)³: 10 (2K)³
              Xᵀ dT                2 n d K
    """
    k = s + m
    w = 2 * k
    per_trial = (4 * n * d * k + n * w * (w + 1) + 8 * n * w * w
                 + 10 * n * w + (2 / 3 + 10) * w ** 3)
    return trials * per_trial
