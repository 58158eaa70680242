"""The per-layer readers' arithmetic, shared by ``metrics/<name>.py``.

Each takes the ``trace.Reading`` of the traced stretch and the run's
figures (``run.session``, ``run.steps_per_s`` of the untraced window,
``run.chips``) and returns a number, or None where there is nothing to
read, in which case the harness leaves the metric out.
"""

from __future__ import annotations

from .work import PEAK_FP32


def per_step(total, reading):
    return total / reading.steps if reading.steps else None


def launches(reading, run):
    """Device kernels in the traced stretch a step (or draw)."""
    return per_step(float(reading.launches), reading)


def gemm_ms(reading, run):
    """Device ms a step in cuBLAS GEMM kernels."""
    return per_step(reading.gemm_ms, reading)


def allreduce_ms(reading, run):
    """Device ms a step in NCCL kernels; None where there are none."""
    if reading.nccl_ms <= 0.0:
        return None
    return per_step(reading.nccl_ms, reading)


def roofline(kernel):
    def read(reading, run):
        return reading.roofline_pct(kernel)
    return read


def mfu(reading, run):
    """The model FLOPs a step at the untraced window's step rate, as a
    share of the chips' FP32 peak."""
    flops = run.session.flops_per_step * run.steps_per_s
    return 100.0 * flops / (PEAK_FP32 * run.chips)


def idle_pct(reading, run):
    """Share of the traced window in which no operation ran on the
    device, averaged over the chips."""
    if reading.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)
