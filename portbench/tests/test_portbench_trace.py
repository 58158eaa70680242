"""The reduction of a trace to the per-layer readings, on a trace written
by hand: the device's busy time as a union of intervals, each kernel to
the benchmark span that launched it, GEMM time by name, and each idle gap
to what the host was doing."""

import json

import pytest

from portbench import readers, trace, work

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
     "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.K1f#0",
     "pid": 1, "tid": 1, "ts": 4.0, "dur": 2.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "pid": 1, "tid": 1, "ts": 5.0, "dur": 0.5, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "pid": 1, "tid": 1, "ts": 7.0, "dur": 0.5, "args": {"correlation": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "pid": 1, "tid": 1, "ts": 8.0, "dur": 0.5, "args": {"correlation": 3}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
     "ts": 30.0, "dur": 40.0},
    {"ph": "X", "cat": "kernel", "name": "feature_tile_kernel<false>",
     "pid": 0, "tid": 7, "ts": 10.0, "dur": 10.0,
     "args": {"device": 0, "correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "sm80_xmma_gemm_f32f32",
     "pid": 0, "tid": 7, "ts": 15.0, "dur": 15.0,
     "args": {"device": 0, "correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce",
     "pid": 0, "tid": 7, "ts": 50.0, "dur": 10.0,
     "args": {"device": 0, "correlation": 3}},
]
CALLS = [("K1f", 2e6, 4e6)]


def test_reading_of_a_hand_written_trace():
    r = trace.Reading(EVENTS, CALLS, units=2, steps=2)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(30e-6)  # [10, 30] and [50, 60]
    assert r.launches == 3
    assert r.kernel_ms["K1f"] == pytest.approx(0.010)
    assert r.gemm_ms == pytest.approx(0.015)
    assert r.nccl_ms == pytest.approx(0.010)
    b, by = work.bound(2e6, 4e6)
    assert r.roofline_pct("K1f") == pytest.approx(100 * b / 0.010)
    assert r.roofline_pct("K1b") is None
    gaps = dict(r.idle_gaps)
    assert gaps["aten::mm"] == pytest.approx(20e-6)  # [30, 50]
    assert gaps["host: python (no op)"] == pytest.approx(50e-6)
    assert readers.gemm_ms(r, None) == pytest.approx(0.0075)
    assert readers.launches(r, None) == pytest.approx(1.5)
    assert readers.allreduce_ms(r, None) == pytest.approx(0.005)
    assert readers.idle_pct(r, None) == pytest.approx(70.0)


def test_device_busy_of_a_device_only_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    busy, by_name = trace.device_busy(str(path))
    assert busy == pytest.approx(30e-6)
    assert by_name["sm80_xmma_gemm_f32f32"] == pytest.approx(15e-6)


def test_mfu_reads_the_untraced_rate():
    class Run:
        session = type("S", (), {"flops_per_step": 67e10})
        steps_per_s, chips = 10.0, 1
    assert readers.mfu(None, Run) == pytest.approx(10.0)
