"""The program-span reader (``spans.py``) on a trace written by hand: each
device operation to the innermost program span open at its launch, on the
launching thread or, where that thread has none open (the autograd
thread), on any thread; nothing for a launch outside every span or the
window; the division by steps; None for a trace with no program span."""

import json
from types import SimpleNamespace

import pytest

from portbench import spans as S


def _x(cat, name, tid, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _launch(corr, tid, ts):
    return _x("cuda_runtime", "cudaLaunchKernel", tid, ts, 1.0,
              correlation=corr)


def _kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0,
            "tid": 7, "ts": ts, "dur": dur,
            "args": {"device": 0, "correlation": corr}}


MAIN, AUTOGRAD = 1, 2
SPANS = [
    _x("user_annotation", "portbench.window", MAIN, 0.0, 1000.0),
    _x("cpu_op", "scfgp.grad", MAIN, 10.0, 490.0),
    _x("cpu_op", "scfgp.grad.forward", MAIN, 20.0, 180.0),
    _x("cpu_op", "scfgp.stream.pass1", MAIN, 30.0, 70.0),
    _x("cpu_op", "scfgp.K2f", MAIN, 40.0, 20.0),
    _x("cpu_op", "scfgp.grad.backward", MAIN, 250.0, 230.0),
    _x("cpu_op", "scfgp.K1b", AUTOGRAD, 300.0, 20.0),
    _x("cpu_op", "aten::mm", MAIN, 600.0, 200.0),
]
LAUNCHES = [
    _launch(1, MAIN, 50.0),        # inside K2f, inside pass 1
    _launch(2, MAIN, 150.0),       # inside the forward, after pass 1
    _launch(3, AUTOGRAD, 270.0),   # autograd thread, no span of its own
    _launch(4, AUTOGRAD, 310.0),   # autograd thread, inside K1b
    _launch(5, MAIN, 700.0),       # outside every program span
    _launch(6, MAIN, 1500.0),      # after the window
]
KERNELS = [_kernel(1, 60.0, 10.0), _kernel(2, 160.0, 20.0),
           _kernel(3, 280.0, 30.0), _kernel(4, 320.0, 40.0),
           _kernel(5, 720.0, 50.0), _kernel(6, 1600.0, 60.0)]
EVENTS = SPANS + LAUNCHES + KERNELS


def test_each_kernel_goes_to_the_innermost_span_open_at_its_launch():
    r = S.SpanReading(EVENTS)
    assert r.self_ms["scfgp.K2f"] == pytest.approx(0.010)
    assert r.self_ms["scfgp.grad.forward"] == pytest.approx(0.020)
    # The autograd thread's launch with no span of its own goes to the
    # backward open on the main thread; K1b there is the backward's child.
    assert r.self_ms["scfgp.grad.backward"] == pytest.approx(0.030)
    assert r.self_ms["scfgp.K1b"] == pytest.approx(0.040)
    assert r.ms["scfgp.stream.pass1"] == pytest.approx(0.010)
    assert r.ms["scfgp.grad.forward"] == pytest.approx(0.030)
    assert r.ms["scfgp.grad.backward"] == pytest.approx(0.070)
    assert r.ms["scfgp.grad"] == pytest.approx(0.100)
    # Kernel 5 is in no span; kernel 6 was launched after the window.
    assert r.device_ms == pytest.approx(0.150)
    assert r.covered_ms == pytest.approx(0.100)
    assert r.count["scfgp.K1b"] == 1 and "aten::mm" not in r.count


def test_idle_gaps_by_program_span():
    idle = dict(S.SpanReading(EVENTS).idle_by_span())
    assert idle["scfgp.grad.forward"] == pytest.approx(90e-6)  # [70, 160]
    # [360, 720] (the backward ended at 480, the grad at 500), [770, 1000]
    assert idle[S.NO_SPAN] == pytest.approx(360e-6 + 230e-6)
    assert idle["scfgp.grad"] == pytest.approx(100e-6)  # [180, 280]
    assert sum(idle.values()) == pytest.approx(1000e-6 - 150e-6)


def _write(tmp_path, events, base=0, name="cell"):
    path = tmp_path / f"{name}.r0.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": events}))
    return path


def test_readers_divide_by_steps_and_give_none_without_spans(tmp_path,
                                                             monkeypatch):
    path = _write(tmp_path, EVENTS)
    monkeypatch.setattr(S, "latest_trace", lambda: path)
    reading = SimpleNamespace(steps=2)
    assert S.device_ms("scfgp.grad.backward")(reading, None) == \
        pytest.approx(0.035)
    assert S.device_ms("scfgp.stream.pass2")(reading, None) is None
    bare = _write(tmp_path, [e for e in EVENTS
                             if not e["name"].startswith("scfgp.")],
                  name="bare")
    assert S.load(bare) is None
    monkeypatch.setattr(S, "latest_trace", lambda: bare)
    assert S.device_ms("scfgp.grad.backward")(reading, None) is None


def test_store_reader_counts_bytes_in_the_window(tmp_path, monkeypatch):
    from scfgp_tpu_torch.utils import profiling

    base = 10 ** 18
    path = _write(tmp_path, EVENTS, base)
    monkeypatch.setattr(S, "latest_trace", lambda: path)

    def rec(name, t_us, **attrs):
        ns = base + int(t_us * 1e3)
        return profiling.SpanRecord(0, name, None, MAIN, ns, ns + 1, attrs)

    records = [rec("scfgp.sgld.gradient", 10.0),
               rec("scfgp.stream.trial_copy", 20.0, bytes=3000),
               rec("scfgp.stream.trial_copy", 30.0, bytes=1000),
               rec("scfgp.sgld.gradient", 500.0),
               rec("scfgp.stream.trial_copy", 1200.0, bytes=7),
               rec("scfgp.sgld.gradient", 1300.0)]
    monkeypatch.setattr(profiling, "spans", lambda: records)
    read = S.store_gb_per("scfgp.stream.trial_copy", "scfgp.sgld.gradient")
    assert read(None, None) == pytest.approx(2000 / 1e9)
    monkeypatch.setattr(profiling, "spans", lambda: records[1:3])
    assert read(None, None) is None
