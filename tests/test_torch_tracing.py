"""The program's spans (``utils/profiling.py::span``) on the CPU.

With no profiler recording a span records nothing, launches nothing and
synchronises nothing.  Under ``profiling.trace(dir)`` a tiny streaming
step on each route (N=96, D=4, S=2, M=6, blocks of 32) and one
``sgld_sample`` transition of 3 chains over the streaming "gemm" route
leave each site's span in the chrome trace, with the expected count and
nesting, and the same spans in the store (``profiling.spans()``): the
same names and parents, host start and end on the trace's clock to 50 µs,
each trial-axis X copy's bytes, and one hand-written block backward a
block a pass inside the gradient's backward.  The kernel spans (K1f, K1b, K2f,
K2b) fire only on the card: ``tests/test_torch_cuda.py``.
"""

import glob
import json
from collections import Counter

import pytest
import torch

from scfgp_tpu_torch.bayes.sgld import (make_minibatch_value_and_grad,
                                        sgld_sample)
from scfgp_tpu_torch.models.params import init_params, reduced_dim
from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
from scfgp_tpu_torch.opt.optimizers import make_optimizer
from scfgp_tpu_torch.utils import profiling

N, D, S, M, BLOCK, CHAINS = 96, 4, 2, 6, 32, 3
BLOCKS = N // BLOCK
CASES = ("gemm", "kernel", "sgld")


def _data():
    g = torch.Generator().manual_seed(0)
    return torch.rand(N, D, generator=g), torch.randn(N, generator=g)


def _stream_step(route):
    """One optimizer step of the streaming objective."""
    X, y = _data()
    p = init_params(torch.Generator().manual_seed(0), D, S, M)
    tx = make_optimizer("adam")
    (cost, _), grads = loss_and_grad_streaming(p, X, y, block_size=BLOCK,
                                               stats_impl=route)
    tx.update(grads, tx.init(p), p)
    return cost


def _sgld_transition():
    X, y = _data()
    vg = make_minibatch_value_and_grad(X, y, D, S, M, 0,
                                       streaming_block=BLOCK)
    q0 = 0.1 * torch.randn(CHAINS, reduced_dim(D, S, M),
                           generator=torch.Generator().manual_seed(1))
    return sgld_sample(vg, q0, 2, num_warmup=0, num_samples=1).samples


RUN = {"gemm": lambda: _stream_step("gemm"),
       "kernel": lambda: _stream_step("kernel"),
       "sgld": _sgld_transition}

# Each case's spans: name -> (count, parent in the trace).
STEP = {"scfgp.grad": (1, None),
        "scfgp.grad.forward": (1, "scfgp.grad"),
        "scfgp.grad.backward": (1, "scfgp.grad"),
        "scfgp.stream.pass1": (1, "scfgp.grad.forward"),
        "scfgp.stream.solve": (1, "scfgp.grad.forward"),
        "scfgp.stream.pass2": (1, "scfgp.grad.forward")}
# The hand-written block backwards: each pass's blocks on the "gemm" route,
# pass 2's on the "kernel" route (K2b takes pass 1's).
BLOCK_BACKWARDS = {"gemm": 2 * BLOCKS, "kernel": BLOCKS, "sgld": 2 * BLOCKS}
EXPECTED = {
    "gemm": {**STEP, "scfgp.opt.update": (1, None)},
    "kernel": {**STEP, "scfgp.opt.update": (1, None)},
    "sgld": {**{k: (n, "scfgp.sgld.gradient" if p is None else p)
                for k, (n, p) in STEP.items()},
             "scfgp.sgld.gradient": (1, None),
             "scfgp.sgld.update": (1, None),
             # Pass 1 and pass 2 copy every block, and the backward's
             # recompute of each copies it again.
             "scfgp.stream.trial_copy": (4 * BLOCKS, None)},
}
for _case, _count in BLOCK_BACKWARDS.items():
    EXPECTED[_case]["scfgp.stream.block_backward"] = (
        _count, "scfgp.grad.backward")
# Where the trial-axis copies sit: each pass's, and the recomputes'.
COPY_PARENTS = {"scfgp.stream.pass1": BLOCKS, "scfgp.stream.pass2": BLOCKS,
                "scfgp.stream.block_backward": 2 * BLOCKS}


def _parents(spans):
    """Each span's innermost enclosing span on its thread, by interval."""
    out = []
    for i, (name, tid, a, b) in enumerate(spans):
        best = None
        for j, (_, tid2, a2, b2) in enumerate(spans):
            if j != i and tid2 == tid and a2 <= a and b <= b2 and (
                    best is None or a2 >= spans[best][2]):
                best = j
        out.append(None if best is None else spans[best][0])
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each case once with no profiler, then under ``profiling.trace``:
    its chrome trace's program spans and the store's new records."""
    out = {}
    for case in CASES:
        RUN[case]()
        folder = tmp_path_factory.mktemp(case)
        before = len(profiling.spans())
        with profiling.trace(str(folder)):
            RUN[case]()
        records = profiling.spans()[before:]
        path, = glob.glob(str(folder / "*.json"))
        with open(path) as f:
            doc = json.load(f)
        events = sorted((e for e in doc["traceEvents"]
                         if e.get("ph") == "X"
                         and e.get("name", "").startswith("scfgp.")),
                        key=lambda e: (e["ts"], -e["dur"]))
        out[case] = (events, records, doc.get("baseTimeNanoseconds", 0))
    return out


@pytest.mark.parametrize("case", ["gemm", "kernel"])
def test_spans_off_record_nothing(case, monkeypatch):
    """No profiler: a step leaves the store as it was, and no span syncs,
    makes a CUDA event or opens a profiler range."""
    RUN[case]()

    def refuse(*args, **kwargs):
        raise AssertionError("a span touched the device or the profiler")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling, "_RecordRange", refuse)
    before = len(profiling.spans())
    RUN[case]()
    assert len(profiling.spans()) == before
    off = profiling.span("scfgp.test", rows=1)
    assert off is profiling.span("scfgp.test")
    with off as rec:
        assert rec is None


@pytest.mark.parametrize("case", CASES)
def test_trace_holds_each_site_with_its_count_and_nesting(case, traced):
    events, _, _ = traced[case]
    spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
             for e in events]
    counts = Counter(s[0] for s in spans)
    assert counts == Counter({k: n for k, (n, _) in EXPECTED[case].items()})
    parents = _parents(spans)
    copies = Counter()
    for (name, *_), parent in zip(spans, parents):
        if name == "scfgp.stream.trial_copy":
            copies[parent] += 1
        else:
            assert parent == EXPECTED[case][name][1], name
    assert copies == Counter(COPY_PARENTS if case == "sgld" else {})


@pytest.mark.parametrize("case", CASES)
def test_store_matches_trace(case, traced):
    """The store's records: the trace's spans, with the same parents, and
    host start and end on the trace's clock to 50 µs."""
    events, records, base = traced[case]
    assert len(records) == len(events)
    records = sorted(records, key=lambda r: (r.start_ns, -r.end_ns))
    by_id = {r.id: r for r in records}
    spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
             for e in events]
    for e, r, parent in zip(events, records, _parents(spans)):
        assert r.name == e["name"]
        assert r.thread == e["tid"]
        assert abs((r.start_ns - base) / 1e3 - e["ts"]) < 50.0, r.name
        assert abs((r.end_ns - base) / 1e3 - (e["ts"] + e["dur"])) < 50.0
        assert (by_id[r.parent].name if r.parent is not None
                else None) == parent
        if r.name.startswith("scfgp.stream.") and r.name not in (
                "scfgp.stream.trial_copy", "scfgp.stream.block_backward"):
            assert r.attrs == {"route": "kernel" if case == "kernel"
                               else "gemm", "rows": N, "blocks": BLOCKS}


def test_trial_copy_bytes(traced):
    """Each copy writes a block of X for every chain in float32."""
    _, records, _ = traced["sgld"]
    copies = [r for r in records if r.name == "scfgp.stream.trial_copy"]
    assert len(copies) == 4 * BLOCKS
    assert {r.attrs["bytes"] for r in copies} == {CHAINS * BLOCK * D * 4}


def test_store_leaves_the_garbage_collector_no_work(traced):
    """Once collected, no record of the store is tracked by the garbage
    collector, so a full collection does not grow with the store."""
    import gc

    gc.collect()
    assert len(profiling._store) > 0
    assert not any(gc.is_tracked(r) for r in profiling._store)


@pytest.mark.parametrize("case", CASES)
def test_block_backward_spans(case, traced):
    """One step records ``scfgp.stream.block_backward`` once a block a
    pass that the route differentiates by hand (both passes on the "gemm"
    route, pass 2 on the "kernel" route), each inside
    ``scfgp.grad.backward``, with its pass, route, trials and rows."""
    _, records, _ = traced[case]
    by_id = {r.id: r for r in records}
    blocks = [r for r in records if r.name == "scfgp.stream.block_backward"]
    assert len(blocks) == BLOCK_BACKWARDS[case]
    for r in blocks:
        assert by_id[r.parent].name == "scfgp.grad.backward"
    passes = (1, 2) if case != "kernel" else (2,)
    assert Counter(r.attrs["pass_"] for r in blocks) == Counter(
        {n: BLOCKS for n in passes})
    assert {tuple(sorted(r.attrs.items())) for r in blocks} == {
        (("pass_", n), ("route", "kernel" if case == "kernel" else "gemm"),
         ("rows", BLOCK), ("trials", CHAINS if case == "sgld" else 1))
        for n in passes}


def test_allreduce_span_carries_its_bytes(tmp_path):
    """Each all-reduce of ``ops/collectives.py`` is one span with the bytes
    it reduces (a world of one rank over gloo)."""
    import torch.distributed as dist

    from scfgp_tpu_torch.ops.collectives import all_reduce_sum, psum

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        group = dist.new_group([0])
        x = torch.ones(5, requires_grad=True)
        before = len(profiling.spans())
        with profiling.trace(str(tmp_path / "trace")):
            psum(x, group).sum().backward()
            all_reduce_sum([torch.ones(3), torch.ones(2, 2)], group)
    finally:
        dist.destroy_process_group()
    records = profiling.spans()[before:]
    assert [(r.name, r.attrs) for r in records] == [
        ("scfgp.allreduce", {"bytes": 20}), ("scfgp.allreduce", {"bytes": 20}),
        ("scfgp.allreduce", {"bytes": 28})]
