"""The harness is driven by data: every configuration, cell, driver and
per-layer metric is a file of its own, found by its name, and one added
beside them is found without editing any file."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from portbench import run as R

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads(entry):
    cfg = R.load_json("configs", entry["name"])
    assert cfg["name"] == entry["name"]
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_file_loads(entry):
    cell = R.load_json("workloads", entry["name"])
    assert cell["config"] == entry["config"]
    assert cell["chips"] == entry["chips"]
    assert cell["driver"] == entry["traffic"]
    assert (R.HERE / "drivers" / f"{cell['driver']}.py").exists()
    e2e, layer = R.cell_metrics(cell)
    names = {m["name"] for m in e2e}
    assert names == {cell["metric"], "setup_s"}
    assert layer, "every cell reports a per-layer metric"
    assert all(m["moves"] == cell["metric"] for m in layer)
    assert set(cell["limits"]) and all(
        v is not None for v in cell["limits"].values())


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_reader_loads(entry):
    assert callable(R.load_metric(entry["name"]).read)


def test_added_files_are_found_without_edits(tmp_path):
    shutil.copytree(R.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "traces"))
    bench = dict(BENCH)
    pb = tmp_path / "portbench"
    (pb / "drivers" / "dummy_kind.py").write_text(textwrap.dedent("""
        class Session:
            work_per_unit, steps_per_unit, flops_per_step = 1.0, 1, 1.0
            def __init__(self, ctx):
                self.ctx = ctx
            def unit(self):
                pass
            def failed(self):
                return 0
            def release(self):
                pass
            def readings(self):
                return {"dummy_gap": 0.0}
        def setup(ctx):
            return Session(ctx)
        """))
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"name": "dummy_cfg", "reduced": []}))
    (pb / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"name": "dummy_cell", "config": "dummy_cfg", "chips": 1,
         "driver": "dummy_kind", "metric": "dummy_per_s", "why": "test",
         "traffic": {}, "limits": {"dummy_gap": 0.0}}))
    (pb / "metrics" / "dummy_units.x.py").write_text(
        "def read(reading, run):\n    return 42.0\n")
    bench["end_to_end"] = BENCH["end_to_end"] + [
        {"name": "dummy_per_s", "unit": "1/s", "better": "higher",
         "bound": 0.05, "source": "host_clock", "workloads": ["dummy_cell"]}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "dummy_units.x", "unit": "1", "better": "higher",
         "source": "program_counter", "layer": "test", "moves":
         "dummy_per_s", "workloads": ["dummy_cell"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import json
        from portbench import run as R
        res = R.run("dummy_cell", 3, 0.05, False, device="cpu")
        e2e, layer = R.cell_metrics(R.load_json("workloads", "dummy_cell"))
        print(json.dumps([res["correct"], sorted(res["metrics"]),
                          [m["name"] for m in layer],
                          R.load_metric("dummy_units.x").read(None, None)]))
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    correct, metrics, layer, value = json.loads(out.stdout.splitlines()[-1])
    assert correct is True
    assert metrics == ["dummy_per_s", "setup_s"]
    assert layer == ["dummy_units.x"] and value == 42.0


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in BENCH["configs"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
