"""The control on the card: the reference in TF32 put in the program's
place comes out not correct by the cell's limits, at a size a test run
holds (every width as the cell's, fewer rows).  Needs the card; skips
without one.  Run on the card: ``python -m pytest portbench/tests -q -k
control``."""

import importlib
from types import SimpleNamespace

import pytest
import torch

from portbench import check
from portbench import run as R

ROWS = {"d256_stream_kernel": dict(n_rows=65536),
        "d256_ula4_stream": dict(n_rows=65536)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control's TF32 exists only there")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("workload", sorted(ROWS))
def test_control_is_not_correct(card, workload, seed):
    cell = R.load_json("workloads", workload)
    cfg = dict(R.load_json("configs", cell["config"]))
    mix = dict(cell["traffic"])
    for k, v in ROWS[workload].items():
        (cfg if k in cfg else mix)[k] = v
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    sess = driver.setup(SimpleNamespace(config=cfg, traffic=mix, seed=seed,
                                        device=card, fault=None, chips=1))
    for _ in range(3):
        sess.unit()
    sess.release()
    correct, rows = check.judge(sess.control_readings(), cell["limits"])
    assert not correct, rows
