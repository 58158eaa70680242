"""A whole run of each cell, the look for a card skipped, at a size a test
holds on the CPU: with the timed path broken underneath, it comes out not
correct by the cell's limits; sound, its numbers read at rounding level
(the limits are set for the cell's own size, on the card).  The faults a
single-card training or sampling cell can have: a step that returns its
state unchanged, and half of the rows left out with the mean taken over
the rest; the four-rank cell's also the exchange between ranks left
out."""

import pytest
import torch

from portbench import run as R

SMALL = {
    "d256_stream_kernel": dict(n_rows=3000, input_dim=16, sparsity=4,
                               nfeats=12, block_size=1024),
    "d256_ula4_stream": dict(n_rows=3000, input_dim=16, sparsity=4,
                             nfeats=12, block_size=1024),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [None, "frozen", "half"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fault_makes_the_run_incorrect(workload, fault):
    res = R.run(workload, 2 ** 31 + 17, 0.2, False, device="cpu",
                overrides=SMALL[workload], fault=fault)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if fault is None:
        assert max(r["value"] for r in res["checks"].values()) < 1e-3
    else:
        assert res["correct"] is False, res["checks"]


DP_SMALL = dict(n_rows=2000, input_dim=16, sparsity=4, nfeats=12,
                block_size=512)


@pytest.mark.parametrize("fault", [None, "exchange", "half", "frozen"])
def test_data_parallel_fault_makes_the_run_incorrect(fault):
    """The four-rank cell's whole run on two CPU ranks over gloo; the
    exchange between ranks left out is its fault of its own."""
    import time

    from scfgp_tpu_torch.parallel import launch
    res = R.merge(launch.run(
        R._rank_run, 2, "d256_dp4_stream_kernel", 2 ** 31 + 5, 0.2, False,
        time.perf_counter(), "cpu", DP_SMALL, fault, device="cpu",
        threads=1))
    assert res["attempted"] >= 1 and list(res)[-1] == "checks"
    if fault is None:
        assert max(r["value"] for r in res["checks"].values()) < 1e-3
        assert res["checks"]["rank_gap"]["value"] == 0.0
    else:
        assert res["correct"] is False, res["checks"]
