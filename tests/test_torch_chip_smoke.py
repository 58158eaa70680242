"""chip_smoke.py and experiments/kernel_ab.py keep timing the kernels where
the streaming path runs them: K1f and K1b (pass 2) and K2f and K2b (pass 1)
at one block of phase 9, (block, D, S + M)."""

import contextlib
import os
import sys

import numpy as np
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
    9, with the served kin8nm model beside it (and, for K1f, the batched
    shapes of phase 11a)."""
    first, *beside = chip_smoke.KERNELS_LINE_SHAPES[kernel]
    rows = {row[0]: tuple(row[1:4]) for row in getattr(chip_smoke, shapes)}
    rows.update({"batch-" + row[0]: tuple(row[2:5])
                 for row in chip_smoke.BATCH_SHAPES})
    assert rows[first] == BLOCK
    assert "kin8nm" in beside and all(at in rows for at in beside)


@pytest.mark.parametrize("name", ["batch-boston", "batch-bayes",
                                  "batch-tempered"])
def test_kernel_ab_times_the_batched_shapes_of_phase_11a(name):
    """kernel_ab's batched shapes are phase 11a's (B, N, D, K), and the
    kernels line reports each of them beside its first shape."""
    batch = {"batch-" + row[0]: tuple(row[1:])
             for row in chip_smoke.BATCH_SHAPES}
    assert kernel_ab.BATCH_SHAPES[name] == batch[name]
    for kernel in ("phi_fwd", "phi_bwd"):
        assert name in chip_smoke.KERNELS_LINE_SHAPES[kernel]


def test_kernel_ab_digest_tells_bitwise_equal_outputs():
    """Two trees' outputs compare by digest: equal bits give equal digests,
    one ulp or the sign of a zero gives another."""
    a = torch.tensor([[1.0, 0.0], [2.5, -3.0]])
    b = a.clone()
    b[0, 0] = torch.nextafter(b[0, 0], torch.tensor(2.0))
    z = a.clone()
    z[0, 1] = -0.0
    assert kernel_ab.digest([a, a[0]]) == kernel_ab.digest([a.clone(),
                                                            a[0].clone()])
    assert len({kernel_ab.digest([t]) for t in (a, b, z)}) == 3


def test_kernel_ab_batched_inputs_have_a_trial_axis():
    t = kernel_ab.inputs(5, 3, 4, "cpu", trials=2)
    assert [tuple(t[key].shape) for key in ("X", "F", "p", "s", "g")] == [
        (2, 5, 3), (2, 3, 4), (2, 4), (2,), (2, 5, 8)]
    assert torch.equal(t["X"], kernel_ab.inputs(5, 3, 4, "cpu", 2)["X"])


def test_kernel_ab_times_the_streaming_block_and_the_kernels_line_shapes():
    assert kernel_ab.SHAPES["block"] == BLOCK
    assert set(kernel_ab.KERNELS) == {"phi_fwd", "phi_bwd", "gram_fwd",
                                      "gram_bwd"}
    k1 = {row[0]: tuple(row[1:]) for row in chip_smoke.K1_SHAPES}
    for name in ("kin8nm", "bench", "d256", "block"):
        assert kernel_ab.SHAPES[name] == k1[name]


@pytest.mark.parametrize("obj", ["COST", "SCORE"])
def test_per_trial_products_replay_sequential_fits_bitwise(obj):
    """Phase 11b's witness: a float32 fit_fast_batch whose products past Phi
    run per trial replays each trial's sequential fit_fast bit for bit, so
    the loop's masks, generators and optimizer state are per trial."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
    from scfgp_tpu_torch.models.model import fit_fast_batch
    opt = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
           "max_iter": 60, "cvrg_tol": 1e-5, "max_cvrg": 8, "obj": obj}
    data = []
    for b in range(3):
        X, y = synthetic_gp_rff(n=150, d=3, s=3, m=6, seed=b)
        data.append((X[:120], y[:120], X[120:], y[120:]))

    def models():
        return [SCFGP(sparsity=3, nfeats=8, seed=10 + b, device="cpu",
                      dtype=torch.float32) for b in range(3)]
    seq = models()
    for m, d in zip(seq, data):
        m.fit_fast(*d, **opt)
    bat = models()
    with chip_smoke.per_trial_products():
        fit_fast_batch(bat, data, **opt)
    assert len({len(m.evals["COST"][1]) for m in seq}) > 1
    for mb, ms in zip(bat, seq):
        assert mb.evals["COST"][1] == ms.evals["COST"][1]
        assert chip_smoke.params_equal(mb.params, ms.params)
        assert chip_smoke.params_equal(mb.post, ms.post)
        assert [a.stride() for a in mb.post] == [a.stride() for a in ms.post]
        for metric in ("NMSE", "MNLP", "SCORE", "RMSE"):
            assert mb.evals[metric][1] == ms.evals[metric][1]


def test_kernel_ab_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    assert kernel_ab.main(["--shapes", "kin8nm"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_phase_14_keeps_its_shapes_and_budgets():
    """Phase 14: the streaming log posterior at the campaign's kin8nm width
    in blocks of 1024 (7 of the 6553 rows, the last ragged) at 1, 8 and
    32 chains; fit_bayes(hmc) streaming from the MAP at 20 + 20;
    sgld_scale's ULA leg cut to 5 + 15 (its pSGLD legs at the JAX budgets,
    the driver's defaults), and each leg's estimator on two 16384-row
    blocks of its data; the dynamic NUTS at 8 chains, max_depth 6, 30 +
    30, the host-looped NUTS and HMC 2 transitions each; bench_hmc at 5 +
    5; the campaign --tiny on co2, seed 0, every arm."""
    from scfgp_tpu_torch.experiments import bayes_predictive, sgld_scale
    assert chip_smoke.BAYES_MODEL == dict(sparsity=20, nfeats=50)
    assert chip_smoke.STREAM_BAYES_BLOCK == 1024
    assert chip_smoke.stream_blocks(6553) == 7
    assert chip_smoke.STREAM_BAYES_CHAINS == (1, 8, 32)
    fit = chip_smoke.STREAM_FIT
    assert (fit["sampler"], fit["chain_init"], fit["streaming_block"],
            fit["num_warmup"], fit["num_samples"]) == ("hmc", "map", 1024,
                                                       20, 20)
    assert chip_smoke.ULA_ARGS == ["--warmup", "5", "--samples", "15"]
    assert sgld_scale.BATCHES == (4096, 16384)
    assert chip_smoke.SGLD_CHECK_ROWS == 2 * 16384
    assert chip_smoke.DYNAMIC_NUTS == dict(num_warmup=30, num_samples=30,
                                           max_depth=6, init_step_size=0.003)
    assert chip_smoke.HOST_NUTS == dict(chip_smoke.DYNAMIC_NUTS,
                                        num_warmup=0, num_samples=2)
    assert (chip_smoke.HOST_HMC["num_warmup"],
            chip_smoke.HOST_HMC["num_samples"]) == (0, 2)
    assert chip_smoke.BENCH_HMC_ARGS == ["--warmup", "5", "--samples", "5"]
    assert chip_smoke.CAMPAIGN_ARGS == ["--tiny", "--datasets", "co2",
                                        "--seeds", "1"]
    assert "co2" in bayes_predictive.DATASETS
    assert chip_smoke.STREAM_MIX_TOL <= 1e-3
    assert chip_smoke.ULA_PEAK_BOUND <= 2 << 30


def test_phase_15_keeps_its_shapes_and_budgets():
    """Phase 15: 15a at the kin8nm protocol of phase 7; 15b on two ranks:
    the streaming width of BASELINE.json's multi-host config (N=1e6,
    D=256, S=56, M=200, block 16384, 5e5 rows a rank), TP on a (1, 2) mesh
    at S+M = 256 over one block of rows, fit_fast_batch of 3 boston
    trials; 15c the scaling driver at 1 and 2 ranks."""
    cfg = chip_smoke.parallel_config()
    assert chip_smoke.PARALLEL_RANKS == 2
    assert cfg["stream"] == dict(N=1_000_000, D=256, S=56, M=200,
                                 block=16384)
    assert cfg["stream"]["N"] // chip_smoke.PARALLEL_RANKS == 500_000
    assert cfg["tp"] == dict(mesh=(1, 2), rows=16384)
    assert (cfg["stream"]["S"] + cfg["stream"]["M"]) % cfg["tp"]["mesh"][1] \
        == 0
    assert cfg["dp"]["model"] == cfg["fit"]["model"] == dict(sparsity=-1,
                                                             nfeats=269)
    assert cfg["fit"]["kw"] == chip_smoke.FIT_FAST_KW
    assert cfg["batch"]["B"] == 3 and cfg["need_kernels"]
    assert chip_smoke.SCALING_ARGS == ["--ranks", "1", "2"]


def test_phase_15b_rank_checks_run_on_two_cpu_ranks():
    """15b's rank function, rehearsed at a small size on two gloo ranks of
    the CPU (the plain versions; no kernel to count): every check within
    its phase's bound, every digest equal across the ranks, the sharded
    batch bitwise the unsharded one."""
    from scfgp_tpu_torch.parallel import launch
    small = dict(sparsity=3, nfeats=8)
    cfg = chip_smoke.parallel_config("cpu")
    cfg.update(dp=dict(model=small, rows=300),
               fit=dict(model=small, rows=300,
                        kw=dict(chip_smoke.FIT_FAST_KW, max_iter=35)),
               stream=dict(N=4096, D=16, S=4, M=12, block=512),
               tp=dict(mesh=(1, 2), rows=512),
               batch=dict(B=3, model=small, rows=100))
    assert not cfg["need_kernels"]
    r0, r1 = launch.run(chip_smoke.parallel_rank_checks, 2, cfg,
                        device="cpu", threads=1, timeout=300)
    assert r0["backend"] == "gloo" and r0["world"] == 2
    for key in ("dp", "tp", "fit_fast"):
        assert r0[key]["digest"] == r1[key]["digest"], key
    for row in (r0["dp"], r0["tp"]):
        assert row["cost_rel_err"] <= chip_smoke.COST_TOL
        assert max(row["grad_rel_err"].values()) <= chip_smoke.GRAD_TOL
    for route, row in r0["stream"].items():
        assert row["digest"] == r1["stream"][route]["digest"]
        assert row["rows"] == 2048
        assert row["cost_rel_err"] <= chip_smoke.STREAM_COST_TOL
        assert max(row["grad_rel_err"].values()) <= chip_smoke.STREAM_GRAD_TOL
    assert r0["batch"]["digests"] == r1["batch"]["digests"]
    assert r0["batch"]["bitwise"] == [True] * 3
    for r in (r0, r1):  # the kernel-vs-plain rows, every rank's shapes
        for key in ("dp", "tp", "batch"):
            row = r[key]["vs_plain"]
            assert row["cost_rel_err"] <= chip_smoke.COST_TOL, key
            assert max(row["grad_rel_err"].values()) <= chip_smoke.GRAD_TOL
        assert r["dp"]["vs_plain"]["n"] == 150
        assert (r["tp"]["vs_plain"]["n"], r["tp"]["vs_plain"]["k"]) == (512, 8)
    assert [r["batch"]["vs_plain"]["trials"] for r in (r0, r1)] == [[0, 1],
                                                                    [2, 2]]


def test_phase_15d_keeps_its_width_and_budgets():
    """15d: 8 chains, 4 a rank on 2 ranks, at phase 12's width; HMC at 10 +
    10 transitions of 8 leapfrog steps (shared and fleet), the static NUTS
    fleet at depth 3 and pSGLD at 10 + 10 steps on 512-row minibatches:
    1 + 8, 8 and 1 batched gradients a transition."""
    assert chip_smoke.CHAIN_SHARDED // chip_smoke.PARALLEL_RANKS == 4
    assert chip_smoke.BAYES_MODEL == dict(sparsity=20, nfeats=50)
    runs = chip_smoke.CHAIN_RUNS
    assert [runs[n][0] for n in runs] == ["hmc", "hmc", "nuts_static",
                                         "sgld"]
    assert runs["hmc_fleet"][1]["shared_adaptation"] is False
    assert runs["nuts_fleet"][1]["shared_adaptation"] is False
    assert [chip_smoke.chain_gradients(n) for n in runs] == [180, 180, 160,
                                                             20]
    assert chip_smoke.CHAIN_SGLD_BATCH == 512


def test_phase_15d_rank_checks_run_on_two_cpu_ranks():
    """15d's rank function, rehearsed on two gloo ranks of the CPU in
    float64 at a small width (D=2, S=2, M=4, 600 rows: SGLD's minibatch of
    512 is a draw of rows), against the same runs unsharded in this
    process with the log density taken in blocks of a rank's chains: every
    field bitwise, no accept decision flipped, the counts equal, the
    ranks' gathered fields the same; the dry run's four chain-sharded
    parts on each rank; and each rank's kernel-against-plain rows at a
    rank's chains on all the rows and on a minibatch."""
    from scfgp_tpu_torch.bayes import reduced_dim
    from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
    from scfgp_tpu_torch.models.params import init_params, pack_params
    from scfgp_tpu_torch.parallel import launch
    D, S, M = 2, 2, 4
    X, y = synthetic_gp_rff(n=600, d=D, s=S, m=M, noise_std=0.1, seed=0,
                            dtype=np.float64)
    gen = torch.Generator().manual_seed(3)
    q0 = torch.stack([pack_params(init_params(gen, D, S, M,
                                              dtype=torch.float64))
                      [:reduced_dim(D, S, M)]
                      for _ in range(chip_smoke.CHAIN_SHARDED)])
    cfg = dict(device="cpu", data=(X, y, (D, S, M)), q0=q0.numpy())
    res = launch.run(chip_smoke.chain_rank_checks, 2, cfg, device="cpu",
                     threads=1, timeout=300)
    data = (torch.as_tensor(X), torch.as_tensor(y), (D, S, M))
    with _threads(1):
        ref = {name: chip_smoke.chain_fields(chip_smoke.chain_sample(
            name, data, q0, torch.Generator().manual_seed(seed),
            block=chip_smoke.CHAIN_SHARDED // 2))
            for name, (_, _, seed) in chip_smoke.CHAIN_RUNS.items()}
    rows = chip_smoke.chain_rows(res, ref)
    assert set(rows) == {"hmc", "hmc_fleet", "nuts_fleet", "sgld"}
    for name, row in rows.items():
        assert not row["accept_flips"], (name, row)
        assert all(row["counts_equal"].values()) and row["digests_equal"]
        assert all(row["bitwise"].values()), (name, row)
        assert res[0][name]["chains"] == chip_smoke.CHAIN_SHARDED // 2
    for r in res:
        assert set(r["dryrun"]) == {"hmc", "hmc_fleet", "nuts_fleet", "sgld"}
        assert r["dryrun"] == res[0]["dryrun"]
        plain = r["vs_plain"]
        assert [(plain[w]["chains"], plain[w]["rows"])
                for w in ("logposterior", "minibatch")] == [(4, 600), (4, 512)]
        for row in plain.values():
            assert row["finite"]
            assert row["ld_rel_err"] <= chip_smoke.COST_TOL
            assert max(row["grad_rel_err"].values()) <= chip_smoke.GRAD_TOL


@contextlib.contextmanager
def _threads(n):
    """torch on ``n`` threads inside, as a rank of ``launch.run(...,
    threads=n)`` runs: a CPU reduction may split by the thread count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


KERNELS = ("phi_fwd", "phi_bwd", "gram_fwd", "gram_bwd", "cholesky",
           "cholesky_inverse")


class _Wrapper:
    launches = 0


def test_phase_15c_holds_every_kernels_count(monkeypatch, tmp_path):
    """The scaling driver's rank returns every kernel's launches, and 15c
    holds each rank's counts as every other path's: K1f and K1b launched,
    K3 and K4 not, and every kernel counted."""
    from scfgp_tpu_torch.experiments import synthetic_scaling
    from scfgp_tpu_torch.parallel import launch
    with launch.local_world("cpu"):
        res = synthetic_scaling.scaling_rank(dict(
            device="cpu", rows_per_device=32, dim=3, sparsity=2, nfeats=4,
            steps=2))
    assert res["launches"] == dict.fromkeys(KERNELS, 0)  # no card

    def run(**counts):
        launches = chip_smoke.Launches(**{k: _Wrapper() for k in KERNELS})
        row = dict(dict.fromkeys(KERNELS, 0), phi_fwd=6, phi_bwd=2)
        row.update(counts)
        monkeypatch.setattr(synthetic_scaling, "main", lambda argv: {
            "points": [{"ranks": 2, "costs_equal": True,
                        "launches": [row, dict(row)]}]})
        chip_smoke.parallel_scaling_phase(launches, str(tmp_path))
        return launches.by_path

    assert run() == {f"15c scaling, 2 rank(s) (rank {r})":
                     dict(dict.fromkeys(KERNELS, 0), phi_fwd=6, phi_bwd=2)
                     for r in (0, 1)}
    for bad in (dict(phi_bwd=0), dict(cholesky=1), dict(cholesky_inverse=3)):
        with pytest.raises(AssertionError):
            run(**bad)
    with pytest.raises(AssertionError, match="every kernel"):
        launches = chip_smoke.Launches(**{k: _Wrapper() for k in KERNELS})
        launches.record("a path", dict(phi_fwd=1, phi_bwd=1))
