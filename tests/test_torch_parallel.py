"""The port's data parallelism against the JAX package and against the
single-device port: ``parallel/mesh.py``, ``dp.py``, ``multihost.py``,
``launch.py``, ``loss_fn``/``loss_fn_streaming`` with ``axis_name``,
``fit_fast(mesh=)`` and ``fit_fast_batch(mesh=)``; and its feature-axis
tensor parallelism (``parallel/tp.py``) on 2-D (data, feature) meshes of
8 ranks.

The port runs W gloo ranks on the CPU (``parallel/launch.py``), once a
world size for the module (``tests/_torch_parallel_ranks.py``; the world
of 8 also runs the tensor-parallel checks); the JAX side runs on
conftest's 8 virtual CPU devices, a mesh of the first W.
Both get the same θ and data as NumPy arrays, in float64.  Tolerances:
  * loss: rtol 1e-12 (the JAX sharded-loss test's), alpha rtol 1e-9;
  * gradient: rtol 1e-9, atol 1e-12 (phase leaves are pure gauge, ~0);
  * 20 adam steps: rtol 1e-6, atol 1e-9 (tests/test_parallel.py:66-82);
  * streaming: rtol 1e-10 against the single-device stream;
  * fit_fast(mesh=): tests/test_parallel.py:99-121's, params rtol 2e-5,
    atol 1e-7, NMSE rtol 1e-4; fit_fast_batch(mesh=): the metrics at rtol
    1e-5 (tests/test_batch_fit.py:137-151);
  * TP (tests/test_tp.py's): loss rtol 1e-10, alpha and L rtol 1e-8 (L
    atol 1e-10), gradient rtol 1e-7 atol 1e-11, 15 adam steps rtol 1e-6
    atol 1e-9.
A world of one rank is bitwise the plain ``loss_fn``.
"""

import functools
import multiprocessing as mp
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from scfgp_tpu.models.objective import loss_fn as jax_loss_fn
from scfgp_tpu.models.params import init_params as jax_init_params
from scfgp_tpu.parallel import mesh as jmesh
from scfgp_tpu.parallel.dp import make_dp_eval as jax_dp_eval
from scfgp_tpu.opt.optimizers import make_optimizer as jax_make_optimizer
from scfgp_tpu.opt.optimizers import tree_add as jax_tree_add
from scfgp_tpu.parallel.tp import shard_rows_2d as jax_shard_rows_2d
from scfgp_tpu.parallel.tp import tp_loss as jax_tp_loss
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
from scfgp_tpu_torch.models.model import fit_fast_batch
from scfgp_tpu_torch.models.objective import loss_and_grad
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
from scfgp_tpu_torch.opt.optimizers import make_optimizer, tree_add
from scfgp_tpu_torch.parallel import launch, pad_rows
from scfgp_tpu_torch.parallel.dp import make_dp_train_step
from scfgp_tpu_torch.parallel.multihost import (init_distributed,
                                                is_coordinator)

torch.set_num_threads(1)

N, D, S, M = 103, 6, 4, 9  # N not divisible by 2, 3 or 8: the pad path
WORLDS = (1, 2, 3, 8)
MODES = ("gspmd", "shard_map")
STEPS = 20
BLOCK = 16
BATCH_OPT = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
             "max_iter": 40, "cvrg_tol": 1e-6, "max_cvrg": 10}


def _problem(seed):
    rng = np.random.RandomState(seed)
    X, y = rng.randn(N, D), rng.randn(N)
    theta = [np.asarray(a) for a in
             jax_init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)]
    return theta, X, y


def _jax_params(theta):
    from scfgp_tpu.models.params import SCFGPParams
    return SCFGPParams(*[jnp.asarray(a) for a in theta])


def _port(case):
    theta, X, y = case
    return (params_from_numpy(theta, dtype=torch.float64),
            torch.as_tensor(X), torch.as_tensor(y))


def _fit_data():
    X, y = synthetic_gp_rff(n=220, d=3, s=3, m=8, noise_std=0.1, seed=0)
    return X[:180], y[:180], X[180:], y[180:]


def _batch_splits(B, n=120, d=3):
    out = []
    for b in range(B):
        X, y = synthetic_gp_rff(n=n + 30, d=d, s=3, m=6, seed=b,
                                dtype=np.float64)
        out.append((X[:n], y[:n], X[n:], y[n:]))
    return out


CASES = {"loss": _problem(0), "grad": _problem(1), "trajectory": _problem(2)}

TP_N, TP_D, TP_S, TP_M = 97, 5, 4, 12  # S+M = 16: feature sizes 2 and 4
TP_MESHES = [(4, 2), (2, 4)]
TP_STEPS = 15


def _tp_problem(seed, s=TP_S, m=TP_M):
    rng = np.random.RandomState(seed)
    X, y = rng.randn(TP_N, TP_D), rng.randn(TP_N)
    theta = [np.asarray(a) for a in
             jax_init_params(jax.random.PRNGKey(seed), TP_D, s, m,
                             jnp.float64)]
    return theta, X, y


TP_CASES = {"loss": _tp_problem(0), "grad": _tp_problem(1),
            "trajectory": _tp_problem(2),
            "indivisible": _tp_problem(0, s=3, m=10)}  # S+M = 13

# The JAX references, each computed once (jitted), and all of them while
# the ranks run (``worlds``).


def _jax_case(case):
    theta, X, y = case
    return _jax_params(theta), jnp.asarray(X), jnp.asarray(y)


@functools.cache
def _jax_loss(cases="dp"):
    p, X, y = _jax_case((CASES if cases == "dp" else TP_CASES)["loss"])
    return jax.jit(jax_loss_fn)(p, X, y)


@functools.cache
def _jax_dp_loss(W, mode):
    theta, X, y = CASES["loss"]
    mesh = jmesh.make_mesh(jax.devices()[:W])
    return jax_dp_eval(mesh, mode)(_jax_params(theta),
                                   *jmesh.shard_rows(mesh, X, y))


@functools.cache
def _jax_grad(cases="dp"):
    p, X, y = _jax_case((CASES if cases == "dp" else TP_CASES)["grad"])
    return jax.tree.leaves(jax.jit(jax.grad(
        lambda q: jax_loss_fn(q, X, y)[0]))(p))


@functools.cache
def _jax_trajectory(cases="dp"):
    """STEPS (TP_STEPS) adam steps of JAX's loss from the case
    "trajectory": the final params."""
    p, X, y = _jax_case((CASES if cases == "dp" else TP_CASES)["trajectory"])
    tx = jax_make_optimizer("adam", {"learning_rate": 0.01})
    st = tx.init(p)

    @jax.jit
    def step(p, s):
        g = jax.grad(lambda q: jax_loss_fn(q, X, y)[0])(p)
        delta, s = tx.update(g, s, p)
        return jax_tree_add(p, delta), s
    for _ in range(STEPS if cases == "dp" else TP_STEPS):
        p, st = step(p, st)
    return jax.tree.leaves(p)


@functools.cache
def _jax_tp_loss(shape):
    p, X, y = _jax_case(TP_CASES["loss"])
    mesh = jmesh.make_mesh2d(*shape)
    return jax.jit(jax_tp_loss(mesh))(
        p, *jax_shard_rows_2d(mesh, np.asarray(X), np.asarray(y)))


def _jax_references():
    for cases in ("dp", "tp"):
        _jax_loss(cases)
        _jax_grad(cases)
        _jax_trajectory(cases)
    for W in WORLDS:
        for mode in MODES:
            _jax_dp_loss(W, mode)
    for shape in TP_MESHES:
        _jax_tp_loss(shape)


@pytest.fixture(scope="module")
def worlds():
    """Every world size's rank results, one spawn each, the worlds side by
    side."""
    def run(W):
        cfg = dict(CASES, steps=STEPS, block=BLOCK, fit_data=_fit_data(),
                   dryrun=W == 2)
        if W == 8:
            cfg.update(batch=_batch_splits(5), batch_opt=BATCH_OPT,
                       tp=dict(TP_CASES, meshes=TP_MESHES, steps=TP_STEPS))
        return launch.run(ranks.dp_rank, W, cfg, device="cpu", threads=1,
                          timeout=300)

    def fail():
        try:
            launch.run(ranks.failing_rank, 1, device="cpu", threads=1,
                       timeout=120)
        except RuntimeError as e:
            return e
    collect_joins = _start_joins()
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        failed = pool.submit(fail)
        runs = pool.map(run, WORLDS)
        _jax_references()
        out = dict(zip(WORLDS, runs))
        out["failed"] = failed.result()
    out["joins"] = collect_joins()
    return out


def _close(got, ref, rtol, atol=0.0):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


# -- mesh.py -----------------------------------------------------------------


@pytest.mark.parametrize("multiple", [1, 2, 3, 8, 200])
def test_pad_rows_equals_jax(multiple):
    _, X, y = CASES["loss"]
    for a, b in zip(pad_rows(X, y, multiple), jmesh.pad_rows(X, y, multiple)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("W", WORLDS)
def test_shard_rows_blocks_equal_jax_addressable_shards(worlds, W):
    _, X, y = CASES["loss"]
    mesh = jmesh.make_mesh(jax.devices()[:W])
    for i, arr in enumerate(jmesh.shard_rows(mesh, X, y)):
        shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start
                        or 0)
        for r, res in enumerate(worlds[W]):
            np.testing.assert_array_equal(res["shard"][i],
                                          np.asarray(shards[r].data))


@pytest.mark.parametrize("W", WORLDS)
def test_mesh_shape_by_name_and_coordinator(worlds, W):
    assert [r["mesh_shape"] for r in worlds[W]] == [{"data": W}] * W
    assert [r["coordinator"] for r in worlds[W]] == [True] + [False] * (W - 1)


# -- dp.py -------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("W", WORLDS)
def test_dp_loss_equals_single_device_and_jax(worlds, W, mode):
    cost_ref, _ = _jax_loss()
    cost_j, post_j = _jax_dp_loss(W, mode)
    (c0, a0), _ = loss_and_grad(*_port(CASES["loss"]))
    for res in worlds[W]:
        cost, alpha = res[f"loss_{mode}"]
        np.testing.assert_allclose(cost, float(c0), rtol=1e-12)
        np.testing.assert_allclose(cost, float(cost_j), rtol=1e-12)
        np.testing.assert_allclose(cost, float(cost_ref), rtol=1e-12)
        np.testing.assert_allclose(res["loss_fn_group"], cost, rtol=1e-12)
        np.testing.assert_allclose(alpha, a0.post.alpha.numpy(), rtol=1e-9)
        np.testing.assert_allclose(alpha, np.asarray(post_j.alpha),
                                   rtol=1e-9)


@pytest.mark.parametrize("W", WORLDS)
def test_axis_name_is_an_explicit_mesh_group(worlds, W):
    """A bare name is refused, and a mesh's group keeps meaning that mesh's
    ranks after a later mesh whose ``data`` dimension is one rank."""
    for res in worlds[W]:
        assert "mesh.group('data')" in res["name_refused"]
        assert res["loss_after_2d_mesh"] == res["loss_fn_group"]


def test_dp_world_of_one_is_bitwise_the_plain_loss(worlds):
    assert worlds[1][0]["world1_bitwise"]


@pytest.mark.parametrize("W", WORLDS)
def test_dp_gradient_equals_single_device_and_jax(worlds, W):
    _, g0 = loss_and_grad(*_port(CASES["grad"]))
    for res in worlds[W]:
        _close(res["grad"], [t.numpy() for t in g0], 1e-9, 1e-12)
        _close(res["grad"], _jax_grad(), 1e-9, 1e-12)


@pytest.fixture(scope="module")
def trajectories():
    """STEPS adam steps from CASES["trajectory"]: JAX's and the
    single-device port's final params."""
    q, X_t, y_t = _port(CASES["trajectory"])
    ttx = make_optimizer("adam", {"learning_rate": 0.01})
    ts = ttx.init(q)
    for _ in range(STEPS):
        (_, _), g = loss_and_grad(q, X_t, y_t)
        delta, ts = ttx.update(g, ts, q)
        q = tree_add(q, delta)
    return _jax_trajectory(), [t.numpy() for t in q]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("W", WORLDS)
def test_dp_trajectory_matches_single_device_and_jax(worlds, trajectories,
                                                     W, mode):
    jax_final, port_final = trajectories
    for res in worlds[W]:
        _close(res[f"trajectory_{mode}"], port_final, 1e-6, 1e-9)
        _close(res[f"trajectory_{mode}"], jax_final, 1e-6, 1e-9)


def test_dp_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown dp mode"):
        make_dp_train_step(None, None, mode="pmap")


@pytest.mark.parametrize("route", ["gemm", "kernel"])
@pytest.mark.parametrize("W", WORLDS)
def test_streaming_dp_equals_single_device_stream(worlds, W, route):
    p, X, y = _port(CASES["grad"])
    (c0, _), g0 = loss_and_grad_streaming(p, X, y, block_size=BLOCK,
                                          stats_impl=route)
    for res in worlds[W]:
        cost, grads = res[f"stream_{route}"]
        np.testing.assert_allclose(cost, float(c0), rtol=1e-10)
        _close(grads, [t.numpy() for t in g0], 1e-10, 1e-12)


# -- tp.py -------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp(worlds):
    return [res["tp"] for res in worlds[8]]


@pytest.mark.parametrize("shape", TP_MESHES)
def test_tp_loss_equals_single_device_and_jax(tp, shape):
    cost_j, aux_j = _jax_tp_loss(shape)
    (c0, a0), _ = loss_and_grad(*_port(TP_CASES["loss"]))
    for res in tp:
        cost, alpha, L = res[f"loss_{shape}"]
        for ref_cost, ref_alpha, ref_L in (
                (float(c0), a0.post.alpha.numpy(), a0.post.L.numpy()),
                (float(cost_j), np.asarray(aux_j.post.alpha),
                 np.asarray(aux_j.post.L))):
            np.testing.assert_allclose(cost, ref_cost, rtol=1e-10)
            np.testing.assert_allclose(alpha, ref_alpha, rtol=1e-8)
            np.testing.assert_allclose(L, ref_L, rtol=1e-8, atol=1e-10)


def test_tp_gradient_equals_single_device_and_jax(tp):
    _, g0 = loss_and_grad(*_port(TP_CASES["grad"]))
    for res in tp:
        for got, a, b in zip(res["grad"], g0, _jax_grad("tp")):
            np.testing.assert_allclose(got, a.numpy(), rtol=1e-7, atol=1e-11)
            np.testing.assert_allclose(got, np.asarray(b), rtol=1e-7,
                                       atol=1e-11)


def test_tp_trajectory_matches_single_device(tp):
    for res in tp:
        for got, ref in zip(res["trajectory"], _jax_trajectory("tp")):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6,
                                       atol=1e-9)


def test_tp_ranks_agree(tp):
    for res in tp[1:]:
        for a, b in zip(res["grad"], tp[0]["grad"]):
            np.testing.assert_array_equal(a, b)


def test_tp_requires_divisible_features(tp):
    for res in tp:
        assert "divisible" in res["indivisible"]


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_fit():
    m = SCFGP(sparsity=3, nfeats=8, seed=5, device="cpu",
              dtype=torch.float64)
    m.fit_fast(*_fit_data(), max_iter=40)
    return m


@pytest.mark.parametrize("W", WORLDS)
def test_fit_fast_mesh_matches_fit_fast(worlds, plain_fit, W):
    res = worlds[W]
    assert len({r["fit_fast"]["digest"] for r in res}) == 1
    got = res[0]["fit_fast"]
    _close(got["params"], [t.numpy() for t in plain_fit.params], 2e-5, 1e-7)
    np.testing.assert_allclose(got["NMSE"], plain_fit.evals["NMSE"][1][-1],
                               rtol=1e-4)
    if W == 1:  # one rank: the same bits
        _close(got["params"], [t.numpy() for t in plain_fit.params], 0.0)


def test_fit_fast_batch_mesh_matches_unsharded(worlds):
    """B = 5 trials over 8 ranks: trial padding, every rank gets every
    trial's result."""
    res = worlds[8]
    splits = _batch_splits(5)
    plain = [SCFGP(sparsity=3, nfeats=6, seed=100 + b, device="cpu",
                   dtype=torch.float64) for b in range(5)]
    fit_fast_batch(plain, splits, obj="SCORE", **BATCH_OPT)
    assert len({r["batch_digest"] for r in res}) == 1
    for got, mp_ in zip(res[0]["batch"], plain):
        for metric in ("NMSE", "SCORE"):
            np.testing.assert_allclose(
                got[metric], mp_.evals[metric][1][mp_.min_obj_ind],
                rtol=1e-5, err_msg=metric)


def test_dryrun_multichip_rank_runs_every_mode(worlds):
    for res in worlds[2]:
        assert set(res["dryrun"]) == {"gspmd", "shard_map", "tp",
                                      "streaming", "fit_fast",
                                      "fit_fast_batch"}
        assert len(res["dryrun"]["fit_fast_batch"]) == 3


# -- multihost.py and launch.py ----------------------------------------------


def test_init_distributed_is_a_no_op_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    info = init_distributed(device="cpu")
    assert info["process_count"] == 1 and info["process_id"] == 0
    assert not torch.distributed.is_initialized()
    assert is_coordinator()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_joins():
    """Two processes joined from the environment, and beside them rank 0
    of another world of two, alone, whose join must time out; returns a
    function that collects their results by world."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    plan = [("pair", 0, 2, 60), ("pair", 1, 2, 60), ("alone", 0, 2, 3)]
    ports = {"pair": _free_port(), "alone": _free_port()}
    procs = [ctx.Process(target=ranks.env_join,
                         args=(rank, world, ports[name], results, timeout))
             for name, rank, world, timeout in plan]
    for p in procs:
        p.start()

    def collect():
        try:
            out = [results.get(timeout=120) for _ in procs]
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        assert not any(p.is_alive() for p in procs)
        return {"alone": [r for r in out if r[1] == "raised"],
                "pair": sorted(r for r in out if r[1] != "raised")}
    return collect


@pytest.fixture(scope="module")
def joins(worlds):
    return worlds["joins"]


def test_init_distributed_joins_two_processes_from_the_environment(joins):
    assert len(joins["pair"]) == 2
    for rank, info, coordinator, total in joins["pair"]:
        assert info["process_id"] == rank and info["process_count"] == 2
        assert coordinator == (rank == 0)
        assert total == 3.0


def test_a_failed_join_raises(joins):
    """Rank 0 of two, alone: the join times out and raises, where the JAX
    version would warn and stay a single process."""
    assert [r[:2] for r in joins["alone"]] == [(0, "raised")], joins


def test_launch_reports_a_failed_rank(worlds):
    assert "fails on purpose" in str(worlds["failed"])


def test_launch_refuses_the_card_where_there_is_none():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run(ranks.failing_rank, 1)

