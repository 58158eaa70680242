"""Per-rank checks of the port's parallel layer.

``tests/test_torch_parallel.py`` runs these on W gloo ranks through
``scfgp_tpu_torch.parallel.launch`` (one spawn a world size; the world of
8 runs the data-parallel and the tensor-parallel checks, the world of 2
the chain-sharded samplers) and holds what they return against the JAX
package and the single-device port.  This module imports only
torch and the port, never ``tests/conftest.py`` (which imports JAX), so
that a rank starts from a fresh import of the port alone.
"""

import os

import torch
import torch.distributed as dist

from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.bayes import (hmc_sample, make_logposterior,
                                   make_minibatch_value_and_grad,
                                   nuts_sample, nuts_sample_static,
                                   sgld_sample)
from scfgp_tpu_torch.models.model import fit_fast_batch
from scfgp_tpu_torch.models.objective import loss_and_grad, loss_fn
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
from scfgp_tpu_torch.opt.optimizers import make_optimizer
from scfgp_tpu_torch.parallel import (make_dp_eval, make_dp_train_step,
                                      gather_chains, make_mesh,
                                      make_mesh2d, shard_chains, shard_rows,
                                      shard_rows_2d, tp_loss,
                                      tp_loss_and_grad, make_tp_train_step)
from scfgp_tpu_torch.parallel.multihost import (init_distributed,
                                                is_coordinator)

MODES = ("gspmd", "shard_map")
ADAM = {"learning_rate": 0.01}
DEVICE = "cpu"


def _np(tree):
    return [t.detach().cpu().numpy() for t in tree]


def _data(case):
    theta, X, y = case
    return (params_from_numpy(theta, dtype=torch.float64),
            torch.as_tensor(X), torch.as_tensor(y))


def _shard(mesh, X, y):
    return shard_rows(mesh, X, y, device=DEVICE)


def dp_rank(cfg: dict) -> dict:
    """Loss, gradient and an adam trajectory by both mode names, the
    streaming loss and gradient on both routes, ``fit_fast(mesh=)`` and,
    where asked, ``fit_fast_batch(mesh=)``, one rank's part of the dry
    run and the tensor-parallel checks (``tp_rank``); each beside the
    single-device port where it is cheap."""
    mesh = make_mesh()
    W = dist.get_world_size()
    out = {"rank": dist.get_rank(), "mesh_shape": mesh.shape,
           "coordinator": is_coordinator()}

    p, X, y = _data(cfg["loss"])
    Xs, ys, ws = _shard(mesh, X, y)
    out["shard"] = _np((Xs, ys, ws))
    for mode in MODES:
        cost, post = make_dp_eval(mesh, mode)(p, Xs, ys, ws)
        out[f"loss_{mode}"] = (float(cost), post.alpha.numpy())
    data = mesh.group("data")
    cost, aux = loss_fn(p, Xs, ys, ws, axis_name=data)
    out["loss_fn_group"] = float(cost)
    try:
        loss_fn(p, Xs, ys, ws, axis_name="data")
    except TypeError as e:
        out["name_refused"] = str(e)
    # A later mesh whose "data" dimension is one rank leaves this mesh's
    # group as it was.
    make_mesh2d(1, W)
    out["loss_after_2d_mesh"] = float(
        loss_fn(p, Xs, ys, ws, axis_name=data)[0])
    if W == 1:
        c0, a0 = loss_fn(p, X, y)
        out["world1_bitwise"] = (torch.equal(cost, c0) and all(
            torch.equal(u, v) for u, v in zip(aux.post, a0.post)))

    p, X, y = _data(cfg["grad"])
    Xs, ys, ws = _shard(mesh, X, y)
    (_, _), g = loss_and_grad(p, Xs, ys, ws, axis_name=data)
    out["grad"] = _np(g)

    p, X, y = _data(cfg["trajectory"])
    Xs, ys, ws = _shard(mesh, X, y)
    tx = make_optimizer("adam", ADAM)
    for mode in MODES:
        step = make_dp_train_step(tx, mesh, mode)
        q, st = p, tx.init(p)
        for _ in range(cfg["steps"]):
            q, st, _, _ = step(q, st, Xs, ys, ws)
        out[f"trajectory_{mode}"] = _np(q)

    p, X, y = _data(cfg["grad"])
    Xs, ys, ws = _shard(mesh, X, y)
    for route in ("gemm", "kernel"):
        (c, _), g = loss_and_grad_streaming(
            p, Xs, ys, ws, block_size=cfg["block"], stats_impl=route,
            axis_name=data)
        out[f"stream_{route}"] = (float(c), _np(g))

    Xt, yt, Xv, yv = cfg["fit_data"]
    m = SCFGP(sparsity=3, nfeats=8, seed=5, device=DEVICE,
              dtype=torch.float64)
    m.fit_fast(Xt, yt, Xv, yv, max_iter=40, mesh=mesh)
    out["fit_fast"] = dict(params=_np(m.params),
                           NMSE=m.evals["NMSE"][1][-1],
                           digest=_digest(m.params))

    if "batch" in cfg:
        models = [SCFGP(sparsity=3, nfeats=6, seed=100 + b, device=DEVICE,
                        dtype=torch.float64)
                  for b in range(len(cfg["batch"]))]
        fit_fast_batch(models, cfg["batch"], obj="SCORE", mesh=mesh,
                       **cfg["batch_opt"])
        out["batch"] = [{k: b.evals[k][1][b.min_obj_ind]
                         for k in ("NMSE", "SCORE")} for b in models]
        out["batch_digest"] = _digest([t for b in models for t in b.params])
    if cfg.get("dryrun"):
        from scfgp_tpu_torch.graft_entry import dryrun_rank
        out["dryrun"] = dryrun_rank(W, DEVICE)
    if "tp" in cfg:
        out["tp"] = tp_rank(cfg["tp"])
    if "chains" in cfg:
        out["chains"] = chains_rank(mesh, cfg["chains"])
    return out


class Replay:
    """Draws made elsewhere (the JAX package's, from its key tree), served
    in order; each must have the kind and shape asked for."""

    def __init__(self, items):
        self.items = list(items)

    def _next(self, kind, shape):
        k, a = self.items.pop(0)
        assert k == kind and a.shape == tuple(shape), (k, kind, a.shape,
                                                       shape)
        return torch.as_tensor(a)

    def normal(self, shape):
        return self._next("normal", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def bernoulli(self, shape):
        return self._next("bernoulli", shape)

    def randint(self, high, shape):
        return self._next("randint", shape)


CHAIN_FIELDS = ("samples", "logdensities", "final_positions", "accept_rate",
                "step_size", "inv_mass", "precond", "divergences",
                "nonfinite", "mean_depth", "depths")


def chains_rank(mesh, cfg: dict) -> dict:
    """Each sampler of ``cfg["runs"]`` on this rank's block of the chains
    of ``cfg["q0"]``, with the draws ``cfg["runs"][name]["items"]`` (the
    whole C-chain arrays; each rank keeps its slice), and the dynamic NUTS
    of ``cfg["dynamic"]`` from a generator seeded alike on every rank, in
    float64: this rank's result and the result gathered over the ranks,
    as NumPy; then the refusals of an uneven chain count and of a bare
    axis name."""
    group = mesh.group("data")
    X, y = torch.as_tensor(cfg["X"]), torch.as_tensor(cfg["y"])
    D, S, M = cfg["dims"]
    q = shard_chains(mesh, cfg["q0"], device=DEVICE)
    lp = make_logposterior(X, y, D, S, M)
    out = {}
    runs = dict(cfg["runs"], nuts_dynamic=None)
    for name, run in runs.items():
        rp = Replay(run["items"] if run else ())
        if name == "nuts_dynamic":
            seed, kw = cfg["dynamic"]
            res = nuts_sample(lp, q, torch.Generator().manual_seed(seed),
                              axis_name=group, **kw)
        elif name == "sgld":
            vg = make_minibatch_value_and_grad(X, y, D, S, M,
                                               run["batch"])
            res = sgld_sample(vg, q, rp, axis_name=group, **run["kw"])
        else:
            sampler = hmc_sample if name.startswith("hmc") else \
                nuts_sample_static
            res = sampler(lp, q, rp, axis_name=group, **run["kw"])
        out[name] = {"left": len(rp.items)}
        for tag, r in (("local", res), ("gathered",
                                        gather_chains(mesh, res))):
            out[name][tag] = {f: getattr(r, f).detach().numpy()
                              for f in CHAIN_FIELDS
                              if getattr(r, f, None) is not None}
    try:
        shard_chains(mesh, cfg["q0"][:3])
    except ValueError as e:
        out["uneven_refused"] = str(e)
    try:
        hmc_sample(lp, q, 0, num_warmup=1, num_samples=1, axis_name="data")
    except TypeError as e:
        out["name_refused"] = str(e)
    return out


def tp_rank(cfg: dict) -> dict:
    """The TP loss on each mesh of ``cfg["meshes"]``, the gradient on the
    first, the trajectory on the last, and the divisibility refusal."""
    out = {"rank": dist.get_rank()}
    meshes = [make_mesh2d(*shape) for shape in cfg["meshes"]]
    for shape, mesh in zip(cfg["meshes"], meshes):
        p, X, y = _data(cfg["loss"])
        cost, aux = tp_loss(mesh)(p, *shard_rows_2d(mesh, X, y,
                                                    device=DEVICE))
        out[f"loss_{shape}"] = (float(cost), aux.post.alpha.numpy(),
                                aux.post.L.numpy())

    mesh = meshes[0]
    p, X, y = _data(cfg["grad"])
    (_, _), g = tp_loss_and_grad(mesh, p, *shard_rows_2d(mesh, X, y,
                                                         device=DEVICE))
    out["grad"] = _np(g)

    mesh = meshes[-1]
    p, X, y = _data(cfg["trajectory"])
    data = shard_rows_2d(mesh, X, y, device=DEVICE)
    tx = make_optimizer("adam", ADAM)
    step = make_tp_train_step(tx, mesh)
    q, st = p, tx.init(p)
    for _ in range(cfg["steps"]):
        q, st, _ = step(q, st, *data)
    out["trajectory"] = _np(q)

    p, X, y = _data(cfg["indivisible"])
    try:
        tp_loss(mesh)(p, *data)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def failing_rank():
    raise ArithmeticError(f"rank {dist.get_rank()} fails on purpose")


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def env_join(rank: int, world: int, port: int, results,
             timeout_s: float = 30.0) -> None:
    """``init_distributed`` from the variables torchrun sets, then one
    all-reduce; the summary, ``is_coordinator`` and the sum go to
    ``results``.  A rank that cannot join sends its error instead."""
    import datetime
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        info = init_distributed(device="cpu",
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # the failed join under test
        results.put((rank, "raised", repr(e)))
        return
    t = torch.ones(1) * (rank + 1)
    dist.all_reduce(t)
    results.put((rank, info, is_coordinator(), float(t)))
    dist.destroy_process_group()
