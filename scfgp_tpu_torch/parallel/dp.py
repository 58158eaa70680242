"""Exact data-parallel training: all-reduced sufficient statistics.

Port of ``scfgp_tpu/parallel/dp.py``.  Every N-dependent term of the SCFGP
objective is a row sum (SURVEY.md §2.4), so the loss over row-sharded data
with the statistics and the expected-NLL sum all-reduced is the full-batch
loss, and its gradient, taken through the differentiable collectives of
``ops/collectives.py`` with the cost divided by the rank count and the
parameter gradient all-reduced (``models/objective.py::value_and_grad``),
is the full-batch gradient on every rank.

The JAX package has two paths to the same math: ``gspmd``, where XLA
partitions the plain loss over arrays carrying a sharding and inserts the
all-reduces, and ``shard_map``, the explicit ``psum``.  No compiler
partitions the port's ctypes kernels, so both mode names are accepted and
both take the explicit all-reduce over the mesh's ``data`` group.  X, y
and w are this rank's rows (``parallel/mesh.py::shard_rows``); params and
optimizer state are replicated, and every output is the same on every
rank.

The reference has no distributed analog (no MPI/NCCL/sockets, SURVEY.md
§2.4); its nearest feature, sequential minibatching with median
aggregation (``reference: SCFGP/SCFGP.py:226-235``), is the model's
``nbatches`` path.
"""

from __future__ import annotations

import torch

from ..models.objective import loss_and_grad, loss_fn
from ..opt.optimizers import Transform, tree_add
from .mesh import DATA_AXIS, Mesh

MODES = ("gspmd", "shard_map")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown dp mode {mode!r}")


def shardmap_loss(mesh: Mesh, axis_name: str = DATA_AXIS):
    """``f(params, X, y, w) -> (cost, post)`` over this rank's rows, the
    statistics all-reduced over the mesh's ``axis_name`` group;
    differentiable."""
    group = mesh.group(axis_name)

    def f(params, X, y, w):
        cost, aux = loss_fn(params, X, y, w=w, axis_name=group)
        return cost, aux.post
    return f


def gspmd_loss(mesh: Mesh):
    """The JAX package's compiler-partitioned loss; in the port the same
    explicit all-reduce as ``shardmap_loss`` (module docstring)."""
    return shardmap_loss(mesh)


def make_dp_train_step(tx: Transform, mesh: Mesh, mode: str = "gspmd",
                       axis_name: str = DATA_AXIS):
    """``step(params, opt_state, X, y, w) -> (params, opt_state, cost,
    post)``: the global loss and gradient and the optimizer's update, the
    same on every rank."""
    _check_mode(mode)
    group = mesh.group(axis_name)

    def step(params, opt_state, X, y, w):
        (cost, aux), grads = loss_and_grad(params, X, y, w=w,
                                           axis_name=group)
        delta, opt_state = tx.update(grads, opt_state, params)
        return tree_add(params, delta), opt_state, cost, aux.post
    return step


def make_dp_eval(mesh: Mesh, mode: str = "gspmd",
                 axis_name: str = DATA_AXIS):
    """The loss without an update (the posterior refresh, the reference's
    train_func): ``f(params, X, y, w) -> (cost, post)``."""
    _check_mode(mode)
    f = shardmap_loss(mesh, axis_name)

    def evaluate(params, X, y, w):
        with torch.no_grad():
            return f(params, X, y, w)
    return evaluate
