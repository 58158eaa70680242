"""Meshes of ranks and row sharding for data-parallel training.

Port of ``scfgp_tpu/parallel/mesh.py``.  JAX runs one process over a
``Mesh`` of devices; PyTorch runs one process a rank
(``parallel/launch.py``).  The port's ``Mesh`` lays the ranks of the
default process group on named dimensions, ``("data",)`` or ``("data",
"feature")``, and is its own table of this rank's ``torch.distributed``
group along each (made here, by ``new_group``, in the same order on every
rank; no ``DeviceMesh``, whose own group creation picks NCCL on a host
with a card, which two ranks sharing one card cannot use).  ``shape`` maps
each dimension's name to its size, as a JAX mesh's does, and
``group(name)`` is the group that a collective of ``ops/collectives.py``
takes where JAX writes the axis name.

Rows of (X, y) are split over ``data`` in contiguous blocks, padded with
zero-weight rows to a multiple of the rank count, so that the sharded
objective is exactly the full-batch objective (every N-dependent term is
a weighted row sum, ``models/objective.py``): the layout of
``NamedSharding(mesh, P("data"))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


class Mesh:
    """The ranks of the default process group on named dimensions,
    row-major (the last dimension innermost: adjacent ranks)."""

    def __init__(self, shape: dict):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs a process group: run under "
                "scfgp_tpu_torch.parallel.launch, torchrun + "
                "init_distributed(), or launch.local_world()")
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{math.prod(sizes)} ranks; the process group "
                             f"has {world}")
        grid = torch.arange(world).reshape(sizes)
        rank = dist.get_rank()
        self._groups = {}
        for dim, name in enumerate(self.axis_names):
            lines = grid.movedim(dim, -1).reshape(-1, sizes[dim]).tolist()
            for ranks in lines:  # every rank makes every group, in order
                group = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                if rank in ranks:
                    self._groups[name] = group
        self.world = dist.group.WORLD

    def group(self, axis_name: str):
        """This rank's group along the dimension ``axis_name``."""
        return self._groups[axis_name]

    def index(self, axis_name: str) -> int:
        """This rank's coordinate along the dimension ``axis_name``."""
        return dist.get_rank(self._groups[axis_name])


def make_mesh(axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over every rank of the default process group."""
    return Mesh({axis_name: dist.get_world_size()})


def make_mesh2d(n_data: int, n_feature: int) -> Mesh:
    """2-D (data, feature) mesh for combined data and tensor parallelism,
    ``feature`` innermost so that the per-step feature collectives
    (``parallel/tp.py``) run between adjacent ranks."""
    return Mesh({DATA_AXIS: n_data, FEATURE_AXIS: n_feature})


def replicated(mesh: Mesh):
    """``tree -> tree`` with every tensor of the tree broadcast from the
    mesh's first rank (``NamedSharding(mesh, P())`` of the JAX package):
    params and optimizer state are then the same on every rank."""
    def place(tree):
        if isinstance(tree, torch.Tensor):
            out = tree.detach().clone()
            dist.broadcast(out, src=0, group=mesh.world)
            return out
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(place(t) for t in tree))
        if isinstance(tree, (tuple, list)):
            return type(tree)(place(t) for t in tree)
        return tree
    return place


def pad_rows(X: np.ndarray, y: np.ndarray, multiple: int):
    """Pad rows to a multiple of the shard count; returns (X, y, w) with
    weight 0 on padding rows.  A copy of
    ``scfgp_tpu/parallel/mesh.py:48-59`` (NumPy only; the JAX package's
    modules import JAX)."""
    n = X.shape[0]
    pad = (-n) % multiple
    w = np.ones(n, X.dtype)
    if pad:
        X = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)], axis=0)
        y = np.concatenate([y.reshape(-1), np.zeros(pad, X.dtype)])
        w = np.concatenate([w, np.zeros(pad, X.dtype)])
    return X, y.reshape(-1), w


def shard_rows(mesh: Mesh, X, y, w=None, axis_name: str = DATA_AXIS,
               device="cuda"):
    """This rank's block ``(X, y, w)`` of the rows, padded with zero-weight
    rows to a multiple of the shard count: block ``i`` of
    ``pad_rows(X, y, n)`` for the rank at coordinate ``i`` along
    ``axis_name``, the layout of ``NamedSharding(mesh, P(axis_name))``.
    A given ``w`` is split the same way, zero on the padding.  Tensors keep
    their device; NumPy arrays go to ``device``.  Only the block is
    copied, never the padded whole."""
    X = torch.as_tensor(X, device=None if torch.is_tensor(X) else device)
    y = torch.as_tensor(y, device=X.device).reshape(-1)
    n, shards = X.shape[0], mesh.shape[axis_name]
    per = -(-n // shards)
    lo = min(mesh.index(axis_name) * per, n)
    hi = min(lo + per, n)
    real, pad = hi - lo, per - (hi - lo)
    w = (X.new_ones(real) if w is None
         else torch.as_tensor(w, device=X.device).reshape(-1)[lo:hi]
         .to(X.dtype))
    Xs, ys = X[lo:hi], y[lo:hi]
    if pad:
        Xs = torch.cat([Xs, X.new_zeros((pad, X.shape[1]))])
        ys = torch.cat([ys, y.new_zeros(pad)])
        w = torch.cat([w, w.new_zeros(pad)])
    return Xs, ys, w
