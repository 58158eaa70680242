"""Collectives over a process group for the objective's row sums.

The JAX package writes ``jax.lax.psum`` and ``jax.lax.all_gather`` over a
named mesh axis inside ``shard_map``, and its gradient through the
``shard_map`` boundary is the exact global gradient
(``scfgp_tpu/parallel/dp.py:14-17``).  The port runs one process a rank
(``parallel/launch.py``); these are the ``torch.distributed``
counterparts, as autograd Functions whose backward is the forward's true
adjoint over all ranks:

  * ``psum``: all-reduce-sum; its backward all-reduce-sums the cotangents,
    since each rank's copy of the sum feeds that rank's own downstream;
  * ``all_gather``: the ranks' tensors concatenated along a dimension; its
    backward sums the cotangents over the ranks and keeps this rank's
    slice (a reduce-scatter, taken as an all-reduce and a slice, since
    gloo has no reduce-scatter).

The cost that comes out is the same on every rank.  Differentiating it on
each rank counts the terms that do not pass through a collective (the KL
penalty, ``2 (n - M) a``) once a rank, so ``models/objective.py::
value_and_grad`` divides the cost by the number of replicas before the
backward and all-reduces the parameter gradient after it: the exact
global gradient, on every rank.

``axis_name`` is a ``torch.distributed`` group.  A JAX axis name refers to
the mesh of the enclosing ``shard_map``; the port has no such scope, so a
caller names a dimension of an explicit mesh, ``mesh.group("data")``
(``parallel/mesh.py``), and passes the group.  A bare name is refused.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_group(axis_name):
    """The group ``axis_name`` is; a string is refused, since a name means
    nothing without its mesh (module docstring)."""
    if isinstance(axis_name, str):
        raise TypeError(
            f"axis_name={axis_name!r}: pass the group of an explicit mesh, "
            f"mesh.group({axis_name!r}) (scfgp_tpu_torch.parallel)")
    return axis_name


def axis_size(axis_name) -> int:
    return dist.get_world_size(resolve_group(axis_name))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        ctx.width = x.shape[dim]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width), None, None


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the ranks of ``axis_name``,
    differentiable."""
    return _AllReduce.apply(x, resolve_group(axis_name))


def all_gather(x: torch.Tensor, axis_name, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: the ranks' ``x`` in rank
    order, concatenated along ``dim``, differentiable."""
    return _AllGather.apply(x, resolve_group(axis_name), dim)


def all_reduce_sum(tensors, axis_name):
    """The sums over the ranks of a sequence of tensors, through one
    all-reduce of their concatenation; not differentiable."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=resolve_group(axis_name))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def gather_rows(t: torch.Tensor, axis_name, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order; not
    differentiable."""
    group = resolve_group(axis_name)
    t = t.detach().movedim(dim, 0).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).movedim(0, dim)
