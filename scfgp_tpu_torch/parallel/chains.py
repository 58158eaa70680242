"""Chains sharded over a mesh's data dimension: chain-parallel sampling.

The JAX package shards the chain axis of the samplers' positions with
``NamedSharding(mesh, P("data", None))`` (``__graft_entry__.py:104-118``),
and GSPMD turns every reduction over the chains into an all-reduce.  The
port runs one process a rank: ``shard_chains`` gives each rank its
contiguous block of the C chains, the samplers take ``axis_name=
mesh.group("data")`` and write those reductions out over
``torch.distributed`` (``bayes/hmc.py``, ``nuts.py``, ``sgld.py``), and
``gather_chains`` collects a result's per-chain fields back to all C
chains on every rank.

    mesh = make_mesh()
    q = shard_chains(mesh, q0, device=dev)               # (C / n, P)
    res = hmc_sample(logpost, q, seed, axis_name=mesh.group("data"))
    res = gather_chains(mesh, res)                       # (.., C, ..)

The sampler's ``rng`` is seeded alike on every rank: each rank then draws
what the unsharded run draws and keeps its chains' slice
(``bayes.hmc.ChainSlice``), so the sharded run is the unsharded run up to
the order of the cross-rank sums.
"""

from __future__ import annotations

import torch

from ..ops.collectives import gather_rows
from .mesh import DATA_AXIS, Mesh

# A result's per-chain fields and their chain dimension.
_CHAIN_DIM = {"samples": 1, "logdensities": 1, "final_positions": 0,
              "depths": 1}


def shard_chains(mesh: Mesh, q0, device="cuda") -> torch.Tensor:
    """This rank's contiguous block of the C chains of ``q0`` (C, ...):
    block ``i`` of ``n`` for the rank at coordinate ``i`` along the mesh's
    data dimension.  A C that ``n`` does not divide is refused, as
    ``jax.device_put`` refuses an uneven ``NamedSharding``.  A tensor keeps
    its device; a NumPy array goes to ``device``."""
    C, n = q0.shape[0], mesh.shape[DATA_AXIS]
    if C % n:
        raise ValueError(f"{C} chains do not divide over the {n} ranks of "
                         f"the mesh's {DATA_AXIS!r} dimension")
    per = C // n
    lo = mesh.index(DATA_AXIS) * per
    return torch.as_tensor(q0[lo:lo + per],
                           device=None if torch.is_tensor(q0) else device)


def gather_chains(mesh: Mesh, result):
    """``result`` (an ``HMCResult``, ``NUTSResult`` or ``SGLDResult`` of a
    sharded run) with its per-chain fields gathered over the ranks of the
    mesh's data dimension, in rank order: the draws, log densities, final
    positions and dynamic NUTS's depths, and in fleet mode (a step size per
    chain) the step sizes and inverse masses.  The rest is the same on every rank
    already.  The continuation state (``warmup_state``, ``final_carry``)
    stays this rank's, for a sharded continuation."""
    group = mesh.group(DATA_AXIS)
    out = {f: gather_rows(getattr(result, f), group, dim)
           for f, dim in _CHAIN_DIM.items()
           if getattr(result, f, None) is not None}
    if getattr(result, "inv_mass", None) is not None \
            and result.step_size.dim() == 1:
        out["step_size"] = gather_rows(result.step_size, group)
        out["inv_mass"] = gather_rows(result.inv_mass, group)
    return result._replace(**out)
