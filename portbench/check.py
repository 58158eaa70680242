"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference computes from the same inputs.

Each cell's driver returns its numbers by name; each has a limit in the
cell's file (``workloads/<cell>.json``, key ``limits``), set from the
readings that ``portbench/calibrate.py`` takes (``PERF.md`` gives them).
"""

from __future__ import annotations

import torch


def rel_gap(prog, ref) -> float:
    """max |prog - ref| / |ref| over the entries (a cost or a log density
    a trial or chain)."""
    prog, ref = prog.double().reshape(-1), ref.double().reshape(-1)
    return float(((prog - ref).abs() / ref.abs().clamp_min(1e-30)).max())


def leaf_gaps(prog, ref, keep=None):
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (``prog`` and ``ref`` are the leaves of one
    trial); ``keep`` masks the leaves counted."""
    pn = torch.stack([t.double().norm() for t in prog])
    rn = torch.stack([t.double().norm() for t in ref])
    floor = torch.maximum(rn, rn.median())
    gaps = (pn - rn).abs() / floor.clamp_min(1e-30)
    if keep is not None:
        gaps = gaps[torch.as_tensor(keep, dtype=torch.bool)]
    return gaps


def leaf_norm_gap(prog, ref, keep=None) -> float:
    """The worst leaf's gap."""
    gaps = leaf_gaps(prog, ref, keep)
    if not gaps.numel():
        return 0.0
    return float(gaps.max())


def moving_leaves(ref_grad) -> list:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least a thousandth of the median leaf's.  A leaf below that
    moves under Adam by round-off alone.  The drivers pass the
    reference's gradient in float64, where a leaf the objective does not
    depend on (the phases, a pure gauge) reads ~1e-16 of the others and
    not float32's round-off."""
    rn = torch.stack([t.double().norm() for t in ref_grad])
    return (rn >= 1e-3 * rn.median()).tolist()


def training_numbers(prog_costs, ref_costs, prog_g1, ref_g1, prog_delta,
                     ref_delta, detail=None, mask_grad=None) -> dict:
    """The training comparison: each of the first steps' loss, the first
    gradient's norm by the worst leaf, and the change of the params over
    those steps by the worst leaf, over the leaves that ``mask_grad``
    (default ``ref_g1``) moves.  ``detail``, a list, receives the leaf
    gaps."""
    keep = moving_leaves(ref_g1 if mask_grad is None else mask_grad)
    if detail is not None:
        detail.append({"grad": leaf_gaps(prog_g1, ref_g1).tolist(),
                       "change": leaf_gaps(prog_delta, ref_delta).tolist(),
                       "moving": keep})
    return {"loss_gap": max(rel_gap(p, r)
                            for p, r in zip(prog_costs, ref_costs)),
            "grad_gap": leaf_norm_gap(prog_g1, ref_g1),
            "change_gap": leaf_norm_gap(prog_delta, ref_delta, keep)}


def judge(numbers: dict, limits: dict):
    """(correct, rows): every number at or under its limit; a number that
    is not finite, or that has no limit, fails."""
    rows, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and value == value
                and abs(value) != float("inf") and value <= limit)
        ok = ok and good
        rows[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), rows
