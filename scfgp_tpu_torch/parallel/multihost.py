"""Joining the process group of a multi-process run.

Port of ``scfgp_tpu/parallel/multihost.py``.  JAX joins all hosts of a pod
slice into one process that sees every device; PyTorch runs one process a
rank, and ``init_distributed`` joins this process to the others from the
environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) or from its arguments:

    torchrun --nproc-per-node 4 train.py     # on each host
    # train.py:
    from scfgp_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed()
    mesh = make_mesh()                        # every rank of every host

A single process (no ``WORLD_SIZE`` above 1, no address) is a no-op, so
code written against this API runs unchanged from one card to many.  On
the card the backend is NCCL and each rank takes card ``LOCAL_RANK``;
gloo only when the caller asks for the CPU.  A join that fails raises: the
JAX version's fallback to a single process on an already initialised
backend (``multihost.py:47-52``) has no torch counterpart and would hide
the failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda",
                     timeout: Optional[datetime.timedelta] = None) -> dict:
    """Join the process group; a no-op in a single process or when this
    process has joined already.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` override ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  ``device="cpu"`` joins over gloo.  Returns what the JAX
    version returns: process index and count, local and global devices."""
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if not dist.is_initialized() and (coordinator_address is not None
                                      or world > 1):
        if device == "cuda":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        init_method = ("env://" if coordinator_address is None
                       else f"tcp://{coordinator_address}")
        kwargs = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world, **kwargs)
    joined = dist.is_initialized()
    local = torch.cuda.device_count() if device == "cuda" else 1
    return {
        "process_id": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_devices": local,
        "global_devices": dist.get_world_size() if joined else local,
    }


def is_coordinator() -> bool:
    """True on the process that should write checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0
