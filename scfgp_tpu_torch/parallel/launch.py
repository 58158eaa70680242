"""Run a function on W ranks: the multi-process counterpart of JAX's one
process over a mesh of devices.

``run(fn, W, *args)`` spawns W processes (``multiprocessing``'s ``spawn``
start method), joins them into one process group through a ``FileStore``
in a private temporary directory (no TCP port, so concurrent runs never
collide), runs ``fn(*args)`` on each and returns the W results in rank
order.  ``fn`` and its arguments and results are pickled: ``fn`` is a
module-level function of an importable module, and a result is best kept
on the CPU.  A rank that raises, dies or outlives ``timeout`` makes
``run`` stop every rank and raise with that rank's traceback.

Backend: ``device="cuda"`` (the default) gives each rank card
``rank % device_count`` and joins over NCCL when every rank has a card of
its own; ranks that share a card join over gloo, whose collectives take
CUDA tensors (staging them through host memory inside gloo), since NCCL
refuses two ranks on one device.  ``device="cpu"`` joins over gloo.

``local_world`` joins this process alone, a world of one rank, for a
mesh in the calling process.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def backend_for(device: str, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@contextlib.contextmanager
def _joined(rank: int, world_size: int, store_path: str, device: str):
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend_for(device, world_size), store=store,
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_world(device: str = "cuda"):
    """This process as a world of one rank (NCCL on the card, gloo on the
    CPU), left on exit."""
    with tempfile.TemporaryDirectory(prefix="scfgp_world_") as tmp:
        with _joined(0, 1, os.path.join(tmp, "store"), device):
            yield


def _rank_main(fn, args, rank, world_size, store_path, device, threads,
               results):
    if threads:
        torch.set_num_threads(threads)
    try:
        with _joined(rank, world_size, store_path, device):
            out = fn(*args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run(fn, world_size: int, *args, device: str = "cuda",
        timeout: float = 600.0, threads: int = 0) -> list:
    """``[fn(*args) on rank 0, ..., on rank W-1]``, each rank joined into
    one process group of ``world_size`` ranks (module docstring).
    ``threads``: torch's intra-op threads a rank (0 leaves torch's
    default)."""
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.run(device='cuda'): CUDA is not "
                           "available; pass device='cpu'")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="scfgp_launch_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args, rank, world_size,
                                   os.path.join(tmp, "store"), device,
                                   threads, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks of {fn.__name__} did not "
                            f"finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                       f"failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == world_size else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
