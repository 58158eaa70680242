"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``scfgp_tpu_torch/_build/lib<name>-<hash>.so``,
keyed by a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  The directory is
listed in ``.gitignore``.  Nothing here runs at import: the CPU tests
import every module.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.profiling import setup_span

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}
_ERROR_STRING = {"scfgp_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p)}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit PyTorch finds."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "scfgp_tpu_torch need the CUDA toolkit to build")
    return nvcc


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{name}.cu",
                                            *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists.  The
    compiler's report (ptxas registers, shared memory, spills) is kept
    beside the library as ``.log``."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process, and
    declare the types of its C functions: ``signatures`` maps a function's
    name to ``(argtypes, restype)``.  Every library also exports
    ``scfgp_cuda_error_string``.  The first load in a process is the span
    ``scfgp.setup.load_library``, which says whether ``nvcc`` ran."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            built = not library_path(name).exists()
            with setup_span("scfgp.setup.load_library", library=name,
                            built=built):
                lib = ctypes.CDLL(str(build(name)))
                for fn, (args, res) in {**signatures,
                                        **_ERROR_STRING}.items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = res
            _loaded[name] = lib
        return lib


def raise_on(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if rc != 0:
        msg = lib.scfgp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cuda error {rc})")
