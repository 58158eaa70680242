"""ctypes loader for the C++/OpenMP data-preparation helpers.

Port of ``scfgp_tpu/data/native.py:20-126``: the native Box-Cox lambda
fitter (``native/boxcox.cpp``) and the numeric table parser
(``native/table_parser.cpp``), both host code.  The sources are built with
g++ and ``native/Makefile``'s flags into
``scfgp_tpu_torch/_build/libscfgp_native-<hash>.so``, keyed by a hash of
the sources, the flags and the host CPU (``-march=native`` code runs only
where it was built), at first use, as ``ops/build.py`` builds the CUDA
kernels.  Where the compiler has no OpenMP runtime (no ``libgomp``, as on
the card's host), the same sources are built without ``-fopenmp``: the
pragmas drop out and the columns and lines run in one thread, with the
same results.  Nothing is ever written under ``native/``: its
``libscfgp_native.so`` is the JAX package's tracked build.

The JAX contract holds: where the library cannot be built or loaded, the
two functions return ``None`` and callers take the SciPy/Python path.
``build`` raises instead, for a caller that needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.build import BUILD_DIR, PACKAGE_DIR

NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCES = ("boxcox.cpp", "table_parser.cpp")
# native/Makefile's CXXFLAGS, plus -shared; then the same without OpenMP.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall", "-shared")
SERIAL_FLAGS = tuple(f for f in CXX_FLAGS if f != "-fopenmp")

_lock = threading.Lock()
_loaded: dict = {}

_P_DOUBLE = ctypes.POINTER(ctypes.c_double)
_P_INT64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "scfgp_fit_boxcox_lambdas": (
        [_P_DOUBLE, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         _P_DOUBLE], None),
    "scfgp_parse_numeric_table": (
        [ctypes.c_char_p, ctypes.c_int64, _P_DOUBLE, ctypes.c_int64,
         _P_INT64, _P_INT64], ctypes.c_int64),
}


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
        keys = (b"model name", b"flags", b"Features", b"CPU part")
        return b"\n".join(sorted({ln for ln in lines
                                  if ln.split(b":")[0].strip() in keys}))
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def library_path(flags=CXX_FLAGS) -> Path:
    src = b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
    digest = hashlib.sha256(src + " ".join(flags).encode() + _host_cpu())
    return BUILD_DIR / f"libscfgp_native-{digest.hexdigest()[:16]}.so"


def _compile(cxx: str, flags, so: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ timed out building {so.name}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {' '.join(flags)} failed (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def build() -> Path:
    """The keyed library, compiled unless it exists: with OpenMP, else
    without it.  Raises ``RuntimeError`` if there is no g++ or neither
    build succeeds."""
    paths = [(flags, library_path(flags))
             for flags in (CXX_FLAGS, SERIAL_FLAGS)]
    for _, so in paths:
        if so.exists():
            return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native helpers need a C++ "
                           "compiler to build")
    errors = []
    for flags, so in paths:
        try:
            return _compile(cxx, flags, so)
        except RuntimeError as e:
            errors.append(str(e))
    raise RuntimeError("\n".join(errors))


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; ``None`` if it cannot be
    built or loaded (tried once per process)."""
    with _lock:
        if "lib" not in _loaded:
            try:
                lib = ctypes.CDLL(str(build()))
                for fn, (args, res) in _SIGNATURES.items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = res
            except (RuntimeError, OSError, AttributeError):
                lib = None
            _loaded["lib"] = lib
        return _loaded["lib"]


def fit_boxcox_lambdas_native(tX: np.ndarray,
                              distinct_min: int = 10) -> Optional[np.ndarray]:
    """Per-column Box-Cox lambda fit; ``None`` if the library is missing.

    The SciPy path's objective (squared unbiased skewness of the signed
    Box-Cox transform, lambda = softplus(raw), raw in [-5, 5]: reference
    ``Scaler.py:56-70``), minimised by a grid scan and a golden-section
    search, OpenMP-parallel over columns where the build has OpenMP."""
    lib = get_lib()
    if lib is None:
        return None
    tX = np.ascontiguousarray(np.asarray(tX, np.float64).T)  # column-major
    d, n = tX.shape
    out = np.zeros(d, np.float64)
    lib.scfgp_fit_boxcox_lambdas(tX.ctypes.data_as(_P_DOUBLE), n, d,
                                 distinct_min, out.ctypes.data_as(_P_DOUBLE))
    return out


def parse_numeric_table_native(path: str) -> Optional[np.ndarray]:
    """An all-numeric table file as float64 (N, C), parsed natively;
    ``None`` when the library is missing or the file is not a clean
    numeric block (categorical columns, ragged rows), so the caller takes
    the Python path.  Handles '#'/'%' comments, blank lines, comma or
    whitespace delimiters and one detected header row."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    cols, skip = ctypes.c_int64(0), ctypes.c_int64(0)
    rows = lib.scfgp_parse_numeric_table(buf, len(buf), None, 0,
                                         ctypes.byref(cols),
                                         ctypes.byref(skip))
    if rows <= 0 or cols.value <= 0:
        return None
    out = np.empty((rows, cols.value), np.float64)
    got = lib.scfgp_parse_numeric_table(
        buf, len(buf), out.ctypes.data_as(_P_DOUBLE), out.size,
        ctypes.byref(cols), ctypes.byref(skip))
    return out if got == rows else None
