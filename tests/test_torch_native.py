"""The port's native helpers (``data/native.py``) against the JAX
package's: the C++ Box-Cox lambda fitter and the numeric table parser,
built by the port from ``native/*.cpp`` into its own build directory.

The two libraries compile the same sources with the same flags, so the
lambdas agree at rtol 1e-12 (measured: bitwise) and the parsed tables are
equal.  The build must never write under ``native/``, whose
``libscfgp_native.so`` is the JAX package's tracked file.
"""

import glob
import hashlib
import os

import numpy as np
import pytest
import torch
from scipy.stats import skew

from scfgp_tpu.data import datasets as jds
from scfgp_tpu.data import native as jn
from scfgp_tpu.data.scaler import Scaler as JaxScaler
from scfgp_tpu_torch.data import datasets as tds
from scfgp_tpu_torch.data import native as tn
from scfgp_tpu_torch.data.scaler import Scaler, _fit_boxcox_lambdas

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                         "real_formats", "*")))


def _unit(seed, n=400, d=3):
    X = np.exp(np.random.RandomState(seed).randn(n, d))
    return (X - X.min(0)) / (X.max(0) - X.min(0))


def _native_tree():
    """Name, size, mtime and hash of every file under ``native/``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "native", "*"))):
        st = os.stat(path)
        with open(path, "rb") as f:
            out[os.path.basename(path)] = (
                st.st_size, st.st_mtime_ns, hashlib.sha256(f.read()).digest())
    return out


def test_library_builds_into_the_port_and_leaves_native_alone(tmp_path,
                                                              monkeypatch):
    before = _native_tree()
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    so = tn.build()
    assert so.parent == tmp_path and so.exists()
    assert tn.build() == so  # keyed: a second call reuses it
    assert _native_tree() == before
    assert tn.get_lib() is not None


def test_library_builds_without_openmp_where_it_cannot(tmp_path,
                                                      monkeypatch):
    """A compiler that refuses the OpenMP build (here: a flag it does not
    know) gets the serial build, which gives the same lambdas."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tn, "CXX_FLAGS", tn.CXX_FLAGS + ("-fno-such-flag",))
    so = tn.build()
    assert so == tn.library_path(tn.SERIAL_FLAGS) and so.exists()
    import ctypes
    lib = ctypes.CDLL(str(so))
    u = _unit(5)
    out = np.zeros(u.shape[1])
    col = np.ascontiguousarray(u.T)
    lib.scfgp_fit_boxcox_lambdas(col.ctypes.data_as(tn._P_DOUBLE),
                                 ctypes.c_int64(u.shape[0]),
                                 ctypes.c_int64(u.shape[1]),
                                 ctypes.c_int64(10),
                                 out.ctypes.data_as(tn._P_DOUBLE))
    np.testing.assert_array_equal(out, jn.fit_boxcox_lambdas_native(u))


@pytest.mark.parametrize("seed", [7, 11])
def test_native_lambdas_equal_jax_native(seed):
    u = _unit(seed)
    ours = tn.fit_boxcox_lambdas_native(u)
    theirs = jn.fit_boxcox_lambdas_native(u)
    assert ours is not None and theirs is not None
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)


def test_native_lambdas_hold_the_scipy_check():
    """``tests/test_scaler.py:117``: the grid and golden-section fit lands
    at (or below) the SciPy SLSQP objective."""
    u = _unit(7)
    lams_native = tn.fit_boxcox_lambdas_native(u)
    lams_scipy = _fit_boxcox_lambdas(u)

    def obj(col, lm):
        return skew((np.sign(col) * np.abs(col) ** lm - 1) / lm,
                    bias=False) ** 2

    for j in range(u.shape[1]):
        assert obj(u[:, j], lams_native[j]) <= obj(u[:, j],
                                                   lams_scipy[j]) + 1e-6


def test_native_scaler_equals_jax_native_scaler():
    X = np.exp(np.random.RandomState(3).randn(300, 4))
    ours = Scaler("auto-inv-normal", native=True).fit(X)
    theirs = JaxScaler("auto-inv-normal", native=True).fit(X)
    np.testing.assert_allclose(ours.state["boxcox"].numpy(),
                               np.asarray(theirs.state["boxcox"]), rtol=1e-12)
    np.testing.assert_allclose(ours.forward_transform(X).numpy(),
                               np.asarray(theirs.forward_transform(X)),
                               rtol=1e-12)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_native_parser_equals_jax_on_fixtures(path):
    ours = tn.parse_numeric_table_native(path)
    theirs = jn.parse_numeric_table_native(path)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tds._numeric_table(path)
                                  if ours is not None else 0,
                                  jds._numeric_table(path)
                                  if theirs is not None else 0)


def test_parser_refuses_what_is_not_a_clean_table(tmp_path):
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("1,2,3\n4,5\n")
    assert tn.parse_numeric_table_native(str(ragged)) is None
    assert tn.parse_numeric_table_native(str(tmp_path / "missing")) is None
