"""The port's serving export (``utils/serving.py``) and the registered
operator ``scfgp_tpu_torch::phi_fwd`` on the CPU, against the JAX package.

Mirrors ``tests/test_serving.py:10-40`` (reload parity with padding, the
untrained model, the arrays-only npz codec) and adds what the port's
loader must refuse: a pickle inside the program archive, and a device
other than the one the program was exported for.  The port's served
output on the JAX model's parameters and posterior equals the JAX
``ServedPredictor``'s at rtol 1e-10 in float64 (one summation order
against another through a 2K x 2K posterior; measured 1.2e-15) and at
rtol 1e-5 in float32 (float32 rounding of T carried through Li; measured
8.4e-7).
"""

import io
import json
import pickle
import zipfile

import numpy as np
import pytest
import torch

from scfgp_tpu import SCFGP as JaxSCFGP
from scfgp_tpu.utils.serving import (ServedPredictor as JaxServed,
                                     export_predictor as jax_export)
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.data.datasets import synthetic_gp_rff
from scfgp_tpu_torch.data.scaler import Scaler
from scfgp_tpu_torch.models.params import (params_from_numpy,
                                           posterior_from_numpy)
from scfgp_tpu_torch.ops.phi import fourier_features_ref, phi_fwd_op
from scfgp_tpu_torch.utils.serving import ServedPredictor, export_predictor

torch.set_num_threads(1)


def _trained(dtype=torch.float32, n=200, iters=40, seed=0):
    X, y = synthetic_gp_rff(n=n, d=3, s=3, m=8, seed=seed)
    m = SCFGP(sparsity=4, nfeats=8, seed=0, dtype=dtype, device="cpu")
    m.fit(X[:160], y[:160], max_iter=iters)
    return m, X


def test_export_reload_predict_parity():
    """40 rows into an exported batch of 64 (the padding path)."""
    m, X = _trained()
    blob = export_predictor(m, batch_size=64)
    assert isinstance(blob, bytes) and len(blob) > 1000
    served = ServedPredictor(blob, device="cpu")
    Xq = X[160:200]
    mu_ref, std_ref = m.predict(Xq)
    mu_srv, std_srv = served(Xq)
    assert mu_srv.shape == std_srv.shape == (40, 1)
    np.testing.assert_allclose(mu_srv, mu_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std_srv, std_ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        served(np.concatenate([X, X])[:65])


def test_export_rejects_untrained():
    m = SCFGP(sparsity=4, nfeats=8, device="cpu")
    with pytest.raises(ValueError):
        export_predictor(m, batch_size=8)


def test_export_is_pickle_free_npz():
    m, _ = _trained(n=120, iters=20, seed=1)
    blob = export_predictor(m, batch_size=16)
    assert blob[:2] == b"PK" and zipfile.is_zipfile(io.BytesIO(blob))
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        assert "__meta__" in z.files
    with pytest.raises(ValueError):
        ServedPredictor(pickle.dumps({"program": b"x"}), device="cpu")


def test_float64_model_exports_float64():
    m, X = _trained(dtype=torch.float64)
    blob = export_predictor(m, batch_size=64)
    served = ServedPredictor(blob, device="cpu")
    assert served.meta["dtype"] == "float64" and served.dtype == torch.float64
    mu_f, std_f = served._program(torch.zeros(64, 3, dtype=torch.float64))
    assert mu_f.dtype == std_f.dtype == torch.float64
    mu_ref, std_ref = m.predict(X[160:])
    mu, std = served(X[160:])
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(std, std_ref, rtol=1e-12, atol=0)


def test_blob_exported_for_one_device_is_refused_on_another():
    m, _ = _trained(n=120, iters=5)
    blob = export_predictor(m, batch_size=8)
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        ServedPredictor(blob, device="cuda")


# -- a program archive that carries a pickle ----------------------------------

_RAN = []


class _Payload:
    """Unpickling this runs code: it must never happen."""

    def __reduce__(self):
        return (_RAN.append, ("ran",))


def _rewrite_program(blob, edit):
    """The blob with its program archive's entries passed through
    ``edit(name, data) -> data`` (or None to drop), plus any it adds."""
    from scfgp_tpu_torch.utils.checkpoint import dumps_state, loads_state
    payload = loads_state(blob)
    src = zipfile.ZipFile(io.BytesIO(payload["program"].tobytes()))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for name in src.namelist():
            data = edit(name, src.read(name))
            if data is not None:
                dst.writestr(name, data)
        for name, data in edit.extra(src.namelist()).items():
            dst.writestr(name, data)
    payload["program"] = np.frombuffer(out.getvalue(), np.uint8)
    return dumps_state(payload)


def _evil_sample_inputs(name, data):
    return pickle.dumps(_Payload()) if "sample_inputs" in name else data


def _pickled_weight(name, data):
    if name.endswith("_constants_config.json"):
        cfg = json.loads(data)
        for entry in cfg["config"].values():
            entry["use_pickle"] = True
        return json.dumps(cfg).encode()
    return data


def _legacy_pickle_entry(name, data):
    return data


_evil_sample_inputs.extra = _pickled_weight.extra = lambda names: {}
_legacy_pickle_entry.extra = lambda names: {
    names[0].split("/")[0] + "/data/weights/model.pt": pickle.dumps(
        _Payload())}


@pytest.mark.parametrize("edit", [_evil_sample_inputs, _pickled_weight,
                                  _legacy_pickle_entry],
                         ids=["sample_inputs", "use_pickle", "legacy_pt"])
def test_blob_with_a_pickle_payload_is_refused(edit):
    m, _ = _trained(n=120, iters=5)
    blob = _rewrite_program(export_predictor(m, batch_size=8), edit)
    _RAN.clear()
    with pytest.raises(ValueError, match="served program"):
        ServedPredictor(blob, device="cpu")
    assert _RAN == []


# -- against the JAX ServedPredictor -----------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-10),
                                        ("float32", 1e-5)])
def test_served_output_equals_jax_served(dtype, rtol):
    """The JAX model's parameters, posterior and scalers carried across:
    the two exported programs answer the same requests alike."""
    import jax.numpy as jnp
    X, y = synthetic_gp_rff(n=200, d=3, s=3, m=8, seed=0)
    jm = JaxSCFGP(sparsity=4, nfeats=8, seed=0, dtype=getattr(jnp, dtype))
    jm.fit(X[:160], y[:160], max_iter=30)
    tdtype = getattr(torch, dtype)
    m = SCFGP(sparsity=4, nfeats=8, dtype=tdtype, device="cpu")
    m.D = 3
    m.params = params_from_numpy([np.asarray(a) for a in jm.params], tdtype)
    m.post = posterior_from_numpy([np.asarray(a) for a in jm.post], tdtype)
    m.X_scaler = Scaler.from_state_dict(jm.X_scaler.to_state_dict())
    m.y_scaler = Scaler.from_state_dict(jm.y_scaler.to_state_dict())
    ours = ServedPredictor(export_predictor(m, 64), device="cpu")
    theirs = JaxServed(jax_export(jm, 64))
    Xq = X[160:]
    mu, std = ours(Xq)
    mu_j, std_j = theirs(Xq)
    np.testing.assert_allclose(mu, np.asarray(mu_j), rtol=rtol,
                               atol=rtol * np.abs(mu_j).max())
    np.testing.assert_allclose(std, np.asarray(std_j), rtol=rtol)


# -- the registered operator ------------------------------------------------


def _op_inputs(lead=(), n=33, d=3, k=7, dtype=torch.float64, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(a, dtype=dtype) for a in (
        rng.randn(*lead, n, d), 3.0 * rng.randn(*lead, d, k),
        rng.uniform(0, 2 * np.pi, (*lead, k)),
        0.7 + 0.1 * rng.rand(*lead) if lead else 0.7)]


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "trials"])
def test_phi_fwd_op_equals_plain_and_passes_opcheck(lead):
    args = _op_inputs(lead)
    out = torch.ops.scfgp_tpu_torch.phi_fwd(*args)
    assert torch.equal(out, fourier_features_ref(*args))
    assert out.shape == (*lead, 33, 14)
    torch.library.opcheck(phi_fwd_op, args)
