"""Serving export: freeze a trained model's predictor into a program.

Port of ``scfgp_tpu/utils/serving.py:30-100``, where ``jax.export`` lowers
the predictor to StableHLO.  Here ``torch.export`` traces the model's
scaled-space ``predict_f`` at a fixed ``(batch_size, D)``, with the
parameters, the posterior and ``extra_basis`` baked in, on the model's
device and in its dtype.  The feature map enters the program as the
registered operator ``scfgp_tpu_torch::phi_fwd`` (``ops/phi.py``), so a
program run on the card launches K1f, once a call.  The program is saved
with ``torch.export.save`` into memory and shipped in the arrays-only npz
codec (``utils/checkpoint.py``) beside the scalers' state, which un-scale
the outputs on the client's side.

``torch.export.load`` unpickles parts of an archive (the example inputs,
pickled payloads, custom objects), with ``weights_only=False`` as a
fallback.  ``ServedPredictor`` therefore checks the program archive first
and refuses any pickle that the safe ``weights_only`` loader cannot read,
and any payload or constant stored as a pickle: loading a blob never runs
code from it.  The program runs only on the device it was exported for.
"""

from __future__ import annotations

import io
import json
import pickle
import zipfile
from typing import Tuple

import numpy as np
import torch

from .checkpoint import dumps_state, loads_state

_SAMPLE_INPUTS = "/data/sample_inputs/"
_PAYLOAD_CONFIGS = ("_weights_config.json", "_constants_config.json")


class _Predictor(torch.nn.Module):
    """``predict_f`` with one model's parameters, posterior and basis."""

    def __init__(self, params, post, basis_fn):
        super().__init__()
        # Copies that share no storage, each saved alone (strides kept: the
        # products take the layout that the model's own predict takes).
        self.params = type(params)(*(t.detach().clone() for t in params))
        self.post = type(post)(*(t.detach().clone() for t in post))
        self.basis_fn = basis_fn

    def forward(self, Xs):
        from ..models.objective import predict_f
        return predict_f(self.params, self.post, Xs, basis_fn=self.basis_fn)


def export_predictor(model, batch_size: int) -> bytes:
    """Serialise the model's predictor for (batch_size, D) scaled inputs.

    Returns the npz codec's bytes over {program, X_scaler, y_scaler, meta}:
    the ``torch.export.save`` archive as a uint8 array, the scalers' state
    as plain arrays, and ``meta`` (S, M, D, batch_size, ID, dtype, device).
    No pickle is written by the codec.  Raises ``ValueError`` for a model
    without trained parameters and posterior."""
    if model.params is None or model.post is None:
        raise ValueError("model must be trained before export")
    spec = torch.zeros((batch_size, model.D), dtype=model.dtype,
                       device=model.device)
    with torch.no_grad():
        program = torch.export.export(
            _Predictor(model.params, model.post, model.extra_basis), (spec,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    payload = {
        "program": np.frombuffer(buf.getvalue(), np.uint8),
        "X_scaler": model.X_scaler.to_state_dict(),
        "y_scaler": model.y_scaler.to_state_dict(),
        "meta": {"S": model.S, "M": model.M, "D": model.D,
                 "batch_size": batch_size, "ID": model.ID,
                 "dtype": str(model.dtype).removeprefix("torch."),
                 "device": model.device.type},
    }
    return dumps_state(payload)


def _check_program_archive(program: bytes) -> None:
    """Refuse a ``torch.export.save`` archive whose loading could unpickle
    arbitrary objects: any pickle other than the example inputs, example
    inputs that the ``weights_only`` loader refuses, and any weight or
    constant stored as a pickle or as a custom object."""
    try:
        z = zipfile.ZipFile(io.BytesIO(program))
    except zipfile.BadZipFile as e:
        raise ValueError("served program: not a torch.export archive") from e
    with z:
        names = z.namelist()
        if not any(n.endswith("/archive_format") for n in names):
            raise ValueError("served program: not a torch.export archive "
                             "of the current format")
        for name in names:
            if _SAMPLE_INPUTS in name:
                data = z.read(name)
                if data:
                    try:
                        torch.load(io.BytesIO(data), weights_only=True)
                    except (pickle.UnpicklingError, RuntimeError,
                            EOFError) as e:
                        raise ValueError("served program: example inputs "
                                         "are not plain tensors") from e
            elif name.endswith((".pt", ".pkl", ".pickle")):
                raise ValueError(f"served program: pickled entry {name!r}")
            elif name.endswith(_PAYLOAD_CONFIGS):
                config = json.loads(z.read(name))["config"]
                for fqn, entry in config.items():
                    if (entry.get("use_pickle")
                            or not str(entry.get("path_name", "")).startswith(
                                ("weight_", "tensor_"))):
                        raise ValueError(f"served program: {fqn!r} is not "
                                         "stored as a plain tensor")


class ServedPredictor:
    """Reloaded predictor: original-units mean and std from raw inputs.

    Takes only the arrays-only npz format (loaded with
    ``allow_pickle=False``) and a program archive that passes
    ``_check_program_archive``.  ``device`` must be the one the program
    was exported for: a blob is never moved to another device."""

    def __init__(self, blob: bytes, device="cuda"):
        from ..data.scaler import Scaler

        payload = loads_state(blob)
        self.meta = payload["meta"]
        self.device = torch.device(device)
        if self.device.type != self.meta["device"]:
            raise ValueError(f"served program was exported for "
                             f"{self.meta['device']!r}, not {device!r}")
        program = np.asarray(payload["program"], np.uint8).tobytes()
        _check_program_archive(program)
        self._program = torch.export.load(io.BytesIO(program)).module()
        self.dtype = getattr(torch, self.meta["dtype"])
        self.X_scaler = Scaler.from_state_dict(payload["X_scaler"]).to(
            self.device)
        self.y_scaler = Scaler.from_state_dict(payload["y_scaler"]).to(
            self.device)

    @torch.inference_mode()
    def __call__(self, Xs) -> Tuple[np.ndarray, np.ndarray]:
        b = self.meta["batch_size"]
        X = torch.as_tensor(np.asarray(Xs), device=self.device)
        Xt = self.X_scaler.forward_transform(X).to(self.dtype)
        n = Xt.shape[0]
        if n > b:
            raise ValueError(f"batch {n} exceeds exported size {b}")
        if n < b:
            Xt = torch.cat([Xt, Xt.new_zeros((b - n, Xt.shape[1]))])
        mu_f, std_f = self._program(Xt.contiguous())
        mu_f, std_f = mu_f[:n, None], std_f[:n, None]
        bt = self.y_scaler.backward_transform
        mu_y = bt(mu_f)
        up, dn = bt(mu_f + std_f), bt(mu_f - std_f)
        return (mu_y.cpu().numpy(), (0.5 * (up - dn)).cpu().numpy())
