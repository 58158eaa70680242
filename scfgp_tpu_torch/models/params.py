"""Parameter NamedTuple of the SCFGP model, on torch tensors.

Port of ``scfgp_tpu/models/params.py:25-136``.  The reference packs every
hyperparameter into one flat Theano shared vector (``reference:
SCFGP/SCFGP.py:64-90``); the structured ``SCFGPParams`` keeps each leaf
separate and ``pack_params``/``unpack_params`` keep the reference's flat
layout, so one θ drives both packages and the golden NumPy harness:

  ``concat([a, b, c, l_F.ravel(D*S), r_F.ravel(M*S), l_phase(S), phase(M)])``

``params_from_numpy``/``posterior_from_numpy`` carry the JAX package's
arrays (as NumPy, e.g. from a checkpoint) onto a torch device and dtype;
``opt_state_from_numpy``/``opt_state_to_numpy`` carry training-resume state
(optimizer accumulators, fused-loop carries) across with every dtype kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class SCFGPParams(NamedTuple):
    """Trainable hyperparameters of the sparsely-correlated Fourier GP.

    Shapes: ``l_F (D, S)``, ``r_F (M, S)``, ``l_phase (S,)``, ``phase (M,)``,
    scalars ``a`` (noise: sig2_n = exp(2a)), ``b`` (amplitude: sig_f = exp(b)),
    ``c`` (dispersion: noise = softplus(c)).  Field order is the checkpoint's
    (``scfgp_tpu/utils/checkpoint.py:34-44``).  The trials of a batched fit
    stack every leaf on a leading axis B (``a`` (B,), ``l_F`` (B, D, S),
    ...); D, S and M read the trailing axes.
    """

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    l_F: torch.Tensor
    r_F: torch.Tensor
    l_phase: torch.Tensor
    phase: torch.Tensor

    @property
    def D(self) -> int:
        return self.l_F.shape[-2]

    @property
    def S(self) -> int:
        return self.l_F.shape[-1]

    @property
    def M(self) -> int:
        return self.r_F.shape[-2]


def resolve_sparsity(S: int, D: int, M: int) -> int:
    """Map the legacy full-rank sentinel ``S=-1`` to rank ``min(D, M)``
    (``scfgp_tpu/models/params.py:54-63``)."""
    return min(D, M) if S == -1 else S


def init_params(generator: torch.Generator, D: int, S: int, M: int,
                dtype=torch.float32, device="cpu") -> SCFGPParams:
    """Random init with the reference's distributions (``SCFGP.py:64-72``):
    a, b, c, l_F ~ N(0, 1); r_F ~ U(0, 1); phases ~ U(0, 2π).

    The draws come from ``generator``, so they are not the JAX package's
    bits for the same seed; cross-package tests pass θ in as arrays.
    """
    S = resolve_sparsity(S, D, M)
    g = dict(generator=generator, dtype=dtype, device=device)
    two_pi = 2.0 * math.pi
    return SCFGPParams(
        a=torch.randn((), **g),
        b=torch.randn((), **g),
        c=torch.randn((), **g),
        l_F=torch.randn((D, S), **g),
        r_F=torch.rand((M, S), **g),
        l_phase=two_pi * torch.rand((S,), **g),
        phase=two_pi * torch.rand((M,), **g),
    )


def pack_params(p: SCFGPParams) -> torch.Tensor:
    """Params -> flat vector (reference layout, ``SCFGP.py:72``)."""
    return torch.cat([p.a.reshape(1), p.b.reshape(1), p.c.reshape(1),
                      p.l_F.reshape(-1), p.r_F.reshape(-1),
                      p.l_phase, p.phase])


def unpack_params(theta: torch.Tensor, D: int, S: int, M: int) -> SCFGPParams:
    """Flat vector -> params (reference layout, ``SCFGP.py:74-90``)."""
    i = 3
    l_F = theta[i:i + D * S].reshape(D, S); i += D * S
    r_F = theta[i:i + M * S].reshape(M, S); i += M * S
    l_phase = theta[i:i + S]; i += S
    phase = theta[i:i + M]
    return SCFGPParams(a=theta[0], b=theta[1], c=theta[2],
                       l_F=l_F, r_F=r_F, l_phase=l_phase, phase=phase)


def num_params(D: int, S: int, M: int) -> int:
    return 3 + D * S + M * S + S + M


def _to_tensors(cls, arrays, dtype, device):
    return cls(*[torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in arrays])


def params_from_numpy(arrays, dtype=torch.float32,
                      device="cpu") -> SCFGPParams:
    """The JAX package's ``SCFGPParams`` leaves (NumPy arrays, in field
    order) -> the port's params on ``device`` in ``dtype``."""
    return _to_tensors(SCFGPParams, arrays, dtype, device)


def posterior_from_numpy(arrays, dtype=torch.float32, device="cpu"):
    """The JAX package's ``Posterior`` leaves (``L, Li, alpha, beta,
    log_diag_L``, as NumPy) -> the port's ``Posterior``."""
    from .objective import Posterior
    return _to_tensors(Posterior, arrays, dtype, device)


def opt_state_from_numpy(state, device="cpu"):
    """A training-resume tree as ``load`` decodes it (the JAX package's
    ``AdamState``/``AdamaxState``/``AdadeltaState``/``MomentumState``,
    ``FusedLoopState`` or ``SCFGPParams``, with NumPy leaves) -> the same
    tree of tensors on ``device``.  Every leaf keeps its dtype:
    ``AdamState.t`` is float32 even beside float64 params, and a cast would
    change ``beta**t`` and with it the replayed trajectory.  Tensor leaves
    are moved, not cast."""
    from ..opt.optimizers import tree_map

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.tensor(np.asarray(a), device=device)
    return tree_map(leaf, state)


def opt_state_to_numpy(state):
    """The reverse of ``opt_state_from_numpy``, for ``save``: every leaf as
    a NumPy array of its own dtype, readable by the JAX package."""
    from ..opt.optimizers import tree_map

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)
    return tree_map(leaf, state)


class DerivedFrequencies(NamedTuple):
    """``F = l_F r_Fᵀ`` (``SCFGP.py:83``) and the fused projection operands
    ``Fcat (D, S+M) = [l_F | F]``, ``pcat (S+M,)`` with mean-centred phases
    (``SCFGP.py:88-89``)."""

    F: torch.Tensor
    Fcat: torch.Tensor
    pcat: torch.Tensor


def feature_scale(p: SCFGPParams) -> torch.Tensor:
    """``sig_f * sqrt(2/M)``, with M and not S+M (``SCFGP.py:102``)."""
    return torch.exp(p.b) * math.sqrt(2.0 / p.M)


def derive_frequencies(p: SCFGPParams) -> DerivedFrequencies:
    """Per trial when the leaves carry a leading trial axis."""
    F = p.l_F @ p.r_F.mT
    l_FC = p.l_phase - p.l_F.mean(dim=-2)
    FC = p.phase - F.mean(dim=-2)
    return DerivedFrequencies(F=F, Fcat=torch.cat([p.l_F, F], dim=-1),
                              pcat=torch.cat([l_FC, FC], dim=-1))
