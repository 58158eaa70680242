"""K1: the fused low-rank trig Fourier feature map, forward and backward.

``Phi = s * [cos(X @ Fcat + pcat) | sin(X @ Fcat + pcat)]`` — the
reference's feature construction (``reference: SCFGP/SCFGP.py:99-102``).

Two versions of each direction:

  * ``fourier_features_cuda`` launches the hand-written Hopper kernel
    ``csrc/phi_fwd.cu``, the port of the Pallas kernel
    ``scfgp_tpu/ops/phi.py::_fwd_kernel``: one launch, T never leaves
    registers (for D >= 64 computed by the register-blocked tile of
    ``csrc/sgemm_tile.cuh``), cos and sin stored straight into one
    contiguous (N, 2K) array.  ``fourier_features_bwd_cuda`` launches
    ``csrc/phi_bwd.cu``, the port of ``_bwd_kernel``: T recomputed (for
    D >= 64 by the same tile, dT kept for one chunk of rows), and the sums
    over rows taken in fixed orders without atomics, so the gradient is
    bitwise repeatable.  float32 only.  Their launch counts are
    ``fourier_features_cuda.launches`` and
    ``fourier_features_bwd_cuda.launches``.
  * ``fourier_features_ref`` and ``phi_bwd_ref`` are the plain PyTorch
    versions: the CPU path and the kernels' references on the card.

Every version takes the 2-D shapes, X (N, D), Fcat (D, K), pcat (K,) and
one scale, or the same with a leading trial axis B (scale (B,)): the
trials of a batched sweep (``models/model.py::fit_fast_batch``), what
``jax.vmap`` hands the Pallas kernel as a leading grid axis.  The kernels
do each direction for all B trials in one launch, and trial b gets
bitwise the bits of the 2-D call on trial b.

``FourierFeatures`` joins the two directions into one
``torch.autograd.Function`` (the JAX package's ``custom_vjp``,
``scfgp_tpu/ops/phi.py:168-187``): it saves X, Fcat, pcat and s, not Phi,
and gives X, which is data, no gradient.  A CUDA tensor goes to the
kernels, a CPU tensor to the plain versions; there is no fallback.  The raw
kernel wrappers refuse tensors that require grad: differentiate through
``FourierFeatures``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library, raise_on

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
# The int arguments are (trials, n, d, k).
_SIGNATURES = {
    "phi_fwd": {"scfgp_phi_fwd_f32": ([_VOID] * 5 + [_INT] * 4 + [_VOID],
                                      ctypes.c_int)},
    "phi_bwd": {"scfgp_phi_bwd_f32": ([_VOID] * 7 + [_INT] * 4 + [_VOID],
                                      ctypes.c_int),
                "scfgp_phi_bwd_workspace": ([_INT] * 4, ctypes.c_size_t)},
}
# The CUDA grid's last axis carries the trial.
MAX_TRIALS = 65535


def _library(name: str) -> ctypes.CDLL:
    return load_library(name, _SIGNATURES[name])


def _per_trial(scale: torch.Tensor) -> torch.Tensor:
    """``scale`` () or (B,) as (1, 1) or (B, 1, 1), to broadcast over a
    trial's (N, 2K) block."""
    return scale.reshape(scale.shape + (1, 1))


def fourier_features_ref(X: torch.Tensor, Fcat: torch.Tensor,
                         pcat: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch feature map (N, 2K); with a leading trial axis, X
    (B, N, D), Fcat (B, D, K), pcat (B, K) and scale (B,) give (B, N, 2K)."""
    T = X @ Fcat + pcat.unsqueeze(-2)
    return _per_trial(scale) * torch.cat([torch.cos(T), torch.sin(T)], dim=-1)


def phi_bwd_ref(X: torch.Tensor, Fcat: torch.Tensor, pcat: torch.Tensor,
                scale: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch backward of the feature map: ``(dFcat, dpcat, ds)``
    from the cotangent ``g`` (N, 2K), the formulas of
    ``scfgp_tpu/ops/phi.py:83-95``; per trial with a leading trial axis."""
    k = Fcat.shape[-1]
    T = X @ Fcat + pcat.unsqueeze(-2)
    c, sn = torch.cos(T), torch.sin(T)
    g_cos, g_sin = g[..., :k], g[..., k:]
    dT = _per_trial(scale) * (g_sin * c - g_cos * sn)
    return (X.mT @ dT, dT.sum(dim=-2),
            (g_cos * c + g_sin * sn).sum(dim=(-2, -1)))


def check_kernel_inputs(where, X, **tensors):
    """Refuse what a CUDA kernel does not take: every tensor must be
    float32, contiguous and on the CUDA device of ``X``."""
    for name, t in {"X": X, **tensors}.items():
        if t.device.type != "cuda" or t.device != X.device:
            raise ValueError(f"{where}: {name} is on {t.device}, expected "
                             f"the CUDA device of X ({X.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{where}: {name} is {t.dtype}; the kernel "
                            "takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} is not contiguous")


def _check(where, X, Fcat, pcat, scale, g=None):
    """Refuse what K1f and K1b do not take.  Two ranks: X (N, D), Fcat
    (D, K), pcat (K,) and one scale, or the same with a leading trial axis
    B on each and scale (B,); mixed ranks are refused.  Returns (B, N, D,
    K), B = 1 for the 2-D call."""
    tensors = {"Fcat": Fcat, "pcat": pcat, "scale": scale}
    if g is not None:
        tensors["g"] = g
    check_kernel_inputs(where, X, **tensors)
    if (X.dim() not in (2, 3) or Fcat.dim() != X.dim()
            or pcat.dim() != X.dim() - 1):
        raise ValueError(f"{where}: expected X (N, D), Fcat (D, K), pcat "
                         "(K,), or X (B, N, D), Fcat (B, D, K), pcat (B, K); "
                         f"got {tuple(X.shape)}, {tuple(Fcat.shape)}, "
                         f"{tuple(pcat.shape)}")
    lead = X.shape[:-2]
    if (Fcat.shape[:-2] != lead or pcat.shape[:-1] != lead
            or Fcat.shape[-2] != X.shape[-1]
            or pcat.shape[-1] != Fcat.shape[-1]):
        raise ValueError(f"{where}: shapes disagree: X {tuple(X.shape)}, "
                         f"Fcat {tuple(Fcat.shape)}, pcat {tuple(pcat.shape)}")
    want_g = (*X.shape[:-1], 2 * Fcat.shape[-1])
    if g is not None and tuple(g.shape) != want_g:
        raise ValueError(f"{where}: g is {tuple(g.shape)}, expected {want_g}")
    if lead and tuple(scale.shape) != tuple(lead):
        raise ValueError(f"{where}: scale is {tuple(scale.shape)}, expected "
                         f"one value a trial, {tuple(lead)}")
    if not lead and scale.numel() != 1:
        raise ValueError(f"{where}: scale must hold one value")
    trials = lead[0] if lead else 1
    if trials > MAX_TRIALS:
        raise ValueError(f"{where}: {trials} trials exceed {MAX_TRIALS}")
    if max(X.shape[-2], X.shape[-1], 2 * Fcat.shape[-1]) >= 2 ** 31:
        raise ValueError(f"{where}: a dimension exceeds int32")
    return trials, X.shape[-2], X.shape[-1], Fcat.shape[-1]


def refuse_grad(where, *tensors, through="FourierFeatures"):
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{where}: an input requires grad; differentiate "
                           f"through {through}, not the raw kernel")


def _phi_fwd(X, Fcat, pcat, scale):
    trials, n, d, k = _check("fourier_features_cuda", X, Fcat, pcat, scale)
    out = torch.empty((*X.shape[:-1], 2 * k), dtype=torch.float32,
                      device=X.device)
    if out.numel() == 0:
        return out
    lib = _library("phi_fwd")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.scfgp_phi_fwd_f32(X.data_ptr(), Fcat.data_ptr(),
                                   pcat.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), trials, n, d, k, stream)
    raise_on(lib, rc, "phi_fwd")
    fourier_features_cuda.launches += 1
    return out


def _phi_bwd(X, Fcat, pcat, scale, g):
    trials, n, d, k = _check("fourier_features_bwd_cuda", X, Fcat, pcat,
                             scale, g)
    lead = X.shape[:-2]
    width = d * k + k + 1
    launch = trials > 0 and n > 0 and k > 0
    out = (torch.empty if launch else torch.zeros)(
        (*lead, width), dtype=torch.float32, device=X.device)
    if launch:
        lib = _library("phi_bwd")
        part = torch.empty(lib.scfgp_phi_bwd_workspace(trials, n, d, k),
                           dtype=torch.float32, device=X.device)
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            rc = lib.scfgp_phi_bwd_f32(
                X.data_ptr(), Fcat.data_ptr(), pcat.data_ptr(),
                scale.data_ptr(), g.data_ptr(), part.data_ptr(),
                out.data_ptr(), trials, n, d, k, stream)
        raise_on(lib, rc, "phi_bwd")
        fourier_features_bwd_cuda.launches += 1
    return (out[..., :d * k].view(*lead, d, k), out[..., d * k:d * k + k],
            out[..., d * k + k])


def fourier_features_cuda(X: torch.Tensor, Fcat: torch.Tensor,
                          pcat: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Feature map (N, 2K) by the CUDA kernel, on PyTorch's current stream;
    with a leading trial axis (X (B, N, D), Fcat (B, D, K), pcat (B, K),
    scale (B,)) all B maps in one launch, (B, N, 2K), each trial bitwise
    the 2-D call on its own inputs.

    ``scale`` is a device tensor, read by the kernel through its pointer
    (no host synchronisation).  Raises on anything the kernel does not
    take, on inputs that require grad, and if the launch fails."""
    refuse_grad("fourier_features_cuda", X, Fcat, pcat, scale)
    return _phi_fwd(X, Fcat, pcat, scale)


def fourier_features_bwd_cuda(X: torch.Tensor, Fcat: torch.Tensor,
                              pcat: torch.Tensor, scale: torch.Tensor,
                              g: torch.Tensor):
    """``(dFcat (D, K), dpcat (K,), ds ())`` by the CUDA kernel from the
    cotangent ``g`` (N, 2K) of the feature map, on PyTorch's current
    stream; bitwise repeatable.  With a leading trial axis, one call for
    all B trials: ``(B, D, K), (B, K), (B,)``, each trial bitwise the 2-D
    call's.  Raises as ``fourier_features_cuda`` does."""
    refuse_grad("fourier_features_bwd_cuda", X, Fcat, pcat, scale, g)
    return _phi_bwd(X, Fcat, pcat, scale, g)


fourier_features_cuda.launches = 0
fourier_features_bwd_cuda.launches = 0


class FourierFeatures(torch.autograd.Function):
    """Feature map differentiable in (Fcat, pcat, scale): K1f forward, K1b
    backward on the card; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, X, Fcat, pcat, scale):
        ctx.save_for_backward(X, Fcat, pcat, scale)
        if X.device.type == "cpu":
            return fourier_features_ref(X, Fcat, pcat, scale)
        return _phi_fwd(X, Fcat, pcat, scale)

    @staticmethod
    def backward(ctx, g):
        X, Fcat, pcat, scale = ctx.saved_tensors
        if X.device.type == "cpu":
            dF, dp, ds = phi_bwd_ref(X, Fcat, pcat, scale, g)
        else:
            dF, dp, ds = _phi_bwd(X, Fcat, pcat, scale, g.contiguous())
        return None, dF, dp, ds.reshape(scale.shape)
