"""K2: the Phi-free sufficient statistics, forward and backward.

The weighted row sums of the objective (``reference:
SCFGP/SCFGP.py:104,108,126``) with ``Phi = s * [cos T | sin T]``,
``T = X @ Fcat + pcat``:

    phiTphi = Phiᵀ diag(w) Phi   (2K, 2K)      phiTy = Phiᵀ (w * y)   (2K,)
    yTy     = sum(w * y²)                      n     = sum(w)

Two versions of each direction:

  * ``sufficient_stats_cuda`` launches the hand-written Hopper kernel
    ``csrc/gram_fwd.cu``, the port of the Pallas kernel
    ``scfgp_tpu/ops/gram.py::_fwd_kernel``: Phi is never written for more
    rows than one chunk (an L2-sized scratch), the upper tiles of the Gram
    are summed by the register-blocked tile of ``csrc/sgemm_tile.cuh``, and
    the symmetric Gram is emitted directly.  ``sufficient_stats_bwd_cuda``
    launches ``csrc/gram_bwd.cu``, the port of ``_bwd_kernel``.  Both sum
    over rows in fixed orders, without atomics, so they are bitwise
    repeatable.  float32 only.  Their launch counts are
    ``sufficient_stats_cuda.launches`` and
    ``sufficient_stats_bwd_cuda.launches``.
  * ``sufficient_stats_ref`` and ``gram_bwd_ref`` are the plain PyTorch
    versions: the CPU path and the kernels' references on the card.

The backward, from the cotangents ``cbar`` (2K, 2K) of phiTphi and ``pbar``
(2K,) of phiTy, is the one the Pallas kernel computes
(``scfgp_tpu/ops/gram.py:96-116``).  With ``Abar = cbar + cbarᵀ``, the
unscaled features ``phi = [cos T | sin T]`` and ``G = [G_cos | G_sin]``:

    G     = w * (s * phi @ Abar + y * pbar)      (N, 2K), dL/dPhi
    dT    = s * (G_sin * cos T - G_cos * sin T)
    dFcat = Xᵀ dT,   dpcat = sum over rows of dT,
    ds    = sum(G_cos * cos T + G_sin * sin T)

``SufficientStatsFn`` joins the two into a ``torch.autograd.Function`` (the
``custom_vjp`` of ``scfgp_tpu/ops/gram.py:201-222``): it saves X, y, w,
Fcat, pcat and s, never Phi; X, y and w are data and get no gradient, and
the cotangents of yTy and n are ignored (they do not depend on the
params).  A CUDA tensor goes to the kernels, a CPU tensor to the plain
versions; there is no fallback.  ``sufficient_stats_kernel`` is the entry
from the params, the port of ``sufficient_stats_pallas``.  The Pallas
kernel computes in float32 whatever its input dtype; here the CUDA kernels
take float32 only and the plain versions keep the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.params import derive_frequencies, feature_scale
from ..utils.profiling import span
from .build import load_library, raise_on
from .phi import check_kernel_inputs, fourier_features_ref, refuse_grad

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gram_fwd": {"scfgp_gram_fwd_f32": ([_VOID] * 8 + [_INT] * 3 + [_VOID],
                                        ctypes.c_int),
                 "scfgp_gram_fwd_workspace": ([_INT] * 3, ctypes.c_size_t)},
    "gram_bwd": {"scfgp_gram_bwd_f32": ([_VOID] * 10 + [_INT] * 3 + [_VOID],
                                        ctypes.c_int),
                 "scfgp_gram_bwd_workspace": ([_INT] * 3, ctypes.c_size_t)},
}
_SPANS = {"gram_fwd": "scfgp.K2f", "gram_bwd": "scfgp.K2b"}
_THROUGH = "SufficientStatsFn"


def _ones_if_none(w, X):
    return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) \
        if w is None else w


def sufficient_stats_ref(X: torch.Tensor, y: torch.Tensor,
                         w: Optional[torch.Tensor], Fcat: torch.Tensor,
                         pcat: torch.Tensor, scale: torch.Tensor):
    """Plain PyTorch K2f: ``(phiTphi, phiTy, yTy, n)``, the features, then
    the weighted statistics.  ``w=None`` weighs every row 1."""
    w = _ones_if_none(w, X)
    Phi = fourier_features_ref(X, Fcat, pcat, scale)
    return (Phi.T @ (Phi * w[:, None]), Phi.T @ (w * y),
            torch.sum(w * y * y), torch.sum(w))


def gram_bwd_ref(X: torch.Tensor, y: torch.Tensor, w: Optional[torch.Tensor],
                 Fcat: torch.Tensor, pcat: torch.Tensor, scale: torch.Tensor,
                 cbar: torch.Tensor, pbar: torch.Tensor):
    """Plain PyTorch K2b: ``(dFcat, dpcat, ds)`` from the cotangents of
    phiTphi and phiTy, the formulas of ``scfgp_tpu/ops/gram.py:96-116``."""
    w = _ones_if_none(w, X)
    k = Fcat.shape[1]
    T = X @ Fcat + pcat
    c, sn = torch.cos(T), torch.sin(T)
    G = w[:, None] * (scale * (torch.cat([c, sn], dim=1) @ (cbar + cbar.T))
                      + y[:, None] * pbar)
    g_cos, g_sin = G[:, :k], G[:, k:]
    dT = scale * (g_sin * c - g_cos * sn)
    return X.T @ dT, dT.sum(dim=0), torch.sum(g_cos * c + g_sin * sn)


def _check(where, X, y, w, Fcat, pcat, scale, cbar=None, pbar=None):
    tensors = {"y": y, "Fcat": Fcat, "pcat": pcat, "scale": scale}
    for name, t in (("w", w), ("cbar", cbar), ("pbar", pbar)):
        if t is not None:
            tensors[name] = t
    check_kernel_inputs(where, X, **tensors)
    if X.dim() != 2 or Fcat.dim() != 2 or pcat.dim() != 1:
        raise ValueError(f"{where}: expected X (N, D), Fcat (D, K), pcat "
                         f"(K,); got {tuple(X.shape)}, {tuple(Fcat.shape)}, "
                         f"{tuple(pcat.shape)}")
    n, d = X.shape
    k = Fcat.shape[1]
    want = {"y": (n,), "w": (n,), "Fcat": (d, k), "pcat": (k,),
            "cbar": (2 * k, 2 * k), "pbar": (2 * k,)}
    for name, t in tensors.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{where}: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if scale.numel() != 1:
        raise ValueError(f"{where}: scale must hold one value")
    if k == 0:
        raise ValueError(f"{where}: K must be positive")
    if max(n, d, (2 * k) ** 2) >= 2 ** 31:
        raise ValueError(f"{where}: a dimension exceeds int32")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, X, args, out):
    """Allocate the workspace and launch ``name`` on the current stream;
    ``args`` are the tensors after X, in the C function's order (y, w,
    Fcat, ...)."""
    n, d = X.shape
    k = args[2].shape[1]
    with span(_SPANS[name], trials=1, n=n, d=d, k=k):
        lib = load_library(name, _SIGNATURES[name])
        work = torch.empty(getattr(lib, f"scfgp_{name}_workspace")(n, d, k),
                           dtype=torch.float32, device=X.device)
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            rc = getattr(lib, f"scfgp_{name}_f32")(
                *[_ptr(t) for t in (X, *args)], work.data_ptr(),
                out.data_ptr(), n, d, k, stream)
        raise_on(lib, rc, name)


def _gram_fwd(X, y, w, Fcat, pcat, scale):
    _check("sufficient_stats_cuda", X, y, w, Fcat, pcat, scale)
    n = X.shape[0]
    k2 = 2 * Fcat.shape[1]
    out = (torch.empty if n > 0 else torch.zeros)(
        k2 * k2 + k2 + 2, dtype=torch.float32, device=X.device)
    if n > 0:
        _launch("gram_fwd", X, (y, w, Fcat, pcat, scale), out)
        sufficient_stats_cuda.launches += 1
    return (out[:k2 * k2].view(k2, k2), out[k2 * k2:k2 * k2 + k2],
            out[k2 * k2 + k2], out[k2 * k2 + k2 + 1])


def _gram_bwd(X, y, w, Fcat, pcat, scale, cbar, pbar):
    _check("sufficient_stats_bwd_cuda", X, y, w, Fcat, pcat, scale, cbar,
           pbar)
    n, d = X.shape
    k = Fcat.shape[1]
    out = (torch.empty if n > 0 else torch.zeros)(
        d * k + k + 1, dtype=torch.float32, device=X.device)
    if n > 0:
        _launch("gram_bwd", X, (y, w, Fcat, pcat, scale, cbar, pbar), out)
        sufficient_stats_bwd_cuda.launches += 1
    return out[:d * k].view(d, k), out[d * k:d * k + k], out[d * k + k]


def sufficient_stats_cuda(X: torch.Tensor, y: torch.Tensor,
                          w: Optional[torch.Tensor], Fcat: torch.Tensor,
                          pcat: torch.Tensor, scale: torch.Tensor):
    """``(phiTphi (2K, 2K), phiTy (2K,), yTy (), n ())`` by the CUDA kernel
    K2f, on PyTorch's current stream; phiTphi is exactly symmetric and the
    result is bitwise repeatable.  ``w=None`` weighs every row 1; ``scale``
    is a one-element device tensor read through its pointer.  Raises on
    anything the kernel does not take, on inputs that require grad, and if
    the launch fails."""
    refuse_grad("sufficient_stats_cuda", X, y, w, Fcat, pcat, scale,
                through=_THROUGH)
    return _gram_fwd(X, y, w, Fcat, pcat, scale)


def sufficient_stats_bwd_cuda(X: torch.Tensor, y: torch.Tensor,
                              w: Optional[torch.Tensor], Fcat: torch.Tensor,
                              pcat: torch.Tensor, scale: torch.Tensor,
                              cbar: torch.Tensor, pbar: torch.Tensor):
    """``(dFcat (D, K), dpcat (K,), ds ())`` by the CUDA kernel K2b from the
    cotangents ``cbar`` (2K, 2K) of phiTphi and ``pbar`` (2K,) of phiTy;
    bitwise repeatable.  Raises as ``sufficient_stats_cuda`` does."""
    refuse_grad("sufficient_stats_bwd_cuda", X, y, w, Fcat, pcat, scale,
                cbar, pbar, through=_THROUGH)
    return _gram_bwd(X, y, w, Fcat, pcat, scale, cbar, pbar)


sufficient_stats_cuda.launches = 0
sufficient_stats_bwd_cuda.launches = 0


class SufficientStatsFn(torch.autograd.Function):
    """``(phiTphi, phiTy, yTy, n)`` differentiable in (Fcat, pcat, scale):
    K2f forward, K2b backward on the card; the plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, X, y, w, Fcat, pcat, scale):
        ctx.save_for_backward(X, y, w, Fcat, pcat, scale)
        if X.device.type == "cpu":
            return sufficient_stats_ref(X, y, w, Fcat, pcat, scale)
        return _gram_fwd(X, y, w, Fcat, pcat, scale)

    @staticmethod
    def backward(ctx, cbar, pbar, _ybar, _nbar):
        X, y, w, Fcat, pcat, scale = ctx.saved_tensors
        if X.device.type == "cpu":
            dF, dp, ds = gram_bwd_ref(X, y, w, Fcat, pcat, scale, cbar, pbar)
        else:
            dF, dp, ds = _gram_bwd(X, y, w, Fcat, pcat, scale,
                                   cbar.contiguous(), pbar.contiguous())
        return None, None, None, dF, dp, ds.reshape(scale.shape)


def sufficient_stats_kernel(p, X: torch.Tensor, y: torch.Tensor,
                            w: Optional[torch.Tensor] = None):
    """Phi-free sufficient statistics for the params ``p`` (the port of
    ``scfgp_tpu/ops/gram.py:225-241``): a ``SufficientStats``,
    differentiable in the params; X, y and w are data."""
    from ..models.objective import SufficientStats

    d = derive_frequencies(p)
    if w is not None:
        w = w.reshape(-1).to(X.dtype)
    return SufficientStats(*SufficientStatsFn.apply(
        X, y.reshape(-1), w, d.Fcat, d.pcat, feature_scale(p)))
