"""K3 and K4: the blocked Cholesky factor of an SPD matrix, with its inverse
(K3) or alone (K4).

The port of ``scfgp_tpu/ops/cholesky.py``.  Two versions of each:

  * ``cholesky_cuda`` and ``cholesky_inverse_cuda`` launch the hand-written
    Hopper kernels of ``csrc/cholesky.cu``, the ports of the Pallas kernels
    ``_chol_step_kernel`` (K4) and ``_chol_inv_step_kernel`` (K3): a
    right-looking factorisation over 64-wide block columns in global memory,
    any n, no padding, bitwise repeatable; K3 emits ``L⁻¹`` from the same
    pass.  float32 only.  Their launch counts are ``cholesky_cuda.launches``
    and ``cholesky_inverse_cuda.launches``.
  * ``cholesky_ref`` and ``cholesky_inverse_ref`` are the plain PyTorch
    versions (``torch.linalg.cholesky_ex``, then a triangular solve against
    the identity, as ``_chol_inv_ref`` does): the CPU path and the kernels'
    references on the card.

A matrix that is not positive definite: the kernels clamp each pivot to
``sqrt(max(d, 1e-30))`` as the Pallas kernel does
(``scfgp_tpu/ops/cholesky.py:134``), so they return without an error, every
pivot in [1e-15, inf] and finite nonsense, inf or NaN (inf - inf) below
the diagonal; the plain versions return NaN in the lower triangle, as
``models/objective.py::chol_and_inverse`` and JAX's cholesky do.

``cholesky_kernel`` and ``cholesky_inverse_kernel`` are the entries, the
ports of ``cholesky_pallas`` and ``cholesky_inverse_pallas``: autograd
Functions that send a CUDA tensor to the kernel and a CPU tensor to the
plain version, with no fallback (the device decides; there is no interpret
switch).  Their backwards are closed forms from the saved factor:
``chol_bwd`` (the Cholesky VJP, equal to ``jax.vjp`` of
``jnp.linalg.cholesky``) and ``chol_inverse_bwd`` (the all-GEMM backward
that ``chol_and_inverse`` also uses).  The raw kernel wrappers refuse
tensors that require grad.

``tri_inverse_blocked`` is the block-Neumann triangular inverse of the
crossover experiment, plain PyTorch (it is composed of XLA ops in the JAX
package, not a kernel).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import load_library, raise_on
from .phi import refuse_grad

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"scfgp_chol_f32": ([_VOID] * 3 + [_INT, _VOID], ctypes.c_int),
               "scfgp_chol_inv_f32": ([_VOID] * 4 + [_INT, _VOID],
                                      ctypes.c_int),
               "scfgp_chol_workspace": ([_INT], ctypes.c_size_t)}


def cholesky_ref(A: torch.Tensor) -> torch.Tensor:
    """Plain lower Cholesky factor; NaN in the lower triangle where ``A``
    is not positive definite.  ``cholesky_ex`` neither raises nor
    synchronises with the host.  A stack of matrices (B, n, n) is factored
    matrix by matrix."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.tril(torch.full_like(L, math.nan)))


def cholesky_inverse_ref(A: torch.Tensor):
    """Plain ``(L, L⁻¹)``: the factor, then a triangular solve against the
    identity (``scfgp_tpu/ops/cholesky.py:330-334``); per matrix of a
    stack."""
    L = cholesky_ref(A)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def tri_inverse_blocked(L: torch.Tensor, block: int = 256) -> torch.Tensor:
    """``L⁻¹`` of a lower-triangular matrix by block-Neumann squaring
    (``scfgp_tpu/ops/cholesky.py:372-423``).  With ``D`` the block diagonal
    of ``L`` (``n/block`` triangular blocks, inverted by one batched solve)
    and ``N = D⁻¹ L - I`` strictly block-lower, hence nilpotent,
    ``(I + N)⁻¹ = prod_k (I - N^(2^k))`` exactly, and ``L⁻¹ = (I + N)⁻¹ D⁻¹``.
    Raises ``ValueError`` unless ``block`` divides n."""
    n = L.shape[0]
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    m = n // block
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    if m == 1:
        return torch.linalg.solve_triangular(L, eye, upper=False)
    diag = torch.stack([L[i * block:(i + 1) * block, i * block:(i + 1) * block]
                        for i in range(m)])
    eye_b = torch.eye(block, dtype=L.dtype, device=L.device).expand(
        m, block, block)
    dinv = torch.linalg.solve_triangular(diag, eye_b, upper=False)
    N = torch.einsum("mab,mbn->man", dinv, L.reshape(m, block, n)).reshape(
        n, n) - eye
    X, P = eye - N, N
    for _ in range(1, max((m - 1).bit_length(), 1)):  # ceil(log2 m) stages
        P = P @ P
        X = X @ (eye + P)
    return torch.einsum("nmb,mbc->nmc", X.reshape(n, m, block),
                        dinv).reshape(n, n)


def _phi(S: torch.Tensor) -> torch.Tensor:
    """``Φ(S) = tril(S) - diag(S)/2``, per matrix of a stack."""
    return torch.tril(S) - 0.5 * torch.diag_embed(
        torch.diagonal(S, dim1=-2, dim2=-1))


def chol_bwd(L: torch.Tensor, gL: torch.Tensor) -> torch.Tensor:
    """``Ā`` of ``L = chol(A)`` from ``L̄`` (Murray 2016):
    ``L⁻ᵀ Φ(Lᵀ L̄) L⁻¹``, symmetrised, through two triangular solves."""
    X = torch.linalg.solve_triangular(L.mT, _phi(L.mT @ gL), upper=True)
    Abar = torch.linalg.solve_triangular(L, X, upper=False, left=False)
    return 0.5 * (Abar + Abar.mT)


def chol_inverse_bwd(L: torch.Tensor, Li: torch.Tensor, gL: torch.Tensor,
                     gLi: torch.Tensor) -> torch.Tensor:
    """``Ā`` of ``(L, Li) = (chol(A), L⁻¹)`` with every inverse a GEMM
    against ``Li`` (``scfgp_tpu/models/objective.py:199-243``):

        gL_tot = gL - Liᵀ gLi Liᵀ
        Ā      = Liᵀ Φ(Lᵀ gL_tot) Li, symmetrised;

    per matrix of a stack."""
    gL_tot = gL - Li.mT @ gLi @ Li.mT  # an unused output's grad is zeros
    Abar = Li.mT @ _phi(L.mT @ gL_tot) @ Li
    return 0.5 * (Abar + Abar.mT)


def _check(where, A):
    """Refuse what the kernels do not take."""
    if A.device.type != "cuda":
        raise ValueError(f"{where}: A is on {A.device}, expected a CUDA "
                         "device")
    if A.dtype != torch.float32:
        raise TypeError(f"{where}: A is {A.dtype}; the kernel takes float32 "
                        "only")
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"{where}: A must be square, got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError(f"{where}: A is not contiguous")


def _launch(fn, A, outs):
    lib = load_library("cholesky", _SIGNATURES)
    n = A.shape[0]
    work = torch.empty(lib.scfgp_chol_workspace(n), dtype=torch.float32,
                       device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = getattr(lib, fn)(A.data_ptr(), *[t.data_ptr() for t in outs],
                              work.data_ptr(), n, stream)
    raise_on(lib, rc, fn)


def _chol(A):
    _check("cholesky_cuda", A)
    L = torch.empty_like(A)
    if A.shape[0] > 0:
        _launch("scfgp_chol_f32", A, (L,))
        cholesky_cuda.launches += 1
    return L


def _chol_inv(A):
    _check("cholesky_inverse_cuda", A)
    L, Li = torch.empty_like(A), torch.empty_like(A)
    if A.shape[0] > 0:
        _launch("scfgp_chol_inv_f32", A, (L, Li))
        cholesky_inverse_cuda.launches += 1
    return L, Li


def cholesky_cuda(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor by the CUDA kernel K4, on PyTorch's current
    stream; strict upper triangle exactly 0, bitwise repeatable.  Reads the
    lower triangle of ``A``.  Raises on anything the kernel does not take
    (a CPU tensor, a dtype other than float32, a non-square or
    non-contiguous matrix), on an input that requires grad, and if a launch
    fails."""
    refuse_grad("cholesky_cuda", A, through="cholesky_kernel")
    return _chol(A)


def cholesky_inverse_cuda(A: torch.Tensor):
    """``(L, L⁻¹)`` by the CUDA kernel K3 in one pass, on PyTorch's current
    stream; both strictly upper triangles exactly 0, bitwise repeatable.
    Raises as ``cholesky_cuda`` does."""
    refuse_grad("cholesky_inverse_cuda", A,
                through="cholesky_inverse_kernel")
    return _chol_inv(A)


cholesky_cuda.launches = 0
cholesky_inverse_cuda.launches = 0


class CholeskyFn(torch.autograd.Function):
    """``L = chol(A)``: K4 on the card, the plain version on the CPU;
    backward ``chol_bwd``."""

    @staticmethod
    def forward(ctx, A):
        L = cholesky_ref(A) if A.device.type == "cpu" else _chol(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        L, = ctx.saved_tensors
        return chol_bwd(L, gL)


class CholeskyInverseFn(torch.autograd.Function):
    """``(L, L⁻¹)``: K3 on the card, the plain version on the CPU; backward
    ``chol_inverse_bwd``."""

    @staticmethod
    def forward(ctx, A):
        L, Li = (cholesky_inverse_ref(A) if A.device.type == "cpu"
                 else _chol_inv(A))
        ctx.save_for_backward(L, Li)
        return L, Li

    @staticmethod
    def backward(ctx, gL, gLi):
        return chol_inverse_bwd(*ctx.saved_tensors, gL, gLi)


def cholesky_kernel(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A``, differentiable (the port of
    ``cholesky_pallas``)."""
    return CholeskyFn.apply(A)


def cholesky_inverse_kernel(A: torch.Tensor):
    """``(L, L⁻¹)`` of SPD ``A`` in one pass, differentiable (the port of
    ``cholesky_inverse_pallas``): what ``solve_posterior`` consumes."""
    return CholeskyInverseFn.apply(A)
