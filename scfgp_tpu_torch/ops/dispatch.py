"""The precision policy: which arithmetic the objective's two O(N K²)
GEMMs take, resolved per fit.

Port of ``scfgp_tpu/ops/dispatch.py``.  Two settings, orthogonal, as in
the JAX package:

* ``mm_dtype``, the width of the GEMMs' operands: ``None`` (the operands'
  own dtype), a reduced dtype such as ``torch.bfloat16`` (operands cast,
  products summed and returned in float32, in the forward GEMM and both
  backward GEMMs), or ``"auto"`` (``auto_mm_dtype``);
* ``mm_precision``, how a float32 GEMM is computed: ``None`` (whatever the
  process-wide setting is), ``"default"``, ``"high"``, ``"highest"``, or
  ``"auto"`` (``resolve_mm_precision``).

The arithmetic follows the JAX package; the hardware is the H100's:

| Setting | TPU (JAX package) | The port on an H100 |
|---|---|---|
| ``mm_precision=None`` | the global, "highest" | IEEE float32, TF32 off (torch's default) |
| ``"highest"`` | 6-pass true float32 | IEEE float32 |
| ``"high"`` | 3-pass bf16 | IEEE float32: the card has no native pass count between one TF32 pass and IEEE, so it gives at least the precision asked |
| ``"default"`` | one bf16 pass | TF32 tensor-core GEMM (one pass, 10-bit mantissa) |
| ``"auto"`` | "highest" for composites (``extra_basis``), "default" otherwise | the same rule |
| ``mm_dtype=bfloat16`` | bf16 operands, f32 accumulation, result in the operand's dtype, forward and both backward GEMMs | the same; a cuBLAS bf16 tensor-core GEMM with float32 output (``torch.mm``/``torch.bmm`` with ``out_dtype``) |
| ``mm_dtype="auto"`` | bf16 iff N·(2K)² >= 6.8e10 and no ``extra_basis`` | the same rule and threshold, carried over unchanged |

Only the objective's Gram ΦᵀΦ and Φ·L⁻ᵀ and their backward GEMMs take
the setting (``models/objective.py::_gemm``).  The trig projection, the
kernels K1f, K1b, K2f and K2b, the Cholesky chain, the GEMVs and
prediction stay IEEE.  ``"default"`` switches TF32 on
(``torch.backends.cuda.matmul.allow_tf32``) for exactly those GEMMs, in
the forward and, on autograd's own thread, in the backward, and restores
the switch after each (``matmul_tf32``): the process-wide setting is never
left changed.  A CPU matmul has no TF32, so on the CPU every precision is
IEEE and ``mm_dtype`` takes the plain upcast product.

``SCFGP``'s default ``mm_precision`` is None here (``DEFAULT_MM_PRECISION``),
where the JAX package's is "auto": by the JAX package's own criterion
TF32 was not quality-neutral on kin8nm on the card (PERF.md).  Two
guards of the JAX package come with "auto" (``models/model.py``):
a fit whose objective goes non-finite under an auto-resolved
``"default"`` is refit once at IEEE with a warning, and the samplers of
``fit_bayes`` run IEEE unless a setting was given explicitly.  Why the
JAX package chose this rule is in its module; what the card measures of
speed and quality is in ``PERF.md`` (``experiments/precision_quality.py``,
``experiments/precision_matrix.py``).
"""

from __future__ import annotations

import contextlib

import torch

# N·(2K)² at and above which "auto" takes bf16 GEMMs
# (``scfgp_tpu/ops/dispatch.py:63``).
BF16_GEMM_WORK_THRESHOLD = 6.8e10

_VALID_PRECISIONS = ("default", "high", "highest")

# ``SCFGP(mm_precision=)``'s default.  The JAX package's is "auto"; the
# card's quality matrix (experiments/precision_quality.py, 5 trials a
# class, PERF.md) found TF32 outside one trial std of IEEE on kin8nm, so
# by the JAX package's own criterion (scfgp_tpu/ops/dispatch.py:103-111)
# the port's default is IEEE.  "auto" keeps the JAX rule when asked for.
DEFAULT_MM_PRECISION = None


def auto_mm_dtype(n_rows: int, two_k: int, has_extra_basis: bool = False):
    """bf16 iff the O(N K²) GEMM work N·(2K)² reaches
    ``BF16_GEMM_WORK_THRESHOLD``, else None; composite models
    (``extra_basis``) never (``scfgp_tpu/ops/dispatch.py:66-80``)."""
    if has_extra_basis:
        return None
    work = float(n_rows) * float(two_k) ** 2
    return torch.bfloat16 if work >= BF16_GEMM_WORK_THRESHOLD else None


def resolve_mm_dtype(mm_dtype, n_rows: int, two_k: int,
                     has_extra_basis: bool = False):
    """A user ``mm_dtype`` setting ("auto" | None | a dtype) resolved."""
    if isinstance(mm_dtype, str):
        if mm_dtype != "auto":
            raise ValueError(f"mm_dtype={mm_dtype!r}: use 'auto', None, or "
                             "a dtype")
        return auto_mm_dtype(n_rows, two_k, has_extra_basis)
    return mm_dtype


def resolve_mm_precision(mm_precision, has_extra_basis: bool = False):
    """A user ``mm_precision`` setting resolved: "auto" is "highest" for
    composite models and "default" otherwise; None and the explicit values
    pass through; anything else raises.  Idempotent."""
    if mm_precision is None:
        return None
    if mm_precision == "auto":
        return "highest" if has_extra_basis else "default"
    if mm_precision not in _VALID_PRECISIONS:
        raise ValueError(
            f"mm_precision={mm_precision!r}: use 'auto', None, or one of "
            f"{_VALID_PRECISIONS}")
    return mm_precision


def uses_tf32(mm_precision) -> bool:
    """Whether an explicit precision computes float32 GEMMs in TF32 on the
    card: only "default" does.  "auto" is resolved by the model, which
    knows whether it is a composite; here it raises, as anything else."""
    if mm_precision not in _VALID_PRECISIONS:
        raise ValueError(
            f"mm_precision={mm_precision!r}: one of {_VALID_PRECISIONS} "
            "(resolve 'auto' first: resolve_mm_precision)")
    return mm_precision == "default"


@contextlib.contextmanager
def matmul_tf32(enabled: bool):
    """``torch.backends.cuda.matmul.allow_tf32`` set to ``enabled`` inside,
    and back to what it was after, whatever happens inside.  cuBLAS reads
    the switch at each GEMM, so it holds for the GEMMs issued inside."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    if before == enabled:
        yield
        return
    flags.allow_tf32 = enabled
    try:
        yield
    finally:
        flags.allow_tf32 = before
