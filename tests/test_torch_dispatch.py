"""The precision policy of the port (``scfgp_tpu_torch/ops/dispatch.py``
and the GEMMs of ``models/objective.py``) against the JAX package's
(``scfgp_tpu/ops/dispatch.py``, ``scfgp_tpu/models/objective.py``), on the
CPU.

Both packages get the same θ and data as NumPy arrays.  A CPU matmul has
no TF32, so every ``mm_precision`` is IEEE float32 here as XLA's CPU dots
are; ``mm_dtype=bfloat16`` rounds the GEMMs' operands to bf16 on both
sides, and its products (exact in float32) are summed in float32 in
another order.  Tolerances, each with its reason:
  * the rules: equal results, and ValueError where JAX raises;
  * float64 operands under ``mm_precision``: rtol 1e-10, the same float64
    math in another summation order through a 2K x 2K Cholesky;
  * float64 operands under ``mm_dtype=bfloat16``: the Gram and Φ·L⁻ᵀ
    carry float32 sums of up to N terms (each within about N·u32 = 7e-6 of
    the exact sum's magnitude at N = 120, typically ~1e-7), which the
    bf16-scaled jitter keeps well conditioned (cond(A) < 1e3 here): rtol
    1e-5 on the cost and the posterior, and 1e-4 of each gradient leaf's
    largest entry (the cotangent is rounded to bf16 before the backward
    GEMMs on both sides, and a value within 2^-24 of a bf16 tie may round
    to either neighbour through float32);
  * the jitter of ``solve_posterior(mm_dtype=)``: rtol 1e-12 (one trace).
"""

import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scfgp_tpu
from scfgp_tpu.models import objective as jobj
from scfgp_tpu.models.params import init_params
from scfgp_tpu.ops import dispatch as jdispatch
from scfgp_tpu.ops.streaming import loss_fn_streaming as jax_streaming
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.bayes import make_logposterior
from scfgp_tpu_torch.models import model as tmodel
from scfgp_tpu_torch.models import objective as tobj
from scfgp_tpu_torch.models.params import params_from_numpy
from scfgp_tpu_torch.ops import dispatch as tdispatch
from scfgp_tpu_torch.ops.streaming import loss_fn_streaming

torch.set_num_threads(1)

N, D, S, M = 120, 5, 4, 7
PRECISIONS = [None, "default", "high", "highest"]


def _to_torch_dtype(dt):
    return None if dt is None else {jnp.bfloat16: torch.bfloat16}[dt]


def _problem(seed=0, n=N, trials=None):
    """θ (a list of leaves, each with a leading trial axis if ``trials``)
    from the JAX init in float64, data from NumPy."""
    rng = np.random.RandomState(seed)
    X, y = rng.randn(n, D), rng.randn(n)
    if trials is None:
        theta = [np.asarray(a) for a in init_params(
            jax.random.PRNGKey(seed), D, S, M, jnp.float64)]
    else:
        theta = [np.stack(leaves) for leaves in zip(*[
            [np.asarray(a) for a in init_params(
                jax.random.PRNGKey(seed + b), D, S, M, jnp.float64)]
            for b in range(trials)])]
    return theta, X, y


def _jax_params(theta):
    return jobj.SCFGPParams(*[jnp.asarray(a) for a in theta])


def _leaf_errors(g, ref):
    """Each leaf's largest difference relative to its largest entry (phase
    leaves, pure gauge, relative to the largest entry of any leaf)."""
    top = max(float(np.abs(b).max()) for b in ref)
    out = {}
    for field, a, b in zip(jobj.SCFGPParams._fields, g, ref):
        den = top if "phase" in field else float(np.abs(b).max())
        out[field] = float(np.abs(np.asarray(a) - np.asarray(b)).max()) / den
    return out


# -- the rules ---------------------------------------------------------------

RULE_CASES = (
    [("auto_mm_dtype", (n, k, e)) for n in (2048, 8192, 65536, 1_000_000)
     for k in (500, 1024, 2048) for e in (False, True)]
    + [("resolve_mm_dtype", (s, n, k, e))
       for s in (None, "auto", "bf16", "bfloat16")
       for n, k in ((8192, 500), (65536, 1024)) for e in (False, True)]
    + [("resolve_mm_dtype", ("bf16-dtype", 8, 8, False))]
    + [("resolve_mm_precision", (s, e))
       for s in (None, "auto", "default", "high", "highest", "fastest", "")
       for e in (False, True)])


def _call(module, fn, args):
    """``module.fn(*args)``, the string "bf16-dtype" standing for that
    package's bf16 dtype; a raised ValueError comes back as its type."""
    bf16 = jnp.bfloat16 if module is jdispatch else torch.bfloat16
    args = [bf16 if a == "bf16-dtype" else a for a in args]
    try:
        out = getattr(module, fn)(*args)
    except ValueError:
        return ValueError
    if module is jdispatch and out is jnp.bfloat16:
        return torch.bfloat16
    return out


@pytest.mark.parametrize("fn,args", RULE_CASES)
def test_rules_equal_jax(fn, args):
    """``auto_mm_dtype``, ``resolve_mm_dtype`` and ``resolve_mm_precision``
    give the JAX package's answer at every (N, 2K, extra_basis, setting),
    ValueError included (tests/test_dispatch.py:17-95)."""
    assert tdispatch.BF16_GEMM_WORK_THRESHOLD == \
        jdispatch.BF16_GEMM_WORK_THRESHOLD
    assert tdispatch._VALID_PRECISIONS == jdispatch._VALID_PRECISIONS
    assert _call(tdispatch, fn, args) == _call(jdispatch, fn, args)


# -- the objective -----------------------------------------------------------

def _port_loss(theta, X, y, trials, **kw):
    p = params_from_numpy(theta, dtype=torch.float64)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    if trials:
        Xt, yt = Xt.expand(trials, -1, -1), yt.expand(trials, -1)
    (cost, aux), g = tobj.loss_and_grad(p, Xt, yt, **kw)
    return cost.numpy(), aux, [t.numpy() for t in g]


def _jax_loss(theta, X, y, trials, **kw):
    def one(q):
        return jobj.loss_fn(q, jnp.asarray(X), jnp.asarray(y), **kw)
    vg = jax.value_and_grad(one, has_aux=True)
    if trials:
        vg = jax.vmap(vg)
    (cost, aux), g = jax.jit(vg)(_jax_params(theta))
    return np.asarray(cost), aux, [np.asarray(t) for t in g]


@pytest.mark.parametrize("trials", [None, 3])
def test_bf16_loss_and_gradient_equal_jax(trials):
    """``loss_fn`` and its gradient under ``mm_dtype=bfloat16``, in float64
    operands, against JAX's ``loss_fn(mm_dtype=jnp.bfloat16)``
    (tests/test_objective.py:146-165), 2-D and with a trial axis of 3
    (``jax.vmap`` on the JAX side)."""
    theta, X, y = _problem(seed=3, trials=trials)
    c_t, aux_t, g_t = _port_loss(theta, X, y, trials,
                                 mm_dtype=torch.bfloat16)
    c_j, aux_j, g_j = _jax_loss(theta, X, y, trials, mm_dtype=jnp.bfloat16)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)
    for name in ("L", "alpha", "beta"):
        a = np.asarray(getattr(aux_j.post, name))
        np.testing.assert_allclose(getattr(aux_t.post, name).numpy(), a,
                                   rtol=1e-5, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)
    errs = _leaf_errors(g_t, g_j)
    assert max(errs.values()) <= 1e-4, errs
    # bf16 moves the objective: the comparison is not that of IEEE runs.
    c_ieee = _port_loss(theta, X, y, trials)[0]
    assert np.abs(c_j - c_ieee).max() > 1e3 * np.abs(c_t - c_j).max()


@pytest.mark.parametrize("trials", [None, 3])
def test_solve_posterior_bf16_jitter_equals_jax(trials):
    """The jitter ``eps(bf16) trace(ΦᵀΦ) / 2K`` per trial, and the posterior
    it gives, against JAX's ``solve_posterior(mm_dtype=)``
    (``scfgp_tpu/models/objective.py:246-270``)."""
    theta, X, y = _problem(seed=4, trials=trials)
    rng = np.random.RandomState(4)
    B = () if trials is None else (trials,)
    Phi = rng.randn(*B, N, 2 * (S + M))
    sig2 = np.exp(2.0 * np.asarray(theta[0]))

    def jax_post(phi, s2):
        st = jobj.sufficient_stats(jnp.asarray(phi), jnp.asarray(y))
        return jobj.solve_posterior(st, jnp.asarray(s2),
                                    mm_dtype=jnp.bfloat16)
    ref = (jax.vmap(jax_post)(Phi, sig2) if trials
           else jax_post(Phi, sig2))
    yt = torch.as_tensor(y).expand(*B, N)
    st = tobj.sufficient_stats(torch.as_tensor(Phi), yt)
    got = tobj.solve_posterior(st, torch.as_tensor(sig2),
                               mm_dtype=torch.bfloat16)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    plain = tobj.solve_posterior(st, torch.as_tensor(sig2))
    assert not torch.allclose(plain.L, got.L)


# XLA's CPU dots are IEEE at every precision setting, so JAX's result on
# the CPU is the same under each (tests/test_dispatch.py:190): one JAX
# reference a problem, made once, serves every setting of the port.

@functools.lru_cache(maxsize=None)
def _jax_dense():
    """JAX's cost and gradient on the problem of
    ``test_loss_under_each_precision_equals_jax``."""
    theta, X, y = _problem(seed=5)
    c, _, g = _jax_loss(theta, X, y, None)
    return c, g


@pytest.mark.parametrize("mm_precision", PRECISIONS)
def test_loss_under_each_precision_equals_jax(mm_precision):
    """``loss_fn`` and its gradient under every ``mm_precision`` against
    JAX's on the CPU, where both are IEEE (tests/test_dispatch.py:190);
    the process-wide TF32 switch is as it was after the call."""
    theta, X, y = _problem(seed=5)
    before = torch.backends.cuda.matmul.allow_tf32
    c_t, _, g_t = _port_loss(theta, X, y, None, mm_precision=mm_precision)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    c_j, g_j = _jax_dense()
    np.testing.assert_allclose(c_t, c_j, rtol=1e-10)
    assert max(_leaf_errors(g_t, g_j).values()) <= 1e-8


@functools.lru_cache(maxsize=None)
def _jax_streaming():
    """JAX's streaming cost and gradient on the problem of
    ``test_streaming_under_each_precision_equals_jax``."""
    theta, X, y = _problem(seed=6, n=110)
    (c, _), g = jax.jit(jax.value_and_grad(
        lambda q: jax_streaming(q, jnp.asarray(X), jnp.asarray(y),
                                block_size=32),
        has_aux=True))(_jax_params(theta))
    return float(c), [np.asarray(t) for t in g]


@pytest.mark.parametrize("mm_precision", PRECISIONS)
@pytest.mark.parametrize("route", ["gemm", "kernel"])
def test_streaming_under_each_precision_equals_jax(route, mm_precision):
    """``loss_fn_streaming(mm_precision=)`` on both routes against JAX's
    streaming objective, in 4 blocks (one ragged)."""
    theta, X, y = _problem(seed=6, n=110)
    p = params_from_numpy(theta, dtype=torch.float64)
    (c_t, _), g_t = tobj.value_and_grad(
        loss_fn_streaming, p, torch.as_tensor(X), torch.as_tensor(y),
        stats_impl=route, block_size=32, mm_precision=mm_precision)
    c_j, g_j = _jax_streaming()
    np.testing.assert_allclose(float(c_t), c_j, rtol=1e-10)
    assert max(_leaf_errors([t.numpy() for t in g_t], g_j).values()) \
        <= 1e-8


def test_streaming_logposterior_ignores_mm_dtype_as_jax():
    """The streaming log posterior takes ``mm_precision`` and not
    ``mm_dtype`` in both packages (``scfgp_tpu/bayes/predictive.py:57-63``):
    under ``mm_dtype=bfloat16`` it equals its IEEE value, dense it does
    not."""
    theta, X, y = _problem(seed=7)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    th = torch.as_tensor(np.concatenate([np.ravel(a) for a in theta]))
    kw = dict(include_phases=True)
    lp16 = make_logposterior(Xt, yt, D, S, M, streaming_block=50,
                             mm_dtype=torch.bfloat16, **kw)(th)
    lp32 = make_logposterior(Xt, yt, D, S, M, streaming_block=50, **kw)(th)
    assert float(lp16) == float(lp32)
    dense16 = make_logposterior(Xt, yt, D, S, M, mm_dtype=torch.bfloat16,
                                **kw)(th)
    assert abs(float(dense16) - float(lp32)) > 1e-6 * abs(float(lp32))


def _sgld_problem():
    from scfgp_tpu.models.params import pack_params as jax_pack
    from scfgp_tpu_torch.models.params import reduced_dim
    _, X, y = _problem(seed=11)
    P = reduced_dim(D, S, M)
    q = np.stack([np.asarray(jax_pack(init_params(
        jax.random.PRNGKey(b), D, S, M, jnp.float64)))[:P]
        for b in range(2)])
    return X, y, q


@functools.lru_cache(maxsize=None)
def _jax_sgld(streaming_block):
    """JAX's full-data SGLD estimator on ``_sgld_problem``."""
    from scfgp_tpu.bayes import sgld as jsgld
    X, y, q = _sgld_problem()
    v, g = jax.jit(jsgld.make_minibatch_value_and_grad(
        jnp.asarray(X), jnp.asarray(y), D, S, M, batch_size=0,
        streaming_block=streaming_block))(jnp.asarray(q),
                                          jax.random.PRNGKey(0))
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("streaming_block", [0, 50])
@pytest.mark.parametrize("mm_precision", ["default", "highest"])
def test_sgld_estimator_takes_the_precision_as_jax(mm_precision,
                                                   streaming_block):
    """SGLD's full-data estimator (``make_minibatch_value_and_grad``,
    dense and streaming) takes ``mm_precision`` as JAX's
    (``scfgp_tpu/bayes/sgld.py:69-103``): on the CPU, IEEE on both sides,
    the JAX values at rtol 1e-9 (the port's residual data-fit form against
    the reference form, equal in float64 to that)."""
    from scfgp_tpu_torch.bayes import make_minibatch_value_and_grad
    X, y, q = _sgld_problem()
    v_j, g_j = _jax_sgld(streaming_block)
    v, g = make_minibatch_value_and_grad(
        torch.as_tensor(X), torch.as_tensor(y), D, S, M, batch_size=0,
        streaming_block=streaming_block, mm_precision=mm_precision)(
            torch.as_tensor(q), None)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0,
                               atol=1e-9 * np.abs(g_j).max())


def test_gemms_run_tf32_only_under_default_and_restore_the_switch():
    """Under "default" the Gram's and Φ·L⁻ᵀ's forward GEMMs and their four
    backward GEMMs, and only they, run with TF32 on (the backward sets the
    switch itself, on autograd's side); under every other setting no GEMM
    does; the switch is off again after each step.  A dispatch mode
    records every aten product and the switch at its call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.split(".")[0] in ("mm", "bmm", "mv", "addmm"):
                self.calls.append((tuple(tuple(a.shape) for a in args[:2]),
                                   torch.backends.cuda.matmul.allow_tf32))
            return func(*args, **(kwargs or {}))

    theta, X, y = _problem(seed=8)
    K2 = 2 * (S + M)
    gemms = {((K2, N), (N, K2)),     # the Gram; Φ·L⁻ᵀ's backward, dLi
             ((N, K2), (K2, K2)),    # Φ·L⁻ᵀ; the Gram's backward, dΦ
             ((K2, K2), (K2, N))}    # the backward of both, into dΦ
    assert not torch.backends.cuda.matmul.allow_tf32
    for mm_precision in PRECISIONS:
        rec = Record()
        with rec:
            _port_loss(theta, X, y, None, mm_precision=mm_precision)
        assert not torch.backends.cuda.matmul.allow_tf32
        tf32 = [shapes for shapes, on in rec.calls if on]
        if mm_precision == "default":
            assert len(tf32) == 6 and set(tf32) == gemms, rec.calls
            assert len(rec.calls) > len(tf32)  # the rest stays IEEE
        else:
            assert not tf32, (mm_precision, rec.calls)


def test_matmul_tf32_restores_the_switch_on_error():
    flags = torch.backends.cuda.matmul
    assert not flags.allow_tf32
    with pytest.raises(RuntimeError):
        with tdispatch.matmul_tf32(True):
            assert flags.allow_tf32
            raise RuntimeError("inside")
    assert not flags.allow_tf32


# -- the model ---------------------------------------------------------------

MODEL_CASES = [
    # (mm_dtype, mm_precision, composite, N, S, M)
    (None, "auto", False, 256, 4, 10),
    (None, "auto", True, 256, 4, 10),
    (None, None, False, 256, 4, 10),
    ("auto", "auto", False, 256, 4, 10),
    ("auto", "highest", False, 65536, 112, 400),
    ("auto", "auto", True, 65536, 112, 400),
    ("bf16-dtype", "default", False, 256, 4, 10),
]


def _basis(xp):
    def basis(X):
        return xp.concatenate([xp.ones_like(X[:, :1]), X[:, :1]], axis=1)
    return basis


@pytest.mark.parametrize("mm_dtype,mm_precision,composite,n,s,m",
                         MODEL_CASES)
def test_model_resolves_settings_at_set_data_as_jax(mm_dtype, mm_precision,
                                                    composite, n, s, m):
    """``set_data`` resolves the settings and marks what was auto-resolved
    as JAX's ``set_data`` does (tests/test_dispatch.py:39-87).  The
    constructor's ``mm_dtype`` default is JAX's; its ``mm_precision``
    default is ``DEFAULT_MM_PRECISION``, IEEE, which the card's quality
    matrix chose over JAX's "auto" (PERF.md)."""
    import inspect
    sig, jsig = (inspect.signature(c).parameters
                 for c in (SCFGP, scfgp_tpu.SCFGP))
    assert sig["mm_dtype"].default == jsig["mm_dtype"].default is None
    assert sig["mm_precision"].default is tdispatch.DEFAULT_MM_PRECISION
    assert jsig["mm_precision"].default == "auto"
    rng = np.random.RandomState(9)
    X = rng.rand(n, 3).astype(np.float32)
    y = rng.randn(n).astype(np.float32)
    kw = dict(sparsity=s, nfeats=m, seed=0, X_scaling_method="normal",
              y_scaling_method="normal", mm_precision=mm_precision)
    jm = scfgp_tpu.SCFGP(
        mm_dtype=jnp.bfloat16 if mm_dtype == "bf16-dtype" else mm_dtype,
        extra_basis=_basis(jnp) if composite else None, **kw)
    tm = SCFGP(mm_dtype=torch.bfloat16 if mm_dtype == "bf16-dtype"
               else mm_dtype, extra_basis=_basis(torch) if composite
               else None, device="cpu", **kw)
    jm.set_data(X, y)
    tm.set_data(X, y)
    assert tm.mm_dtype == _to_torch_dtype(jm.mm_dtype)
    assert tm.mm_precision == jm.mm_precision
    assert tm._mm_dtype_auto == jm._mm_dtype_auto
    assert tm._mm_precision_auto == jm._mm_precision_auto


def test_update_data_jitter_equals_jax():
    """``update_data`` under ``mm_dtype=bfloat16``: IEEE statistics, the
    bf16-scaled jitter (``scfgp_tpu/models/model.py:1555-1561``); the same
    θ on both models."""
    theta, X, y = _problem(seed=10, n=150)
    kw = dict(sparsity=S, nfeats=M, seed=0, X_scaling_method="normal",
              y_scaling_method="normal")
    jm = scfgp_tpu.SCFGP(mm_dtype=jnp.bfloat16, dtype=jnp.float64, **kw)
    tm = SCFGP(mm_dtype=torch.bfloat16, dtype=torch.float64, device="cpu",
               **kw)
    for m in (jm, tm):
        m.set_data(X[:120], y[:120])
    jm.params = _jax_params(theta)
    tm.params = params_from_numpy(theta, dtype=torch.float64)
    jm.update_data(X[120:], y[120:])
    tm.update_data(X[120:], y[120:])
    for name in tm.post._fields:
        a = np.asarray(getattr(jm.post, name))
        np.testing.assert_allclose(getattr(tm.post, name).numpy(), a,
                                   rtol=1e-9, atol=1e-9 * np.abs(a).max(),
                                   err_msg=name)


def _poison(monkeypatch, precision="default"):
    """The model's losses return a NaN cost under ``precision``: the class
    of fits the auto-resolved TF32 breaks (tests/test_dispatch.py:116-150)."""
    real_loss, real_vg = tmodel.loss_fn, tmodel.loss_and_grad

    def loss_fn(*a, **kw):
        cost, aux = real_loss(*a, **kw)
        if kw.get("mm_precision") == precision:
            cost = cost * float("nan")
        return cost, aux

    def loss_and_grad(*a, **kw):
        (cost, aux), g = real_vg(*a, **kw)
        if kw.get("mm_precision") == precision:
            cost = cost * float("nan")
        return (cost, aux), g

    monkeypatch.setattr(tmodel, "loss_fn", loss_fn)
    monkeypatch.setattr(tmodel, "loss_and_grad", loss_and_grad)


def _sine(seed, n=80):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 2) * 5
    return X, np.sin(X[:, 0]) + 0.1 * rng.randn(n)


def test_fallback_predicate_as_jax():
    """The refit arms only under an auto-resolved "default": a non-finite
    last cost (or params) arms it, an explicit setting never; the same
    answers as JAX's ``_precision_fallback_needed``
    (tests/test_dispatch.py:97-113)."""
    X, y = _sine(4, 64)
    scalers = dict(X_scaling_method="normal", y_scaling_method="normal")
    for kw in ({"mm_precision": "auto"}, {"mm_precision": "default"},
               {"mm_precision": None}):
        jm = scfgp_tpu.SCFGP(sparsity=4, nfeats=8, seed=0, **scalers, **kw)
        tm = SCFGP(sparsity=4, nfeats=8, seed=0, device="cpu", **scalers,
                   **kw)
        for m in (jm, tm):
            m.set_data(X, y)
        for last in (float("nan"), 1.25, float("inf")):
            answers = []
            for m in (jm, tm):
                m.evals["COST"][1] = [last]
                answers.append(m._precision_fallback_needed())
            assert answers[0] == answers[1], (kw, last, answers)
    tm = SCFGP(sparsity=4, nfeats=8, seed=0, mm_precision="auto",
               device="cpu")
    tm.set_data(X, y)
    tm.evals["COST"][1] = [1.0]
    tm.params = tm.params._replace(a=tm.params.a * float("nan"))
    assert tm._precision_fallback_needed()


@pytest.mark.parametrize("entry", ["fit", "fit_fast", "fit_fast_batch"])
def test_non_finite_fit_is_refit_at_ieee(monkeypatch, entry):
    """A fit whose objective goes non-finite under the auto-resolved
    "default" is refit once at IEEE with a warning, by the host loop, the
    fused loop, and per trial in ``fit_fast_batch``
    (``scfgp_tpu/models/model.py:782, 951, 310-322``)."""
    _poison(monkeypatch)
    X, y = _sine(5)
    models = [SCFGP(sparsity=4, nfeats=8, seed=b, mm_precision="auto",
                    device="cpu")
              for b in range(2 if entry == "fit_fast_batch" else 1)]
    with pytest.warns(UserWarning, match="non-finite objective"):
        if entry == "fit_fast_batch":
            tmodel.fit_fast_batch(models, [(X, y)] * 2, max_iter=15)
        else:
            getattr(models[0], entry)(X, y, max_iter=15)
    for m in models:
        assert m.mm_precision is None and not m._mm_precision_auto
        assert math.isfinite(m.evals["COST"][1][-1])
        assert all(bool(torch.isfinite(t).all()) for t in m.params)


def test_explicit_default_is_never_overridden(monkeypatch):
    _poison(monkeypatch)
    X, y = _sine(6)
    m = SCFGP(sparsity=4, nfeats=8, seed=0, mm_precision="default",
              device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.fit_fast(X, y, max_iter=15)
    assert m.mm_precision == "default"
    assert not math.isfinite(m.evals["COST"][1][-1])


def test_fit_bayes_keeps_auto_precision_off_the_samplers(monkeypatch):
    """The samplers' log posterior gets None under the auto-resolved
    settings and an explicit setting as given
    (tests/test_dispatch.py:153-187; ``model.py:1205-1234``)."""
    import scfgp_tpu_torch.bayes as bayes
    seen = []
    real = bayes.make_logposterior

    def spy(*a, **kw):
        seen.append((kw.get("mm_dtype"), kw.get("mm_precision")))
        return real(*a, **kw)

    monkeypatch.setattr(bayes, "make_logposterior", spy)
    rng = np.random.RandomState(6)
    X = rng.rand(120, 1) * 10
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(120)
    fit = dict(sampler="hmc", chains=2, num_warmup=4, num_samples=4,
               num_integration_steps=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = SCFGP(sparsity=4, nfeats=8, seed=0, mm_precision="auto",
                  device="cpu")
        m.fit_bayes(X, y, **fit)
        assert m.mm_precision == "default"   # fits keep the setting
        assert seen == [(None, None)]
        m2 = SCFGP(sparsity=4, nfeats=8, seed=0, mm_precision="default",
                   mm_dtype=torch.bfloat16, device="cpu")
        m2.fit_bayes(X, y, **fit)
    assert seen[-1] == (torch.bfloat16, "default")


def test_bf16_model_trains_without_nan():
    """``mm_dtype=bfloat16`` through the model API stays finite and lands
    near the float32 fit (tests/test_model_variants.py:61-75)."""
    rng = np.random.RandomState(0)
    X = rng.rand(300, 1) * 10
    y = np.sin(X[:, 0]) * 2 + 0.1 * rng.randn(300) + 3
    m = SCFGP(sparsity=8, nfeats=12, seed=0, mm_dtype=torch.bfloat16,
              device="cpu")
    m.fit(X[:250], y[:250], X[250:], y[250:], max_iter=100)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert np.isfinite(nmse) and nmse < 0.08, nmse


@pytest.mark.parametrize("other", [
    dict(mm_precision=None), dict(mm_precision="highest"),
    dict(mm_dtype=torch.bfloat16)])
def test_fit_fast_batch_refuses_mixed_settings(other):
    X, y = _sine(7, 40)
    ms = [SCFGP(sparsity=2, nfeats=4, seed=0, mm_precision="auto",
                device="cpu"),
          SCFGP(sparsity=2, nfeats=4, seed=1, device="cpu",
                **{"mm_precision": "auto", **other})]
    with pytest.raises(ValueError, match="mm_precision"):
        tmodel.fit_fast_batch(ms, [(X, y)] * 2, max_iter=3)


def test_fit_ensemble_members_keep_auto(monkeypatch):
    """Members get "auto" while the parent's setting was auto-resolved, so
    their refit stays armed, and an explicit setting as it is
    (``scfgp_tpu/models/model.py:998-1003``)."""
    X, y = _sine(8, 60)
    seen = []
    real = tmodel.fit_fast_batch

    def spy(models, data, **kw):
        seen.extend((m.mm_precision, m.mm_dtype) for m in models)
        return real(models, data, **kw)

    monkeypatch.setattr(tmodel, "fit_fast_batch", spy)
    m = SCFGP(sparsity=2, nfeats=4, seed=0, mm_precision="auto",
              device="cpu")
    m.set_data(X, y)   # "auto" resolved to "default" on the parent
    m.fit_ensemble(X, y, k=2, max_iter=3)
    m2 = SCFGP(sparsity=2, nfeats=4, seed=0, mm_precision="high",
               device="cpu")
    m2.fit_ensemble(X, y, k=2, max_iter=3)
    assert seen == [("auto", None)] * 2 + [("high", None)] * 2
