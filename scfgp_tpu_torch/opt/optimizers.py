"""First-order optimizer zoo as pure functions of parameter trees.

Port of ``scfgp_tpu/opt/optimizers.py:32-222``, which re-implements the
reference's optimizer registry (``reference: SCFGP/Optimizer.py``) — sgd,
adagrad, rmsprop, adadelta, adam, adamax plus momentum / Nesterov-momentum
wrappers — with the reference's update formulas, not ``torch.optim``'s (the
epsilon placement differs):

    tx = adam(learning_rate=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8)
    state = tx.init(params)
    delta, state = tx.update(grads, state, params)
    params = tree_add(params, delta)

``update`` returns the *delta* added to params, so the wrappers compose as
Theano update-dict rewriting did (``Optimizer.py:27-97``); the reference
always wraps the base algorithm in Nesterov momentum 0.9
(``SCFGP.py:130-131``).  A tree is a tensor or a (Named)tuple, list or dict
of trees; the model's is ``SCFGPParams``.  Nothing is updated in place.

The state carriers keep the JAX package's names and fields, so a
checkpoint's resume state decodes into either package.  As there,
``AdamState.t`` and ``AdamaxState.t`` are float32 whatever the params'
dtype, so the step size ``a_t`` is computed in float32
(``optimizers.py:122, 126-127``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.profiling import span


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure: ``jax.tree.map`` for tensors and
    (Named)tuples, lists and dicts of them."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in order."""
    out = []
    tree_map(out.append, tree)
    return out


class Transform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (delta, state)


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def _step_counter(params):
    # One count, whatever the leaves' shapes: the trials of a batched fit
    # (leaves stacked on a trial axis) share it, since every active trial
    # has taken every step (opt/fused_loop.py::fused_optimize_batch).
    return torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def sgd(learning_rate=0.01, **_):
    """params := params - lr * g  (Optimizer.py:100-119)."""
    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: -learning_rate * g, grads), state

    return Transform(init, update)


def adagrad(learning_rate=0.01, epsilon=1e-6, **_):
    """accu += g^2; delta = -lr * g / sqrt(accu + eps)  (Optimizer.py:121-164)."""
    def init(params):
        return _zeros_like(params)

    def update(grads, accu, params):
        accu = tree_map(lambda s, g: s + g * g, accu, grads)
        delta = tree_map(
            lambda g, s: -learning_rate * g / torch.sqrt(s + epsilon),
            grads, accu)
        return delta, accu

    return Transform(init, update)


def rmsprop(learning_rate=0.01, rho=0.9, epsilon=1e-6, **_):
    """accu = rho*accu + (1-rho)*g^2  (Optimizer.py:166-213, NameError fixed)."""
    def init(params):
        return _zeros_like(params)

    def update(grads, accu, params):
        accu = tree_map(lambda s, g: rho * s + (1 - rho) * g * g, accu, grads)
        delta = tree_map(
            lambda g, s: -learning_rate * g / torch.sqrt(s + epsilon),
            grads, accu)
        return delta, accu

    return Transform(init, update)


class AdadeltaState(NamedTuple):
    accu: Any
    delta_accu: Any


def adadelta(learning_rate=0.01, rho=0.95, epsilon=1e-6, **_):
    """Zeiler's adadelta, reference scaling included (Optimizer.py:215-276)."""
    def init(params):
        return AdadeltaState(_zeros_like(params), _zeros_like(params))

    def update(grads, state, params):
        accu = tree_map(lambda s, g: rho * s + (1 - rho) * g * g,
                        state.accu, grads)
        upd = tree_map(
            lambda g, s, ds: g * torch.sqrt(ds + epsilon)
            / torch.sqrt(s + epsilon), grads, accu, state.delta_accu)
        delta = tree_map(lambda u: -learning_rate * u, upd)
        delta_accu = tree_map(lambda ds, u: rho * ds + (1 - rho) * u * u,
                              state.delta_accu, upd)
        return delta, AdadeltaState(accu, delta_accu)

    return Transform(init, update)


class AdamState(NamedTuple):
    t: Any  # () float32 step count
    m: Any
    v: Any


def adam(learning_rate=0.01, beta1=0.9, beta2=0.99, epsilon=1e-8, **_):
    """Adam with the reference's epsilon placement: a_t*m/(sqrt(v)+eps)
    where a_t = lr*sqrt(1-b2^t)/(1-b1^t)  (Optimizer.py:278-331).  The
    default beta2 is 0.99, as in the JAX package."""
    def init(params):
        return AdamState(_step_counter(params), _zeros_like(params),
                         _zeros_like(params))

    def update(grads, state, params):
        t = state.t + 1.0
        a_t = learning_rate * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        m = tree_map(lambda m_, g: beta1 * m_ + (1 - beta1) * g,
                     state.m, grads)
        v = tree_map(lambda v_, g: beta2 * v_ + (1 - beta2) * g * g,
                     state.v, grads)
        delta = tree_map(
            lambda m_, v_: -(a_t * m_ / (torch.sqrt(v_) + epsilon))
            .to(m_.dtype), m, v)
        return delta, AdamState(t, m, v)

    return Transform(init, update)


class AdamaxState(NamedTuple):
    t: Any  # () float32 step count
    m: Any
    u: Any


def adamax(learning_rate=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, **_):
    """Infinity-norm Adam variant (Optimizer.py:333-382)."""
    def init(params):
        return AdamaxState(_step_counter(params), _zeros_like(params),
                           _zeros_like(params))

    def update(grads, state, params):
        t = state.t + 1.0
        # A true division: torch computes ``scalar / tensor`` as a
        # reciprocal times the scalar, one rounding more than JAX.
        a_t = torch.full_like(t, learning_rate) / (1.0 - beta1 ** t)
        m = tree_map(lambda m_, g: beta1 * m_ + (1 - beta1) * g,
                     state.m, grads)
        u = tree_map(lambda u_, g: torch.maximum(beta2 * u_, torch.abs(g)),
                     state.u, grads)
        delta = tree_map(
            lambda m_, u_: -(a_t * m_ / (u_ + epsilon)).to(m_.dtype), m, u)
        return delta, AdamaxState(t, m, u)

    return Transform(init, update)


class MomentumState(NamedTuple):
    velocity: Any
    inner: Any


def apply_momentum(inner: Transform, momentum=0.9) -> Transform:
    """v := mom*v + delta; params += v  (Optimizer.py:27-60)."""
    def init(params):
        return MomentumState(_zeros_like(params), inner.init(params))

    def update(grads, state, params):
        delta, inner_state = inner.update(grads, state.inner, params)
        v = tree_map(lambda v_, d: momentum * v_ + d, state.velocity, delta)
        return v, MomentumState(v, inner_state)

    return Transform(init, update)


def apply_nesterov_momentum(inner: Transform, momentum=0.9) -> Transform:
    """v := mom*v + delta; params += mom*v + delta  (Optimizer.py:62-97)."""
    def init(params):
        return MomentumState(_zeros_like(params), inner.init(params))

    def update(grads, state, params):
        delta, inner_state = inner.update(grads, state.inner, params)
        v = tree_map(lambda v_, d: momentum * v_ + d, state.velocity, delta)
        out = tree_map(lambda v_, d: momentum * v_ + d, v, delta)
        return out, MomentumState(v, inner_state)

    return Transform(init, update)


# Registry (reference Optimizer.py:14-25 lists norm_constraint entries that
# were never implemented there; omitted, as in the JAX package).
algos = {
    "sgd": sgd,
    "adagrad": adagrad,
    "rmsprop": rmsprop,
    "adadelta": adadelta,
    "adam": adam,
    "adamax": adamax,
}


def make_optimizer(algo: str = "adam", algo_params: dict | None = None,
                   nesterov_momentum: float = 0.9) -> Transform:
    """Build the reference's full composition: <algo> + Nesterov 0.9
    (``SCFGP.py:130-131``).  Set ``nesterov_momentum=None`` to disable.
    Its ``update`` is the span ``scfgp.opt.update``
    (``utils/profiling.py``)."""
    if algo not in algos:
        raise ValueError(f"Unknown optimizer {algo!r}; options: {list(algos)}")
    tx = algos[algo](**(algo_params or {}))
    if nesterov_momentum is not None:
        tx = apply_nesterov_momentum(tx, momentum=nesterov_momentum)

    def update(grads, state, params):
        with span("scfgp.opt.update"):
            return tx.update(grads, state, params)

    return Transform(tx.init, update)
