"""The fused training loop: the whole early-stopping ``optimize()`` kept on
the device.

Port of ``scfgp_tpu/opt/fused_loop.py:50-157``.  The JAX package compiles
the loop into one ``lax.while_loop``; here it is a Python loop over device
tensors with the same body, so every quantity the loop carries (params,
optimizer state, best objective, best params, convergence counter,
histories) stays on the device, and the host reads one flag an iteration,
only once the stop rule can fire.  Semantics are the reference's
(``reference: SCFGP/SCFGP.py:225-265``):

  * improvement bookkeeping and convergence counter: ``SCFGP.py:248-258``,
  * stop when ``iter > 30 and cvrg_iter > max_cvrg``: ``SCFGP.py:259-260``,
  * stall annealing ``params <- (1-r) params + r argmin`` with
    ``r = U(0,1) * cvrg_iter / max_cvrg * 0.5``: ``SCFGP.py:261-263``, the
    uniform drawn every iteration from an explicit ``torch.Generator``,
  * final restore of the best params + posterior refresh: ``SCFGP.py:264-265``.

``FusedLoopState`` carries the loop, the generator's state included (as
``key``), so a run split at ``upto`` boundaries replays the one-shot run
bitwise.  The JAX package's threefry keys cannot be replayed by a torch
generator: a state with such a key is refused.

``fused_optimize_batch`` runs B independent trials of one shape in one
loop (the JAX package's ``jax.vmap`` over the ``while_loop``), each step one
loss and gradient over a leading trial axis; it has no resume state.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .optimizers import Transform, tree_add, tree_leaves, tree_map


class FusedLoopState(NamedTuple):
    """Resumable carry of the fused loop: everything the loop body reads.
    Same name and fields as ``scfgp_tpu/opt/fused_loop.py:32``, so a
    checkpoint's ``fused_train_state`` decodes into either package."""

    params: Any
    opt_state: Any
    it: Any           # () int32 next iteration index
    min_obj: Any      # ()
    argmin: Any       # best params so far
    cvrg_iter: Any    # () int32 convergence counter
    key: Any          # uint8 state of the annealing torch.Generator
    cost_hist: Any    # (max_iter,) nan-padded
    obj_hist: Any     # (max_iter,)


class FusedFitResult(NamedTuple):
    params: Any           # best params (restored argmin)
    post: Any             # posterior at best params
    cost_history: Any     # (max_iter,) padded with nan after stop
    obj_history: Any      # (max_iter,) objective series
    num_iters: int
    min_obj: Any          # ()
    state: FusedLoopState  # final carry (checkpoint/resume handle)
    done: bool            # converged or hit max_iter


def set_generator_state(generator: torch.Generator, key) -> None:
    """Restore an annealing generator from a ``FusedLoopState.key``.

    Raises ``ValueError`` for a key this generator cannot take: the JAX
    package's uint32 threefry key, or one saved from a generator of another
    device."""
    dtype = (key.dtype if isinstance(key, torch.Tensor)
             else np.asarray(key).dtype)
    if dtype not in (torch.uint8, np.uint8):
        raise ValueError(
            f"fused train state key is {dtype}, not a torch.Generator "
            "state: it was written by the JAX package, whose threefry key a "
            "torch generator cannot replay; restart the fit instead of "
            "resuming it")
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key))
    key = key.cpu()
    if key.numel() != generator.get_state().numel():
        raise ValueError(
            f"fused train state key holds {key.numel()} bytes, but a "
            f"{generator.device} generator's state has "
            f"{generator.get_state().numel()}: it was saved on another "
            "device; resume on the device that saved it")
    generator.set_state(key.clone())


def _carry_dtype(params):
    """The device of the params and the dtype of the loop's objective
    carries: the params' promoted dtype."""
    leaves = tree_leaves(params)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    return leaves[0].device, dtype


def _defaults(value_and_grad_fn, obj_fn, eval_fn):
    """The objective (the cost) and the final gradient-free pass (the loss
    of ``value_and_grad_fn``) where the caller gives none."""
    if obj_fn is None:
        def obj_fn(p, post, cost):
            return cost
    if eval_fn is None:
        def eval_fn(p):
            (c, post), _ = value_and_grad_fn(p)
            return c, post
    return obj_fn, eval_fn


def _step(value_and_grad_fn, tx, obj_fn, params, opt_state, min_obj,
          argmin, cvrg_iter, draw, cvrg_tol, max_cvrg, per_leaf):
    """One iteration of the loop body (``SCFGP.py:225-263``): loss and
    gradient, the optimizer's step, the improvement bookkeeping and the
    stall annealing toward the best params.  ``draw(dtype)`` gives the
    annealing uniform; ``per_leaf(t, leaf)`` shapes a per-fit value ``t``
    to broadcast over ``leaf`` (the identity for one fit).  Returns the
    new carry and ``(cost, obj_val)``."""
    (cost, post), grads = value_and_grad_fn(params)
    delta, opt_state = tx.update(grads, opt_state, params)
    params = tree_add(params, delta)

    obj_val = obj_fn(params, post, cost)
    improved = obj_val < min_obj
    small = (min_obj - obj_val) < cvrg_tol
    cvrg_iter = torch.where(improved,
                            torch.where(small, cvrg_iter + 1, 0),
                            cvrg_iter + 1)
    min_obj = torch.where(improved, obj_val, min_obj)
    argmin = tree_map(
        lambda new, old: torch.where(per_leaf(improved, new), new, old),
        params, argmin)

    # Stall annealing toward the best-known params (SCFGP.py:261-263).
    u = draw(obj_val.dtype)
    randp = u * cvrg_iter.to(obj_val.dtype) / max_cvrg * 0.5
    anneal = cvrg_iter > (max_cvrg * 0.5)
    params = tree_map(
        lambda p_, a_: torch.where(
            per_leaf(anneal, p_),
            (1.0 - per_leaf(randp, p_)) * p_ + per_leaf(randp, p_) * a_,
            p_).to(p_.dtype),
        params, argmin)
    return params, opt_state, min_obj, argmin, cvrg_iter, cost, obj_val


def fused_optimize(value_and_grad_fn: Callable, tx: Transform, params,
                   generator: torch.Generator, max_iter: int = 500,
                   cvrg_tol: float = 1e-4, max_cvrg: int = 18,
                   obj_fn: Optional[Callable] = None,
                   eval_fn: Optional[Callable] = None,
                   state: Optional[FusedLoopState] = None,
                   upto: Optional[int] = None) -> FusedFitResult:
    """Run the early-stopping loop on the device of ``params``.

    ``value_and_grad_fn(params) -> ((cost, post), grads)``;
    ``obj_fn(params, post, cost) -> scalar`` objective (default: cost);
    ``eval_fn(params) -> (cost, post)`` gradient-free pass for the final
    posterior refresh (reference train_func, ``SCFGP.py:265``).
    ``generator`` draws the annealing uniforms; with ``state`` it is reset
    from ``state.key``.

    ``state``/``upto`` segment the loop for checkpointing: pass the
    ``state`` of a previous result to continue its trajectory, and ``upto``
    to pause before that iteration.  The body is deterministic given the
    carry, so a run chopped into segments is bitwise equal to the one-shot
    run.
    """
    obj_fn, eval_fn = _defaults(value_and_grad_fn, obj_fn, eval_fn)
    dev, dtype = _carry_dtype(params)
    if state is None:
        opt_state = tx.init(params)
        it = 0
        min_obj = torch.full((), float("inf"), dtype=dtype, device=dev)
        argmin = params
        cvrg_iter = torch.zeros((), dtype=torch.int32, device=dev)
        cost_hist = torch.full((max_iter,), float("nan"), dtype=dtype,
                               device=dev)
        obj_hist = cost_hist.clone()
    else:
        params, opt_state, argmin = state.params, state.opt_state, state.argmin
        it = int(state.it)
        min_obj, cvrg_iter = state.min_obj, state.cvrg_iter
        cost_hist, obj_hist = state.cost_hist.clone(), state.obj_hist.clone()
        set_generator_state(generator, state.key)

    def stop_now():
        return it > 30 and bool(cvrg_iter > max_cvrg)

    def draw(dtype):
        return torch.rand((), generator=generator, dtype=dtype, device=dev)

    end = max_iter if upto is None else min(max_iter, upto)
    while it < end and not stop_now():
        (params, opt_state, min_obj, argmin, cvrg_iter, cost,
         obj_val) = _step(value_and_grad_fn, tx, obj_fn, params, opt_state,
                          min_obj, argmin, cvrg_iter, draw, cvrg_tol,
                          max_cvrg, lambda t, leaf: t)
        cost_hist[it] = cost
        obj_hist[it] = obj_val
        it += 1

    _, post = eval_fn(argmin)
    final = FusedLoopState(
        params=params, opt_state=opt_state,
        it=torch.full((), it, dtype=torch.int32, device=dev),
        min_obj=min_obj, argmin=argmin, cvrg_iter=cvrg_iter,
        key=generator.get_state(), cost_hist=cost_hist, obj_hist=obj_hist)
    return FusedFitResult(params=argmin, post=post, cost_history=cost_hist,
                          obj_history=obj_hist, num_iters=it,
                          min_obj=min_obj, state=final,
                          done=it >= max_iter or stop_now())


class BatchFitResult(NamedTuple):
    params: Any          # best params of each trial, leaves (B, ...)
    post: Any            # posterior of each trial at its best params
    cost_history: Any    # (B, max_iter), nan after a trial stopped
    obj_history: Any     # (B, max_iter)
    num_iters: list      # each trial's iterations
    min_obj: Any         # (B,)


def fused_optimize_batch(value_and_grad_fn: Callable, tx: Transform, params,
                         generators, max_iter: int = 500,
                         cvrg_tol: float = 1e-4, max_cvrg: int = 18,
                         obj_fn: Optional[Callable] = None,
                         eval_fn: Optional[Callable] = None
                         ) -> BatchFitResult:
    """``fused_optimize`` for B independent trials at once: the loop the
    JAX package gets from ``jax.vmap`` over its ``while_loop``
    (``scfgp_tpu/models/model.py:160-177``).

    Every leaf of ``params`` carries a leading trial axis B;
    ``value_and_grad_fn`` and ``obj_fn`` take and return the batched
    values (cost and objective (B,)), and ``generators`` holds each
    trial's annealing ``torch.Generator``.  One iteration steps all trials
    with one loss and gradient, so each kernel of the step launches once
    whatever B.  Trial b stops by its own rule (``it > 30`` and its
    ``cvrg_iter > max_cvrg``); from then on its carry (params, optimizer
    state, best objective and params, counter, histories) is frozen by
    ``torch.where``, as the vmapped ``while_loop`` masks a finished trial.
    Its uniform is drawn from its own generator only while it is active,
    so each trial draws what ``fused_optimize`` draws for it alone, and the
    batch replays B sequential fits up to the rounding of batched products.
    The loop ends when no trial is active; the host reads the active mask
    once an iteration, and only once ``it > 30``, when a trial can stop.

    A leaf of the optimizer state without a trial axis (adam's and adamax's
    step count ``t``) is shared: every active trial has taken every step,
    and a finished trial's state is frozen, so its value is each active
    trial's own."""
    obj_fn, eval_fn = _defaults(value_and_grad_fn, obj_fn, eval_fn)
    dev, dtype = _carry_dtype(params)
    B = tree_leaves(params)[0].shape[0]
    opt_state = tx.init(params)
    min_obj = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    argmin = params
    cvrg_iter = torch.zeros((B,), dtype=torch.int32, device=dev)
    cost_hist = torch.full((B, max_iter), float("nan"), dtype=dtype,
                           device=dev)
    obj_hist = cost_hist.clone()
    num_iters = [0] * B
    active = list(range(B))  # host copy of the active mask, as indices
    live = torch.ones((B,), dtype=torch.bool, device=dev)

    def by_trial(mask, t):
        return mask.reshape((B,) + (1,) * (t.dim() - 1))

    def freeze(new, old):
        if new.dim() == 0:  # shared step count
            return new
        return torch.where(by_trial(live, new), new, old)

    def draw(dtype):
        # Each trial from its own generator, drawn only while it is active.
        on, zero = set(active), torch.zeros((), dtype=dtype, device=dev)
        return torch.stack([
            torch.rand((), generator=generators[b], dtype=dtype, device=dev)
            if b in on else zero for b in range(B)])

    it = 0
    while it < max_iter:
        if it > 30:
            live = cvrg_iter <= max_cvrg
            active = torch.nonzero(live).flatten().tolist()  # one read
            if not active:
                break
        (new_params, new_opt, new_min, new_argmin, new_cvrg, cost,
         obj_val) = _step(value_and_grad_fn, tx, obj_fn, params, opt_state,
                          min_obj, argmin, cvrg_iter, draw, cvrg_tol,
                          max_cvrg, by_trial)
        if len(active) == B:  # nothing to freeze
            params, opt_state, argmin = new_params, new_opt, new_argmin
            min_obj, cvrg_iter = new_min, new_cvrg
            cost_hist[:, it] = cost
            obj_hist[:, it] = obj_val
        else:
            params = tree_map(freeze, new_params, params)
            opt_state = tree_map(freeze, new_opt, opt_state)
            argmin = tree_map(freeze, new_argmin, argmin)
            min_obj = freeze(new_min, min_obj)
            cvrg_iter = freeze(new_cvrg, cvrg_iter)
            cost_hist[:, it] = torch.where(live, cost, cost_hist[:, it])
            obj_hist[:, it] = torch.where(live, obj_val, obj_hist[:, it])
        for b in active:
            num_iters[b] += 1
        it += 1

    _, post = eval_fn(argmin)
    return BatchFitResult(params=argmin, post=post, cost_history=cost_hist,
                          obj_history=obj_hist, num_iters=num_iters,
                          min_obj=min_obj)
