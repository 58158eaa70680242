"""Stochastic-gradient Langevin dynamics (SGLD / pSGLD) over SCFGP
hyperparameters.

Port of ``scfgp_tpu/bayes/sgld.py:50-191``.  Each step moves the C chains
by an N-scaled minibatch gradient plus Gaussian noise,

    θ' = θ + (eps/2) G grad_est(θ) + sqrt(eps G) ξ,

with the RMSProp metric ``G = 1 / (lambda + sqrt(v))`` shared by the chains
(pSGLD, Li et al. 2016) or ``G = 1``.  The minibatch estimator is the
scaled-batch approximation of the reference's ``nbatches > 1`` training
(``reference: SCFGP/SCFGP.py:226-235``): the SCFGP cost does not decompose
over rows, so it is not an unbiased estimate of the full gradient.
``batch_size == 0`` is the full gradient (ULA), through the streaming
objective with ``streaming_block > 0`` for N whose Φ would not fit.

Random inputs each step, in this order: the row indices (B,), drawn with
replacement and shared by all chains (only with a minibatch), and the
noise (C, P).  A non-finite gradient is masked out of the shared ``v``; a
non-finite proposal is rejected in place and counted.  Thinning keeps one
draw in ``thin`` on the device.

Chains sharded over ranks (``axis_name``, as ``hmc.hmc_sample``): the
shared metric's squared finite gradients and finite-chain flags are
gathered from every rank and reduced as unsharded, and ``nonfinite`` is
summed over the ranks; the rows are the same draw on every rank and the
noise each rank's slice of the unsharded draw (``hmc.ChainSlice``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.collectives import all_reduce_sum
from ..utils.profiling import span
from .hmc import all_chains, as_draws
from .predictive import batched_value_and_grad, make_logposterior


class SGLDResult(NamedTuple):
    samples: torch.Tensor       # (num_samples, chains, P) thinned draws
    # (num_samples, chains) estimator values at the position each kept
    # draw was stepped from (minibatch-noisy in batch mode).
    logdensities: torch.Tensor
    step_size: torch.Tensor     # () after decay
    precond: torch.Tensor       # (P,) final preconditioner diagonal G
    nonfinite: torch.Tensor = None  # () non-finite proposals rejected
    # (q, v, t, bad): continues the chain; sharded, this rank's q and bad
    final_carry: tuple = None


def make_minibatch_value_and_grad(X, y, D, S, M, batch_size: int,
                                  basis_fn=None,
                                  streaming_block: int = 0, mm_dtype=None,
                                  mm_precision=None) -> Callable:
    """``(q, rows) -> (vals (C,), grads (C, P))`` over (C, P) positions.

    With ``0 < batch_size < N`` the estimator has attributes ``n`` and
    ``batch_size``: the sampler then draws ``rows`` (B,), with replacement,
    and the value is the N-scaled log posterior of those rows.  Otherwise
    ``rows`` is None and the value is the full log posterior (ULA), in
    blocks of ``streaming_block`` rows when it is positive
    (``scfgp_tpu/bayes/sgld.py:69-103``).  ``mm_dtype`` and
    ``mm_precision``: the log posterior's GEMM arithmetic, as in
    ``make_logposterior``."""
    n = X.shape[0]
    prec = dict(mm_dtype=mm_dtype, mm_precision=mm_precision)
    if batch_size and batch_size < n:
        def value_and_grad(q, rows):
            lp = make_logposterior(X[rows], y[rows], D, S, M,
                                   basis_fn=basis_fn, n_scale=n, **prec)
            return batched_value_and_grad(lp)(q)

        value_and_grad.n, value_and_grad.batch_size = n, int(batch_size)
        return value_and_grad
    vg = batched_value_and_grad(make_logposterior(
        X, y, D, S, M, basis_fn=basis_fn, streaming_block=streaming_block,
        **prec))
    return lambda q, rows: vg(q)


def sgld_sample(value_and_grad_fn: Callable, init_positions: torch.Tensor,
                rng, num_warmup: int = 500, num_samples: int = 500,
                step_size: float = 1e-6, step_decay: float = 0.0,
                thin: int = 1, preconditioner: str = "rmsprop",
                precond_alpha: float = 0.99, precond_lambda: float = 1e-5,
                init_carry: tuple = None, axis_name=None) -> SGLDResult:
    """Run C chains of (p)SGLD for ``num_warmup + num_samples * thin``
    steps, keeping every ``thin``-th after warmup.  ``value_and_grad_fn``
    as ``make_minibatch_value_and_grad``'s.  The step size decays as
    ``eps0 (1 + t)^-step_decay``.  ``init_carry``: a previous result's
    ``final_carry`` (with ``num_warmup=0``) continues its chain.
    ``axis_name``: the chains sharded over its ranks, as in
    ``hmc.hmc_sample`` (module docstring)."""
    if preconditioner not in ("rmsprop", "none"):
        raise ValueError("preconditioner must be 'rmsprop' or 'none'")
    C, P = init_positions.shape
    dtype, device = init_positions.dtype, init_positions.device
    draws = as_draws(rng, init_positions, axis_name)
    use_pre = preconditioner == "rmsprop"
    alpha, lam = precond_alpha, precond_lambda
    batch = getattr(value_and_grad_fn, "batch_size", 0)

    def precond_of(v):
        if not use_pre:
            return torch.ones((P,), dtype=dtype, device=device)
        return 1.0 / (lam + torch.sqrt(v))

    def step(carry):
        q, v, t, bad = carry
        rows = (draws.randint(value_and_grad_fn.n, (batch,)) if batch
                else None)
        with span("scfgp.sgld.gradient"):
            vals, grads = value_and_grad_fn(q, rows)
        with span("scfgp.sgld.update"):
            if use_pre:
                # One metric for all chains, from the chains whose gradient
                # is finite: a diverging chain must not poison it for the
                # rest.
                g_ok = torch.all(torch.isfinite(grads), dim=1)
                g2 = torch.where(g_ok[:, None], grads * grads,
                                 torch.zeros_like(grads))
                g2, ok = all_chains(g2, axis_name), all_chains(
                    g_ok.to(dtype), axis_name)
                n_ok = torch.sum(ok)
                v_upd = alpha * v + (1.0 - alpha) * (
                    torch.sum(g2, dim=0) / torch.clamp(n_ok, min=1.0))
                v = torch.where(n_ok > 0, v_upd, v)
            g = precond_of(v)[None, :]
            eps = step_size * (1.0 + t) ** (-step_decay)
            noise = draws.normal(q.shape)
            q_new = q + 0.5 * eps * g * grads + torch.sqrt(eps * g) * noise
            ok = torch.all(torch.isfinite(q_new), dim=1)
            q = torch.where(ok[:, None], q_new, q)
        return (q, v, t + 1.0, bad + torch.sum(~ok)), vals, eps

    if init_carry is not None:
        carry = init_carry
    else:
        carry = (init_positions, torch.zeros((P,), dtype=dtype, device=device),
                 torch.zeros((), dtype=dtype, device=device),
                 torch.zeros((), dtype=torch.int64, device=device))
    for _ in range(num_warmup):
        carry, _, _ = step(carry)
    samples = init_positions.new_empty((num_samples, C, P))
    lds = init_positions.new_empty((num_samples, C))
    eps = torch.as_tensor(step_size, dtype=dtype, device=device)
    for i in range(num_samples):
        for _ in range(thin):
            carry, vals, eps = step(carry)
        samples[i], lds[i] = carry[0], vals
    nonfinite = carry[3]
    if axis_name is not None:
        (nonfinite,) = all_reduce_sum([nonfinite], axis_name)
    return SGLDResult(samples=samples, logdensities=lds, step_size=eps,
                      precond=precond_of(carry[1]), nonfinite=nonfinite,
                      final_carry=carry)
