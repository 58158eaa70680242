"""Chain-parallel Hamiltonian Monte Carlo over SCFGP hyperparameters.

Port of ``scfgp_tpu/bayes/hmc.py:37-370``.  The target is the flat
hyperparameter vector, so one (C, P) position tensor drives everything:
each gradient is one batched log posterior over the C chains
(``bayes/predictive.py``), on the card one K1f and one K1b launch whatever
C.  The step size is adapted by dual averaging and a diagonal mass by
Welford accumulation, either shared by all chains (from their mean
acceptance and all their draws) or per chain (``shared_adaptation=False``,
the fleet mode).

The JAX package fuses the sampler into one ``lax.scan``; here it is a
Python loop over transitions whose state stays on the device: nothing is
read back to the host until the sampler returns, so a chain that diverges
(a non-finite log density: an indefinite Gram gives NaN, never an error)
is rejected by ``torch.where`` while the others go on.

Random inputs are arguments of each transition and come from a ``Draws``
source (a ``torch.Generator`` on the chains' device): the standard-normal
momentum (C, P) and the uniforms (C,) of the accept test, in that order
each step.  The two packages' generators differ, so a test passes JAX's
draws in through a source of its own and gets JAX's chains.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .predictive import batched_value_and_grad

# A transition is divergent when the energy error exceeds this (Stan's
# convention) or is non-finite.
MAX_DELTA_ENERGY = 1000.0


class Draws:
    """The samplers' random inputs, drawn from ``generator`` in ``dtype``
    on ``device``.  A replacement needs the same four methods."""

    def __init__(self, generator: torch.Generator, dtype, device):
        self.g, self.dtype, self.device = generator, dtype, device

    def normal(self, shape):
        return torch.randn(shape, generator=self.g, dtype=self.dtype,
                           device=self.device)

    def uniform(self, shape):
        return torch.rand(shape, generator=self.g, dtype=self.dtype,
                          device=self.device)

    def bernoulli(self, shape):
        return self.uniform(shape) < 0.5

    def randint(self, high: int, shape):
        return torch.randint(0, high, shape, generator=self.g,
                             device=self.device)


def as_draws(rng, like: torch.Tensor):
    """``rng`` as a draw source for tensors like ``like``: a
    ``torch.Generator``, an int seed (a generator on ``like``'s device), or
    a source with ``Draws``'s methods, returned as it is."""
    if isinstance(rng, int):
        rng = torch.Generator(device=like.device).manual_seed(rng)
    if isinstance(rng, torch.Generator):
        return Draws(rng, like.dtype, like.device)
    return rng


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging for log step size (Hoffman & Gelman 2014);
    each leaf () shared, or (C,) per chain."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(eps0: float, dtype=torch.float32, device="cpu",
            shape=()) -> DualAveragingState:
    log_eps0 = torch.log(torch.full(shape, eps0, dtype=dtype, device=device))
    zero = torch.zeros(shape, dtype=dtype, device=device)
    return DualAveragingState(log_eps=log_eps0, log_eps_avg=log_eps0,
                              h_avg=zero, t=zero,
                              mu=math.log(10.0) + log_eps0)


def da_update(state: DualAveragingState, accept_prob: torch.Tensor,
              target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    """Elementwise: one update of every state of a batch."""
    t = state.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * state.h_avg + (
        target - accept_prob) / (t + t0)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, t, state.mu)


class WelfordState(NamedTuple):
    """Running mean and squared deviations: count (), mean and m2 (P,); or
    with a leading batch axis, count (C,), mean and m2 (C, P)."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim: int, dtype=torch.float32, device="cpu",
                 shape=()) -> WelfordState:
    return WelfordState(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros((*shape, dim), dtype=dtype, device=device),
                        torch.zeros((*shape, dim), dtype=dtype, device=device))


def welford_add_batch(state: WelfordState, xs: torch.Tensor) -> WelfordState:
    """Add a batch of draws xs (n, P) to one state, or xs (..., n, P) to a
    batch of states: Chan et al.'s parallel merge."""
    nb = float(xs.shape[-2])
    mb = torch.mean(xs, dim=-2)
    m2b = torch.sum((xs - mb.unsqueeze(-2)) ** 2, dim=-2)
    count = state.count.unsqueeze(-1)
    n = count + nb
    delta = mb - state.mean
    mean = state.mean + delta * nb / n
    m2 = state.m2 + m2b + delta * delta * count * nb / n
    return WelfordState(n.squeeze(-1), mean, m2)


def welford_variance(state: WelfordState, reg: float = 1e-3) -> torch.Tensor:
    count = state.count.unsqueeze(-1)
    var = state.m2 / torch.clamp(count - 1.0, min=1.0)
    # Stan-style shrinkage toward unit scale for small sample counts.
    w = count / (count + 5.0)
    return w * var + (1.0 - w) * reg


def _per_chain(eps, inv_mass):
    """``eps`` () or (C,) and ``inv_mass`` (P,) or (C, P) shaped to
    broadcast over (C, P); a Python float stays one (a tensor of it would
    be float32)."""
    im = inv_mass if inv_mass.dim() == 2 else inv_mass[None, :]
    if torch.is_tensor(eps) and eps.dim() == 1:
        eps = eps[:, None]
    return eps, im


def leapfrog(value_and_grad: Callable, position, momentum, eps, inv_mass,
             num_steps: int, init_ld_grad=None):
    """Leapfrog integrator over (C, P) tensors with the gradient cached:
    the second half-kick's gradient is the next step's first, so a
    trajectory of L steps costs L + 1 gradients (one if ``init_ld_grad`` =
    (ld0, g0) is given: L).  ``num_steps=0`` is the identity.  Returns
    ``(q, p, ld_final)``."""
    if num_steps == 0:
        ld0 = (value_and_grad(position) if init_ld_grad is None
               else init_ld_grad)[0]
        return position, momentum, ld0
    g = (value_and_grad(position) if init_ld_grad is None
         else init_ld_grad)[1]
    e, im = _per_chain(eps, inv_mass)
    q, p = position, momentum
    for _ in range(num_steps):
        p = p + 0.5 * e * g
        q = q + e * im * p
        ld, g = value_and_grad(q)
        p = p + 0.5 * e * g
    return q, p, ld


def _kinetic(p, im):
    return 0.5 * torch.sum(p * p * im, dim=-1)


def metropolis(q, q1, ld0, ld1, h0, h1, u):
    """The accept test of a trajectory: ``(q', ld', accept prob, divergent)``
    per chain; a non-finite energy error is a divergence, never accepted."""
    delta = h1 - h0
    div = ~torch.isfinite(delta) | (delta > MAX_DELTA_ENERGY)
    log_accept = torch.minimum(torch.zeros_like(delta), -delta)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                             torch.full_like(log_accept, -math.inf))
    accept = torch.log(u) < log_accept
    q_next = torch.where(accept.unsqueeze(-1), q1, q)
    ld_next = torch.where(accept, ld1, ld0)
    return q_next, ld_next, torch.exp(log_accept), div


def make_hmc_transition(value_and_grad: Callable,
                        num_integration_steps: int):
    """One HMC transition ``(q, eps, inv_mass, z, u) -> (q', ld, accept
    probs, divergent)`` over (C, P) positions, from the standard-normal
    momentum draw ``z`` (C, P) and the uniforms ``u`` (C,)."""

    def transition(q, eps, inv_mass, z, u):
        _, im = _per_chain(eps, inv_mass)
        mass_sqrt = 1.0 / torch.sqrt(im)
        p0 = z * mass_sqrt
        ld0, g0 = value_and_grad(q)
        h0 = -ld0 + _kinetic(p0, im)
        q1, p1, ld1 = leapfrog(value_and_grad, q, p0, eps, inv_mass,
                               num_integration_steps, init_ld_grad=(ld0, g0))
        h1 = -ld1 + _kinetic(p1, im)
        return metropolis(q, q1, ld0, ld1, h0, h1, u)

    return transition


class HMCResult(NamedTuple):
    samples: torch.Tensor       # (num_samples, chains, P)
    logdensities: torch.Tensor  # (num_samples, chains)
    accept_rate: torch.Tensor   # ()
    step_size: torch.Tensor     # () shared, (C,) per chain
    inv_mass: torch.Tensor      # (P,) shared, (C, P) per chain
    divergences: torch.Tensor = None   # () over the sampling phase
    final_positions: torch.Tensor = None  # (chains, P)
    # (DualAveragingState, WelfordState) after this call's warmup; None
    # when warmup was skipped (``adapted``).
    warmup_state: tuple = None


def adaptive_sample(transition: Callable, init_positions, num_warmup: int,
                    num_samples: int, init_step_size: float,
                    target_accept: float, adapted=None, warmup_state=None,
                    shared_adaptation: bool = True):
    """The warmup and sampling loops HMC and static NUTS share
    (``scfgp_tpu/bayes/hmc.py:311-370``, ``nuts.py:513-568``).

    ``transition(q, eps, inv_mass) -> (q, ld, accept probs, divergent)``
    draws its own random inputs.  Warmup adapts the step size by dual
    averaging and the diagonal inverse mass by Welford, one shared pair
    from the chains' mean acceptance and all their draws, or per chain.
    ``adapted=(step_size, inv_mass)`` skips warmup and samples from
    ``init_positions``; ``warmup_state=(da, wf)`` continues a warmup.
    Returns ``(samples, lds, accept_rate, divergences, q, eps, inv_mass,
    warmup_state)``."""
    C, P = init_positions.shape
    dtype, device = init_positions.dtype, init_positions.device
    q = init_positions
    out_warmup_state = None
    if adapted is not None:
        eps = torch.as_tensor(adapted[0], dtype=dtype, device=device)
        inv_mass = torch.as_tensor(adapted[1], dtype=dtype, device=device)
    else:
        if warmup_state is not None:
            da, wf = warmup_state
        else:
            shape = () if shared_adaptation else (C,)
            da = da_init(init_step_size, dtype, device, shape)
            wf = welford_init(P, dtype, device, shape)
            # Seed the mass estimate at unit variance until draws accumulate.
            wf = wf._replace(m2=wf.m2 + 1.0)
        for _ in range(num_warmup):
            q, _, acc, _ = transition(q, torch.exp(da.log_eps),
                                      welford_variance(wf))
            if shared_adaptation:
                da = da_update(da, torch.mean(acc), target=target_accept)
                wf = welford_add_batch(wf, q)
            else:
                da = da_update(da, acc, target=target_accept)
                wf = welford_add_batch(wf, q[:, None, :])
        out_warmup_state = (da, wf)
        eps = torch.exp(da.log_eps_avg)
        inv_mass = welford_variance(wf)
    samples = q.new_empty((num_samples, C, P))
    lds = q.new_empty((num_samples, C))
    accs = q.new_empty((num_samples,))
    divs = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(num_samples):
        q, ld, acc, div = transition(q, eps, inv_mass)
        samples[i], lds[i], accs[i] = q, ld, torch.mean(acc)
        divs = divs + div.sum()
    return (samples, lds, torch.mean(accs), divs, q, eps, inv_mass,
            out_warmup_state)


def hmc_sample(logdensity_fn: Callable, init_positions: torch.Tensor, rng,
               num_warmup: int = 500, num_samples: int = 500,
               num_integration_steps: int = 16, init_step_size: float = 0.01,
               target_accept: float = 0.8, adapted=None, warmup_state=None,
               shared_adaptation: bool = True) -> HMCResult:
    """Run C chains of HMC with warmup adaptation
    (``scfgp_tpu/bayes/hmc.py:250-370``).

    ``logdensity_fn``: (C, P) -> (C,), batched over chains and
    differentiable by autograd (``make_logposterior``'s).
    ``init_positions``: (C, P).  ``rng``: a ``torch.Generator`` (or seed,
    or ``Draws``-like source).  Each transition costs L + 1 batched
    gradients, L = ``num_integration_steps``.  ``shared_adaptation=False``
    adapts a step size (C,) and an inverse mass (C, P) per chain, the fleet
    mode for many random-init chains whose basins differ in curvature.
    ``adapted``/``warmup_state``: see ``adaptive_sample``."""
    draws = as_draws(rng, init_positions)
    step = make_hmc_transition(batched_value_and_grad(logdensity_fn),
                               num_integration_steps)
    C = init_positions.shape[0]

    def transition(q, eps, inv_mass):
        z = draws.normal(q.shape)
        return step(q, eps, inv_mass, z, draws.uniform((C,)))

    (samples, lds, acc, divs, q, eps, inv_mass, ws) = adaptive_sample(
        transition, init_positions, num_warmup, num_samples, init_step_size,
        target_accept, adapted, warmup_state, shared_adaptation)
    return HMCResult(samples=samples, logdensities=lds, accept_rate=acc,
                     step_size=eps, inv_mass=inv_mass, divergences=divs,
                     final_positions=q, warmup_state=ws)


def hmc_sample_host_looped(logdensity_fn: Callable,
                           init_positions: torch.Tensor, rng,
                           num_warmup: int = 500, num_samples: int = 500,
                           num_integration_steps: int = 16,
                           init_step_size: float = 0.01,
                           target_accept: float = 0.8) -> HMCResult:
    """``scfgp_tpu/bayes/hmc.py:208-247``: HMC with the adaptation shared
    by the chains and run on the host.  The port's samplers run on the host
    already, so this is ``hmc_sample`` under JAX's signature."""
    return hmc_sample(logdensity_fn, init_positions, rng,
                      num_warmup=num_warmup, num_samples=num_samples,
                      num_integration_steps=num_integration_steps,
                      init_step_size=init_step_size,
                      target_accept=target_accept)
