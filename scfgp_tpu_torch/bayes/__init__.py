"""The Bayes layer: chain-parallel samplers over the SCFGP hyperparameter
posterior, the posterior-predictive mixture and convergence diagnostics.

Port of ``scfgp_tpu/bayes/``: every sampler evaluates the log posterior and
its gradient for all chains (and rungs, or Monte-Carlo samples) as one
batch over the trial axis of ``loss_fn``, so on the card one K1f and one
K1b launch serve a whole batched gradient.  Samplers take a
``torch.Generator`` (or a ``Draws``-like source) for their random inputs.
``streaming_block > 0`` takes the log posterior through the O(block)-memory
streaming objective with the chains as its trial axis.
``bayes/segmented.py`` is not ported: it existed only for a TPU worker's
limit on one execution.
"""

from .hmc import (hmc_sample, hmc_sample_host_looped, make_hmc_transition,
                  leapfrog, Draws, HMCResult)
from .nuts import (nuts_sample, nuts_sample_host_looped, nuts_sample_static,
                   NUTSResult)
from .vi import (fit_vi, vi_sample, vi_posterior_sample, VIResult,
                 VISamplerResult)
from .predictive import (make_logposterior, batched_value_and_grad,
                         predictive_mixture, reduced_dim)
from .tempering import (tempered_hmc_sample, geometric_ladder,
                        energy_matched_ladder, TemperedHMCResult)
from .diagnostics import (split_rhat, ess_bulk, ess_tail, ess_mean,
                          diagnose, Diagnostics)
from .sgld import sgld_sample, make_minibatch_value_and_grad, SGLDResult
