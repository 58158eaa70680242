"""scfgp_tpu_torch — the SCFGP model in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``scfgp_tpu``, which stays beside it as the
reference the port is held against.  This package imports neither JAX nor
``scfgp_tpu``.  It covers training (the objective's gradient, the optimizer
zoo, the host and fused early-stopping loops: ``fit``/``fit_fast``) and
serving (load a trained model, condition its posterior on data, answer
predict requests, fold in new observations, recalibrate the dispersion).
The trig feature map and its gradient run as the hand-written CUDA kernels
``csrc/phi_fwd.cu`` and ``csrc/phi_bwd.cu`` on the card and as plain
PyTorch on the CPU.
"""

from .models.params import (SCFGPParams, init_params, pack_params,
                            unpack_params, num_params, params_from_numpy,
                            posterior_from_numpy)
from .models.objective import (SufficientStats, Posterior, fourier_features,
                               sufficient_stats, solve_posterior, loss_fn,
                               loss_and_grad, predict_f)
from .data.scaler import Scaler
from .models.model import SCFGP, fit_fast_batch

__version__ = "0.1.0"

__all__ = [
    "SCFGP", "fit_fast_batch", "Scaler",
    "SCFGPParams", "init_params", "pack_params", "unpack_params", "num_params",
    "params_from_numpy", "posterior_from_numpy",
    "SufficientStats", "Posterior", "fourier_features", "sufficient_stats",
    "solve_posterior", "loss_fn", "loss_and_grad", "predict_f",
]
