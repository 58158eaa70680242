"""scfgp_tpu_torch — the SCFGP model in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``scfgp_tpu``, which stays beside it as the
reference the port is held against.  This package imports neither JAX nor
``scfgp_tpu``.  It covers training (the objective's gradient, the optimizer
zoo, the host and fused early-stopping loops: ``fit``/``fit_fast``) and
serving (load a trained model, condition its posterior on data, answer
predict requests, fold in new observations, recalibrate the dispersion),
the streaming objective for large N (``ops/streaming.py``), and the
Bayes layer (``bayes/``: chain-parallel HMC, static NUTS, tempering, VI
and SGLD over the hyperparameter posterior, ``SCFGP.fit_bayes``).  The trig
feature map and its gradient (``csrc/phi_fwd.cu``, ``csrc/phi_bwd.cu``),
the Phi-free sufficient statistics and their gradient
(``csrc/gram_fwd.cu``, ``csrc/gram_bwd.cu``) and the blocked Cholesky
factor with its inverse (``csrc/cholesky.cu``, ``ops/cholesky.py``) run as
hand-written CUDA kernels on the card and as plain PyTorch on the CPU.

Around the model: the command line (``python -m scfgp_tpu_torch``,
``run.py`` over ``config.py``), the serving export (``utils/serving.py``:
a ``torch.export`` program whose feature map is the registered operator
``scfgp_tpu_torch::phi_fwd``), the exact-GP baseline (``baselines/``), the
native Box-Cox fitter and table parser (``data/native.py``), the literal
quadrature (``ops/quadrature.py``) and the ``Visualizer``, which imports
matplotlib only when one is made: the card's host has none.
"""

from .models.params import (SCFGPParams, init_params, pack_params,
                            unpack_params, num_params, params_from_numpy,
                            posterior_from_numpy)
from .models.objective import (SufficientStats, Posterior, fourier_features,
                               sufficient_stats, solve_posterior, loss_fn,
                               loss_and_grad, predict_f)
from .data.scaler import Scaler
from .models.model import SCFGP, fit_fast_batch
from .utils.visualizer import Visualizer
from .bayes import (hmc_sample, nuts_sample_static, fit_vi, vi_sample,
                    make_logposterior, predictive_mixture)

__version__ = "0.1.0"

__all__ = [
    "SCFGP", "fit_fast_batch", "Scaler", "Visualizer",
    "SCFGPParams", "init_params", "pack_params", "unpack_params", "num_params",
    "params_from_numpy", "posterior_from_numpy",
    "SufficientStats", "Posterior", "fourier_features", "sufficient_stats",
    "solve_posterior", "loss_fn", "loss_and_grad", "predict_f",
]
