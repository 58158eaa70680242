from .phi import (FourierFeatures, fourier_features_bwd_cuda,
                  fourier_features_cuda, fourier_features_ref, phi_bwd_ref)
from .cholesky import (CholeskyFn, CholeskyInverseFn, cholesky_cuda,
                       cholesky_inverse_cuda, cholesky_inverse_kernel,
                       cholesky_inverse_ref, cholesky_kernel, cholesky_ref,
                       tri_inverse_blocked)
from .gram import (SufficientStatsFn, gram_bwd_ref, sufficient_stats_bwd_cuda,
                   sufficient_stats_cuda, sufficient_stats_kernel,
                   sufficient_stats_ref)

_STREAMING = ("loss_fn_streaming", "loss_and_grad_streaming")


def __getattr__(name):
    # ops/streaming.py builds on models/objective.py, which imports this
    # package: its names load at first use, not here.
    if name in _STREAMING:
        from . import streaming
        return getattr(streaming, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
