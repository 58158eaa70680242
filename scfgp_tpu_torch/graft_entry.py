"""Compile-check entry point of the port: the forward objective.

Mirrors ``entry()`` of the root ``__graft_entry__.py:6-27`` (which imports
the JAX package and stays as it is): the full NLML objective (feature
map, Gram, Cholesky posterior, expected NLL) on a kin8nm-sized config,
N=1024, D=8, S=50, M=200, on the card unless ``device`` says otherwise.
"""

import numpy as np
import torch


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(params, X, y)`` returns the cost and the
    posterior's ``alpha``; on the card its feature map is K1f."""
    from .models.objective import loss_fn
    from .models.params import init_params

    N, D, S, M = 1024, 8, 50, 200
    rng = np.random.RandomState(0)
    X = torch.as_tensor(rng.rand(N, D), dtype=torch.float32, device=device)
    y = torch.as_tensor(rng.randn(N), dtype=torch.float32, device=device)
    p0 = init_params(torch.Generator().manual_seed(0), D, S, M)
    params = type(p0)(*(t.to(device) for t in p0))

    @torch.inference_mode()
    def fn(params, X, y):
        cost, aux = loss_fn(params, X, y)
        return cost, aux.post.alpha

    return fn, (params, X, y)
