"""Entry points of the port: the forward objective, and a dry run of every
parallel mode.

Mirrors the root ``__graft_entry__.py`` (which imports the JAX package and
stays as it is): ``entry()`` (``:6-27``), the full NLML objective
(feature map, Gram, Cholesky posterior, expected NLL) on a kin8nm-sized
config, N=1024, D=8, S=50, M=200, and ``dryrun_multichip(n)``
(``:30-100``), on the card unless ``device`` says otherwise.
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


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One training step of every parallel mode on ``n_devices`` ranks at
    tiny shapes (``__graft_entry__.py:30-100``), through
    ``parallel/launch.py``: DP (both mode names: the same explicit
    all-reduce), DP x TP on a 2-D (data, feature) mesh, streaming + DP,
    the model-level ``fit_fast(mesh=...)`` and the trial-parallel
    ``fit_fast_batch(mesh=...)`` with B = n + 1 (trial padding).  Raises
    if a rank fails or a value is not finite.  The JAX version's
    chain-sharded HMC, NUTS and SGLD parts are not ported yet (ROADMAP.md
    Queue 1 item 8)."""
    from .parallel import launch
    launch.run(dryrun_rank, n_devices, n_devices, device, device=device)
    print(f"dryrun_multichip({n_devices}) ok: dp (gspmd, shard_map) + "
          f"dp x tp + streaming+dp + model-level fit_fast(mesh) + "
          f"trial-parallel fit_fast_batch(mesh, B={n_devices + 1})")


def dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank's part of ``dryrun_multichip``; returns its costs."""
    from .models.model import SCFGP, fit_fast_batch
    from .models.params import init_params
    from .ops.streaming import loss_and_grad_streaming
    from .opt.optimizers import make_optimizer
    from .parallel import (make_dp_train_step, make_mesh, make_mesh2d,
                           make_tp_train_step, shard_rows, shard_rows_2d)

    N, D, S, M = 8 * n_devices, 4, 3, 5  # S+M = 8: divisible feature axis
    rng = np.random.RandomState(0)
    X = rng.rand(N, D).astype(np.float32)
    y = rng.randn(N).astype(np.float32)
    p0 = init_params(torch.Generator().manual_seed(0), D, S, M)
    params = type(p0)(*(t.to(device) for t in p0))
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    mesh = make_mesh()
    Xs, ys, ws = shard_rows(mesh, X, y, device=device)
    costs = {}
    for mode in ("gspmd", "shard_map"):
        step = make_dp_train_step(tx, mesh, mode=mode)
        _, _, costs[mode], _ = step(params, tx.init(params), Xs, ys, ws)

    n_feat = 2 if n_devices % 2 == 0 else 1
    mesh2 = make_mesh2d(n_devices // n_feat, n_feat)
    X2, y2, w2 = shard_rows_2d(mesh2, X, y, device=device)
    _, _, costs["tp"] = make_tp_train_step(tx, mesh2)(
        params, tx.init(params), X2, y2, w2)

    (costs["streaming"], _), grads = loss_and_grad_streaming(
        params, Xs, ys, ws, block_size=max(1, N // n_devices // 2),
        axis_name=mesh.group("data"))
    if not all(torch.isfinite(g).all() for g in grads):
        raise FloatingPointError("non-finite streaming+dp gradient")

    m = SCFGP(sparsity=S, nfeats=M, seed=0, device=device)
    m.fit_fast(X, y, max_iter=5, mesh=mesh)
    costs["fit_fast"] = m.evals["COST"][1][-1]
    B = n_devices + 1
    batch = [SCFGP(sparsity=S, nfeats=M, seed=b, device=device)
             for b in range(B)]
    fit_fast_batch(batch, [(X, y)] * B, max_iter=5, mesh=mesh)
    costs["fit_fast_batch"] = [b.evals["COST"][1][-1] for b in batch]
    out = {k: np.asarray(torch.as_tensor(v).cpu()).tolist()
           for k, v in costs.items()}
    if not np.isfinite(np.concatenate([np.ravel(v) for v in
                                       out.values()])).all():
        raise FloatingPointError(f"non-finite cost in the dry run: {out}")
    return out
