"""Entry points of the port: the forward objective, and a dry run of every
parallel mode, chain-parallel sampling included.

Mirrors the root ``__graft_entry__.py`` (which imports the JAX package and
stays as it is): ``entry()`` (``:6-27``), the full NLML objective
(feature map, Gram, Cholesky posterior, expected NLL) on a kin8nm-sized
config, N=1024, D=8, S=50, M=200, and ``dryrun_multichip(n)``
(``:30-158``), on the card unless ``device`` says otherwise.  Chains are
sharded as JAX's ``NamedSharding(mesh, P("data", None))`` shards them:
``parallel.shard_chains`` gives a rank its block, the samplers take
``axis_name=mesh.group("data")`` and a seed alike on every rank (each
rank's draws its slice of the unsharded draws, ``bayes.hmc.ChainSlice``),
and ``parallel.gather_chains`` collects the result.
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
    ``fit_fast_batch(mesh=...)`` with B = n + 1 (trial padding), then
    chain-parallel sampling (``:101-158``) with C = 2n chains sharded over
    the mesh's data dimension (``parallel.shard_chains``, the samplers'
    ``axis_name=mesh.group("data")``, each rank's draws its slice of the
    unsharded draws): HMC with shared adaptation, the HMC fleet, the
    static NUTS fleet (depth 2) and minibatch pSGLD (batch 8), on
    ``make_logposterior`` and ``make_minibatch_value_and_grad``.  Each
    sampler must give finite draws and a readable ``divergences``; a
    fleet's step sizes, gathered over the ranks
    (``parallel.gather_chains``), have shape (C,); SGLD rejects no step.
    Raises if a rank fails or a value is not finite."""
    from .parallel import launch
    launch.run(dryrun_rank, n_devices, n_devices, device, device=device)
    print(f"dryrun_multichip({n_devices}) ok: dp (gspmd, shard_map) + "
          f"dp x tp + streaming+dp + model-level fit_fast(mesh) + "
          f"trial-parallel fit_fast_batch(mesh, B={n_devices + 1}) + "
          f"chain-sharded hmc, hmc fleet, nuts fleet and sgld "
          f"(C={2 * n_devices})")


def tiny_problem(n_devices: int):
    """The dry run's data: ``(X, y, (D, S, M))``, 8 rows a rank of D=4
    inputs, S=3, M=5 (S + M = 8: a feature axis that 2 divides)."""
    N, D, S, M = 8 * n_devices, 4, 3, 5
    rng = np.random.RandomState(0)
    X = rng.rand(N, D).astype(np.float32)
    y = rng.randn(N).astype(np.float32)
    return X, y, (D, S, M)


def dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank's part of ``dryrun_multichip``; returns its costs."""
    from .models.model import SCFGP, fit_fast_batch
    from .models.params import init_params
    from .ops.streaming import loss_and_grad_streaming
    from .opt.optimizers import make_optimizer
    from .parallel import (make_dp_train_step, make_mesh, make_mesh2d,
                           make_tp_train_step, shard_rows, shard_rows_2d)

    X, y, (D, S, M) = tiny_problem(n_devices)
    N = X.shape[0]
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
    costs.update(chain_parts(mesh, X, y, D, S, M, device))
    out = {k: np.asarray(torch.as_tensor(v).cpu()).tolist()
           for k, v in costs.items()}
    if not np.isfinite(np.concatenate([np.ravel(v) for v in
                                       out.values()])).all():
        raise FloatingPointError(f"non-finite cost in the dry run: {out}")
    return out


def chain_parts(mesh, X, y, D, S, M, device) -> dict:
    """The chain-sharded parts of the dry run (``__graft_entry__.py:
    101-158``, its budgets), on this rank's block of C = 2n chains; returns
    each part's mean log density over its draws (the same on every rank
    once gathered)."""
    from .bayes import (hmc_sample, make_logposterior,
                        make_minibatch_value_and_grad, nuts_sample_static,
                        reduced_dim, sgld_sample)
    from .models.params import init_params, pack_params
    from .parallel import gather_chains, shard_chains

    n = mesh.shape["data"]
    C, P = 2 * n, reduced_dim(D, S, M)
    gen = torch.Generator().manual_seed(1)
    q0 = torch.stack([pack_params(init_params(gen, D, S, M))[:P]
                      for _ in range(C)])
    q = shard_chains(mesh, q0.to(device))
    group = mesh.group("data")
    Xt = torch.as_tensor(X, device=device)
    yt = torch.as_tensor(y, device=device)
    logpost = make_logposterior(Xt, yt, D, S, M)
    hmc = dict(num_warmup=5, num_samples=5, num_integration_steps=4,
               init_step_size=0.003, axis_name=group)
    runs = {
        "hmc": hmc_sample(logpost, q, 2, **hmc),
        "hmc_fleet": hmc_sample(logpost, q, 3, shared_adaptation=False,
                                **hmc),
        "nuts_fleet": nuts_sample_static(
            logpost, q, 4, num_warmup=4, num_samples=4, depth=2,
            init_step_size=0.003, shared_adaptation=False, axis_name=group),
        "sgld": sgld_sample(
            make_minibatch_value_and_grad(Xt, yt, D, S, M, batch_size=8),
            q, 3, num_warmup=3, num_samples=4, step_size=1e-5,
            axis_name=group)}
    out = {}
    for name, res in runs.items():
        res = gather_chains(mesh, res)
        if not bool(torch.isfinite(res.samples).all()):
            raise FloatingPointError(f"non-finite draws in chain-sharded "
                                     f"{name}")
        if name == "sgld":
            if int(res.nonfinite) != 0:
                raise FloatingPointError("SGLD rejected steps in the dry run")
        else:
            int(res.divergences)  # present and readable
        if name.endswith("fleet") and tuple(res.step_size.shape) != (C,):
            raise ValueError(f"{name}: step sizes of shape "
                             f"{tuple(res.step_size.shape)}, not ({C},)")
        out[name] = float(res.logdensities.mean())
    return out
