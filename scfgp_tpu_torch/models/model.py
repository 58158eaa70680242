"""User-facing SCFGP model: set_data / optimize / fit / optimize_fused /
fit_fast / predict / update_data / recalibrate_dispersion / save / load.

Port of ``scfgp_tpu/models/model.py`` (the reference model class is
``reference: SCFGP/SCFGP.py:21-317``).  The model lives on one torch
``device`` in one ``dtype``; ``device="cuda"`` runs the feature map and its
gradient through the CUDA kernels K1f and K1b (``ops/phi.py``) and raises
when there is no card.  Serving steps are forward only and run under
``torch.inference_mode()``; training runs under grad, one
``objective.loss_and_grad`` per step.  Checkpoints are the JAX package's
arrays-only npz+JSON files (``utils/checkpoint.py``): each package loads
what the other saves, training-resume state included.

Batched sweeps and ensembles: ``fit_fast_batch`` trains B same-shape
models in one fused loop over a leading trial axis
(``opt/fused_loop.py::fused_optimize_batch``), each step one loss and
gradient for all B trials, so K1f and K1b launch once a step whatever B;
``fit_ensemble`` trains k restarts that way and predicts with their
mixture.

Not ported yet, each raising ``NotImplementedError`` with the ROADMAP.md
item that brings it: the ``visualizer`` argument, ``mesh=`` (of
``optimize_fused`` and ``fit_fast_batch``) and ``fit_bayes``.  The JAX
package's non-finite refit under an auto-resolved 1-pass TPU matmul
precision (``_precision_fallback_needed``, ``model.py:1488-1518``, and
its per-trial form in ``fit_fast_batch``, ``:310-322``) has no
counterpart: the port computes in IEEE float32 with TF32 off, so the
condition it guards can never arise.
"""

from __future__ import annotations

import math
import string
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..data.scaler import Scaler, backward_transform_stateless
from ..opt.fused_loop import (fused_optimize, fused_optimize_batch,
                              set_generator_state)
from ..opt.optimizers import algos, make_optimizer, tree_add, tree_map
from ..utils.logging import MetricLogger
from ..utils.metrics import new_evals_dict, regression_metrics
from .objective import (Posterior, feature_block, loss_and_grad, loss_fn,
                        predict_f, softplus, solve_posterior,
                        sufficient_stats)
from .params import (SCFGPParams, init_params, opt_state_from_numpy,
                     opt_state_to_numpy, resolve_sparsity)

DEFAULT_OPT = {
    # Reference defaulting, SCFGP.py:193-202 (adam overrides beta2 to 0.999).
    "algo": "adam",
    "algo_params": {"learning_rate": 0.01, "beta1": 0.9, "beta2": 0.999,
                    "epsilon": 1e-8},
}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to scfgp_tpu_torch yet: ROADMAP.md Queue 1 "
        f"{item}")


def fit_fast_batch(models, datasets, **opt_params):
    """Train B same-shape models as one batched fused loop
    (``scfgp_tpu/models/model.py:180-323``).

    ``models``: SCFGP instances sharing (S, M, extra_basis, dtype, device);
    ``datasets``: the matching ``(X, y)`` or ``(X, y, Xv, yv)`` tuples of
    identical shapes (the reference's sweep shape: a fresh random split a
    trial, ``reference: experiments/boston_housing/boston_housing.py:80``).

    Host work (scaler fits, param init) stays per model; the training loop
    runs B early-stopped trajectories at once, every step one loss and
    gradient over a leading trial axis (``fused_optimize_batch``).  Trial b
    draws what ``fit_fast`` of model b draws (its params, then its
    annealing generator's seed, from its own ``_rng``), so it replays that
    fit up to the rounding of batched products; trials are batched, never
    coupled.  The objective is the training cost, or the validation metric
    ``obj`` when the tuples carry ``Xv, yv``.  Each model gets its params,
    posterior and metrics; ``TIME(s)`` is the batch's wall time split
    evenly, an estimate.  Returns the models.

    ``mesh=`` raises ``NotImplementedError``: trial parallelism over
    several cards is ROADMAP.md Queue 1 item 8."""
    if len(models) != len(datasets):
        raise ValueError("models and datasets must have equal length")
    if opt_params.pop("mesh", None) is not None:
        raise _not_ported("fit_fast_batch(mesh=...)", "item 8 (parallel)")
    if not models:
        return models
    has_val = len(datasets[0]) == 4
    for m, d in zip(models, datasets):
        m.set_data(d[0], d[1])

    def shape(m, d):
        return (m.S, m.M, m.N, m.D, m.extra_basis, m.dtype, m.device,
                len(d), np.shape(d[2]) if len(d) == 4 else None)
    cfg = shape(models[0], datasets[0])
    if any(shape(m, d) != cfg for m, d in zip(models, datasets)):
        raise ValueError(
            "fit_fast_batch requires identical (S, M, N, D, extra_basis, "
            "dtype, device) and validation shapes across models; got a "
            "mismatch")
    m0 = models[0]
    obj = opt_params.get("obj", "COST").upper()
    obj = obj if obj in m0.evals else "COST"
    algo = opt_params.get("algo") or dict(DEFAULT_OPT)
    if not isinstance(algo, dict) or algo.get("algo") is None:
        algo = dict(DEFAULT_OPT)
    for m in models:
        for metric in m.evals:
            m.evals[metric][1] = []
    # The draw of optimize_fused, model by model: batched == sequential.
    generators = []
    for m in models:
        gen = torch.Generator(device=m.device)
        gen.manual_seed(m._rng.randint(0, 2**31 - 1))
        generators.append(gen)
    params = SCFGPParams(*[torch.stack(leaves)
                           for leaves in zip(*[m.params for m in models])])
    X = torch.stack([_trainable(m.X) for m in models])
    y = torch.stack([_trainable(m.y) for m in models])
    basis = m0.extra_basis

    def value_and_grad(q):
        (cost, aux), grads = loss_and_grad(q, X, y, basis_fn=basis)
        return (cost, aux.post), grads

    def eval_fn(q):
        with torch.no_grad():
            cost, aux = loss_fn(q, X, y, basis_fn=basis)
        return cost, aux.post

    obj_fn = None
    if has_val and obj != "COST":
        obj_fn = _batched_validation_objective(models, datasets, obj)
    tx = make_optimizer(algo["algo"], algo.get("algo_params"))
    t0 = time.time()
    res = fused_optimize_batch(
        value_and_grad, tx, params, generators,
        max_iter=opt_params.get("max_iter", 500),
        cvrg_tol=opt_params.get("cvrg_tol", 1e-4),
        max_cvrg=opt_params.get("max_cvrg", 18), obj_fn=obj_fn,
        eval_fn=eval_fn)
    if m0.device.type == "cuda":
        torch.cuda.synchronize(m0.device)
    wall = time.time() - t0
    costs = res.cost_history.cpu().numpy()
    for i, (m, d) in enumerate(zip(models, datasets)):
        m.params = SCFGPParams(*[t[i].clone() for t in res.params])
        m.post = Posterior(*[t[i].clone() for t in res.post])
        m._stats = None
        m._ensemble = None
        n = res.num_iters[i]
        m.evals["COST"][1] = costs[i, :n].tolist()
        # An estimate: the B trials ran as one loop, so the batch's wall
        # time is split evenly (and linearly across iterations).
        m.evals["TIME(s)"][1] = list(
            np.linspace(wall / max(n, 1), wall, max(n, 1)) / len(models))
        if has_val:
            m._predict_scaled_and_log(m._scale_X(d[2]),
                                      np.asarray(d[3]).reshape(-1, 1))
        m.min_obj_ind = -1
    return models


def _metric(obj, mu_y, std_y, ys):
    """The validation metric ``obj`` of predictions in original units
    (``SCFGP.py:278-294``), over the last axis: one value a trial."""
    err = mu_y - ys
    if obj in ("MAE", "NMAE"):
        mae = torch.mean(torch.abs(err), dim=-1)
        return mae if obj == "MAE" else mae / torch.std(ys, dim=-1,
                                                        correction=0)
    mse = torch.mean(err * err, dim=-1)
    var_ys = torch.var(ys, dim=-1, correction=0)
    if obj in ("MSE", "NMSE", "RMSE"):
        return {"MSE": mse, "NMSE": mse / var_ys,
                "RMSE": torch.sqrt(mse)}[obj]
    mnlp = 0.5 * torch.mean(((ys - mu_y) / std_y) ** 2
                            + torch.log(2 * math.pi * std_y * std_y), dim=-1)
    if obj == "MNLP":
        return mnlp
    return (mse / var_ys) / (1 + torch.exp(-mnlp))  # SCORE


def _batched_validation_objective(models, datasets, obj):
    """``SCFGP._validation_objective`` for the trials of ``fit_fast_batch``:
    validation rows (B, Nv, D) scaled by each model's X-scaler, and the
    y-scalers' states stacked a trial (``scfgp_tpu/models/model.py:262-
    278``), so each trial is un-scaled by its own scaler."""
    m0 = models[0]
    Xv_t = torch.stack([m._scale_X(d[2]) for m, d in zip(models, datasets)])
    ys = torch.stack([m._tensor(np.asarray(d[3]).reshape(-1))
                      for m, d in zip(models, datasets)])
    # Each state is one value a column of y: stacked, one a trial, (B,),
    # so that it broadcasts over (Nv, B), a trial a column.
    y_state = {k: torch.stack([m.y_scaler.state[k].to(m0.dtype)
                               for m in models]).squeeze(-1)
               for k in m0.y_scaler.state}
    y_algo, y_compat = m0.y_scaler.algo, m0.y_scaler.compat_reference
    basis = m0.extra_basis

    def bk(a):
        return backward_transform_stateless(y_algo, y_state, a.mT,
                                            y_compat).mT

    def obj_fn(params, post, cost):
        with torch.no_grad():
            mu_f, std_f = predict_f(params, post, Xv_t, basis_fn=basis)
        mu_y = bk(mu_f)
        std_y = 0.5 * (bk(mu_f + std_f) - bk(mu_f - std_f))
        return _metric(obj, mu_y, std_y, ys)
    return obj_fn


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SCFGP(device=%r): CUDA is not available on this "
                           "machine" % str(device))
    return device


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _trainable(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if it was made under ``inference_mode`` (as
    ``update_data`` makes the data): autograd cannot save such a tensor."""
    return t.clone() if t.is_inference() else t


def _median(stacked: torch.Tensor) -> torch.Tensor:
    """``jnp.median(stacked, axis=0)``: the midpoint ``(lower + upper) *
    0.5`` of the middle values, so an even count averages the two (where
    ``torch.median`` would return the lower one)."""
    s = torch.sort(stacked, dim=0).values
    n = stacked.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def recalibrated_c(mu_f, std_f, y, c) -> float:
    """Dispersion ``c`` with ``softplus(c) = mean(resid²) / (1 +
    mean(var_f))`` over the training rows, from the scaled predictive
    moments there (``scfgp_tpu/models/model.py:1603-1610``)."""
    sp_c = float(softplus(c))
    var_f = _to_numpy(std_f) ** 2 / sp_c - 1.0
    resid2 = float(np.mean((_to_numpy(mu_f) - _to_numpy(y)) ** 2))
    new_sp = max(resid2 / (1.0 + float(np.mean(var_f))), 1e-12)
    return float(np.log(np.expm1(new_sp))) if new_sp < 30 else new_sp


class SCFGP:
    """Sparsely Correlated Fourier features Gaussian Process (PyTorch)."""

    def __init__(self, sparsity: int = 20, nfeats: int = 18, evals=None,
                 X_scaling_method: str = "auto-inv-normal",
                 y_scaling_method: str = "auto-normal",
                 verbose: bool = False, seed: Optional[int] = None,
                 dtype=torch.float32, extra_basis=None, fftype=None,
                 msg=None, device="cuda"):
        # Legacy v0.1.0 ctor compatibility (reference README.md:44-52;
        # ``SCFGP(rank, feature_size, fftype, msg)``): the 3rd/4th
        # positionals were the Fourier-feature-type flag and the print flag
        # — detected in the evals/X_scaling_method slots, as in
        # scfgp_tpu/models/model.py:478-483.
        if isinstance(evals, (bool, np.bool_)):
            fftype, evals = evals, None
        if isinstance(X_scaling_method, (bool, np.bool_)):
            msg, X_scaling_method = bool(X_scaling_method), "auto-inv-normal"
        if msg is not None:
            verbose = bool(msg)
        self.device = _resolve_device(device)
        self.dtype = dtype
        self.fftype = fftype
        self.S = sparsity
        self.M = nfeats
        self.extra_basis = extra_basis
        self.X_scaler = Scaler(X_scaling_method)
        self.y_scaler = Scaler(y_scaling_method)
        self.evals = new_evals_dict() if evals is None else evals
        self.verbose = verbose
        self._rng = np.random.RandomState(seed)
        self.params: Optional[SCFGPParams] = None
        self.post: Optional[Posterior] = None
        self.cost = None          # forward objective of the last set_data
        self.thetas = None        # posterior draws, kept from a checkpoint
        self._train_state = None  # resume states, kept from a checkpoint
        self._fused_train_state = None
        self._stats = None        # update_data sufficient-stats cache
        self._ensemble = None     # [(params, post)] mixture members
        self.N = self.D = -1
        self.X = self.y = None
        self.min_obj_ind = 0
        self.generate_ID()

    # -- identity / logging --------------------------------------------------

    def generate_ID(self):
        chars = string.ascii_uppercase + string.digits
        self.ID = "".join(self._rng.choice(list(chars)) for _ in range(5))
        self.NAME = "SCFGP (Sparsity=%d, Fourier Features=%d)" % (self.S, self.M)

    def message(self, *arg):
        if self.verbose:
            print(" ".join(map(str, arg)))
            sys.stdout.flush()

    # -- convenience views of the posterior ----------------------------------

    @property
    def alpha(self):
        return None if self.post is None else self.post.alpha

    @property
    def Li(self):
        return None if self.post is None else self.post.Li

    # -- data ingestion -------------------------------------------------------

    def _tensor(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=self.dtype, device=self.device)

    def _scale_X(self, X) -> torch.Tensor:
        X = torch.as_tensor(np.asarray(X), device=self.device)
        return self.X_scaler.forward_transform(X).to(self.dtype).contiguous()

    def _scale_y(self, y) -> torch.Tensor:
        y = torch.as_tensor(np.asarray(y).reshape(-1, 1), device=self.device)
        return self.y_scaler.forward_transform(y).to(self.dtype).reshape(-1)

    def set_data(self, X, y):
        """Fit the scalers and transform the data (``SCFGP.py:153-170``).

        Without params, draws them (``init_params``); with params (e.g.
        after ``load``), conditions the posterior on the data by the forward
        objective and records its value in ``self.cost``."""
        self.message("-" * 60, "\nNormalizing SCFGP training data...")
        self.X_scaler.fit(X).to(self.device)
        self.y_scaler.fit(y).to(self.device)
        self.X = self._scale_X(X)
        self.y = self._scale_y(y)
        self.message("done.")
        self._stats = None  # update_data cache: params/data changed
        self.N, self.D = self.X.shape
        self.S = resolve_sparsity(self.S, self.D, self.M)
        if self.params is None:
            self.message("-" * 60, "\nInitializing SCFGP hyperparameters...")
            gen = torch.Generator().manual_seed(
                self._rng.randint(0, 2**31 - 1))
            self.params = SCFGPParams(*[
                t.to(self.device) for t in
                init_params(gen, self.D, self.S, self.M, self.dtype)])
            self.message("done.")
        else:
            with torch.inference_mode():
                self.cost, aux = loss_fn(self.params, self.X, self.y,
                                         basis_fn=self.extra_basis)
            self.post = aux.post

    def _stats_of(self, X, y):
        return sufficient_stats(
            feature_block(self.params, X, self.extra_basis), y)

    @torch.inference_mode()
    def update_data(self, Xnew, ynew):
        """Online conditioning: fold new rows into the posterior WITHOUT
        retraining hyperparameters (``scfgp_tpu/models/model.py:1531-1565``).

        Every data-dependent quantity of the posterior is an additive
        sufficient statistic (ΦᵀΦ, Φᵀy, yᵀy, N — ``reference:
        SCFGP/SCFGP.py:104,108,126``), so conditioning on new rows is a
        statistics update plus one 2K x 2K re-solve.  Scalers and
        hyperparameters stay fixed."""
        if self.params is None or self.X is None:
            raise RuntimeError("update_data() before fit: train first "
                               "(hyperparameters and scalers must exist)")
        Xn = self._scale_X(Xnew)
        yn = self._scale_y(ynew)
        if self._stats is None:
            self._stats = self._stats_of(self.X, self.y)
        new = self._stats_of(Xn, yn)
        self._stats = type(new)(*[a + b for a, b in zip(self._stats, new)])
        self.post = solve_posterior(self._stats,
                                    torch.exp(2.0 * self.params.a))
        self.X = torch.cat([self.X, Xn], dim=0)
        self.y = torch.cat([self.y, yn])
        self.N = int(self.X.shape[0])
        return self

    def _recalibrated_c(self, params, post) -> torch.Tensor:
        mu_f, std_f = predict_f(params, post, self.X,
                                basis_fn=self.extra_basis)
        return torch.tensor(recalibrated_c(mu_f, std_f, self.y, params.c),
                            dtype=params.c.dtype, device=params.c.device)

    @torch.inference_mode()
    def recalibrate_dispersion(self):
        """Closed-form post-fit recalibration of the dispersion ``c``
        (``scfgp_tpu/models/model.py:1582-1634``): the mean training
        predictive variance is set to the mean squared training residual.
        Point predictions and the posterior are untouched; each mixture
        member is recalibrated too."""
        if self.post is None:
            raise RuntimeError("recalibrate_dispersion() before training")
        if self.X is None:
            raise RuntimeError("recalibrate_dispersion() after load(): call "
                               "set_data() with the training data first")
        self.params = self.params._replace(
            c=self._recalibrated_c(self.params, self.post))
        if self._ensemble is not None:
            self._ensemble = [
                (mp._replace(c=self._recalibrated_c(mp, mpost)), mpost)
                for mp, mpost in self._ensemble]
        self._stats = None
        return self

    # -- training -------------------------------------------------------------

    def _eval_fn(self):
        """Loss WITHOUT update (reference train_func, ``SCFGP.py:134-135``)."""
        basis = self.extra_basis

        def eval_fn(p, X, y):
            with torch.no_grad():
                return loss_fn(p, X, y, basis_fn=basis)
        return eval_fn

    def _make_step(self, tx):
        """Loss + grad + optimizer update (the reference's train_iter_func,
        ``SCFGP.py:136-137``): ``(params, opt_state, X, y) -> (params,
        opt_state, cost, post)``, ``post`` at the params before the step."""
        basis = self.extra_basis

        def step(params, opt_state, X, y):
            (cost, aux), grads = loss_and_grad(params, X, y, basis_fn=basis)
            delta, opt_state = tx.update(grads, opt_state, params)
            return tree_add(params, delta), opt_state, cost, aux.post
        return step

    def _minibatches(self, batchsize, shuffle=True):
        """Shuffled minibatch generator (``SCFGP.py:172-182``), shuffled by
        the NumPy ``self._rng`` as in the JAX package, so both draw the same
        batches.  ``batchsize > N`` degrades to one full batch."""
        n = self.X.shape[0]
        batchsize = min(batchsize, n)
        inds = np.arange(n)
        if shuffle:
            self._rng.shuffle(inds)
        for start in range(0, n - batchsize + 1, batchsize):
            batch = torch.as_tensor(inds[start:start + batchsize],
                                    device=self.device)
            yield self.X[batch], self.y[batch]

    def optimize(self, Xv=None, yv=None, funcs=None, visualizer=None, **args):
        """Reference-semantics training loop on the host
        (``SCFGP.py:184-276``; ``scfgp_tpu/models/model.py:620-798``).

        One loss + grad + optimizer step per iteration; early stopping,
        stall annealing (drawn from the NumPy ``self._rng``, as in the JAX
        package, so the same seed and params replay its trajectory) and the
        best-params restore.  ``nbatches > 1`` aggregates the per-batch
        params by their elementwise median.  ``log_file`` appends one JSON
        record per iteration; ``checkpoint_path``/``checkpoint_every`` save
        mid-training checkpoints.  ``resume=True`` continues from
        ``self._train_state`` (set by a prior ``optimize()`` or restored by
        ``load()``, from either package): optimizer accumulators, iteration,
        best-params tracking and the host RNG are restored, so an
        interrupted-and-resumed run replays the uninterrupted one."""
        if visualizer is not None:
            raise _not_ported("optimize(visualizer=...)",
                              "item 9 (utilities: utils/visualizer.py)")
        resume = bool(args.get("resume", False))
        ts = self._train_state
        if resume and not ts:
            raise RuntimeError(
                "optimize(resume=True) requires a prior optimize() or a "
                "load()ed mid-training checkpoint (no train_state found)")
        obj = args.get("obj", ts["obj"] if resume else "COST").upper()
        obj = obj if obj in self.evals else "COST"
        algo = args.get("algo") or (ts["algo"] if resume else None) \
            or dict(DEFAULT_OPT)
        if not isinstance(algo, dict) or algo.get("algo") not in algos:
            algo = dict(DEFAULT_OPT)
        nbatches = args.get("nbatches", 1)
        batchsize = args.get("batchsize", 150)
        cvrg_tol = args.get("cvrg_tol", 1e-4)
        max_cvrg = args.get("max_cvrg", 18)
        max_iter = args.get("max_iter", 500)
        logger = MetricLogger(args.get("log_file"))
        checkpoint_path = args.get("checkpoint_path")
        checkpoint_every = args.get("checkpoint_every", 25)
        last_ckpt_iter = -1

        if not resume:
            for metric in self.evals:
                self.evals[metric][1] = []

        tx = make_optimizer(algo["algo"], algo.get("algo_params"))
        opt_state = tx.init(self.params)
        step = self._make_step(tx)
        eval_fn = self._eval_fn()
        X, y = _trainable(self.X), _trainable(self.y)

        if Xv is None or yv is None:
            obj = "COST"
        else:
            Xv_t = self._scale_X(Xv)
            yv_arr = np.asarray(yv).reshape(-1, 1)

        self.min_obj_ind = 0
        train_start_time = time.time()
        min_obj_val = np.inf
        argmin_params = self.params
        cvrg_iter = 0
        start_iter = 0
        if resume:
            # Dtypes are kept exactly (AdamState.t is float32 beside float64
            # params): a cast would change beta**t and the replay.
            opt_state = opt_state_from_numpy(ts["opt_state"], self.device)
            argmin_params = opt_state_from_numpy(ts["argmin_params"],
                                                 self.device)
            self.params = opt_state_from_numpy(ts["params"], self.device)
            min_obj_val = float(ts["min_obj_val"])
            cvrg_iter = int(ts["cvrg_iter"])
            start_iter = int(ts["iteration"]) + 1
            self.min_obj_ind = int(ts["min_obj_ind"])
            self._rng.set_state(ts["rng_state"])
            train_start_time = time.time() - float(ts["elapsed"])
        for it in range(start_iter, max_iter):
            if nbatches > 1:
                params_list, cost_sum, count = [], 0.0, 0
                for Xb, yb in self._minibatches(batchsize):
                    self.params, opt_state, cost, self.post = step(
                        self.params, opt_state, Xb, yb)
                    params_list.append(self.params)
                    cost_sum += float(cost)
                    count += 1
                    if count == nbatches:
                        break
                # The intended robust aggregation: elementwise median of the
                # per-batch params (the reference's never fed back, a
                # rebinding bug, SCFGP.py:226-235).
                self.params = tree_map(
                    lambda *leaves: _median(torch.stack(leaves)),
                    *params_list)
                self.evals["COST"][1].append(cost_sum / count)
            else:
                self.params, opt_state, cost, self.post = step(
                    self.params, opt_state, X, y)
                self.evals["COST"][1].append(float(cost))
            self.evals["TIME(s)"][1].append(time.time() - train_start_time)
            if Xv is not None and yv is not None:
                self._predict_scaled_and_log(Xv_t, yv_arr)
            if it % max(max_iter // 10, 1) == 1:
                self.message("-" * 17, "VALIDATION ITERATION", it, "-" * 17)
                self._print_current_evals()
            logger.log(it, **{k: (self.evals[k][1][-1]
                                  if self.evals[k][1] else None)
                              for k in ("COST", "NMSE", "MNLP", "RMSE")})
            obj_val = self.evals[obj][1][-1]
            improved = obj_val < min_obj_val
            if improved:
                if min_obj_val - obj_val < cvrg_tol:
                    cvrg_iter += 1
                else:
                    cvrg_iter = 0
                min_obj_val = obj_val
                self.min_obj_ind = len(self.evals["COST"][1]) - 1
                argmin_params = self.params
            else:
                cvrg_iter += 1
            if it > 30 and cvrg_iter > max_cvrg:
                break
            elif cvrg_iter > max_cvrg * 0.5:
                # Stall annealing: random interpolation toward the best-known
                # params (SCFGP.py:259-263).
                randp = self._rng.rand() * cvrg_iter / max_cvrg * 0.5
                self.params = tree_map(
                    lambda p, q: (1 - randp) * p + randp * q,
                    self.params, argmin_params)
            # End-of-iteration state: all resume needs to replay the rest.
            self._train_state = {
                "algo": algo, "obj": obj, "opt_state": opt_state,
                "params": self.params,  # LIVE params, not the argmin
                "argmin_params": argmin_params, "iteration": it,
                "min_obj_val": float(min_obj_val),
                "cvrg_iter": int(cvrg_iter),
                "min_obj_ind": int(self.min_obj_ind),
                "rng_state": self._rng.get_state(),
                "elapsed": time.time() - train_start_time,
            }
            if (checkpoint_path and it - last_ckpt_iter >= checkpoint_every
                    and improved):
                self.save(checkpoint_path)
                last_ckpt_iter = it

        self.params = argmin_params
        self._stats = None  # params changed: update_data cache is stale
        self._ensemble = None  # a fresh point fit supersedes any mixture
        cost, aux = eval_fn(self.params, X, y)
        self.post = aux.post
        self.evals["COST"][1].append(float(cost))
        self.evals["TIME(s)"][1].append(time.time() - train_start_time)
        if Xv is not None and yv is not None:
            self._predict_scaled_and_log(Xv_t, yv_arr)
        self.min_obj_ind = len(self.evals["COST"][1]) - 1
        logger.close()
        if checkpoint_path:
            self.save(checkpoint_path)
        disp = self.verbose
        self.verbose = True
        self.message("-" * 19, "OPTIMIZATION RESULT", "-" * 20)
        self._print_current_evals()
        self.message("-" * 60)
        self.verbose = disp

    def fit(self, X, y, Xv=None, yv=None, **opt_params):
        """One-call train: set_data + optimize (+ final metrics if Xv given)
        (``reference: README.md:44-52``)."""
        self.set_data(X, y)
        self.optimize(Xv, yv, **opt_params)
        return self

    def _validation_objective(self, obj, Xv, yv):
        """``obj_fn(params, post, cost)`` of the fused loop: the metric
        ``obj`` of the predictions on the validation rows, in original units
        (``SCFGP.py:278-294``, half-range std rule ``SCFGP.py:281-284``;
        ``scfgp_tpu/models/model.py:111-147``), all on the device."""
        Xv_t = self._scale_X(Xv)
        ys = self._tensor(np.asarray(yv).reshape(-1))
        # Model dtype throughout, as the JAX package casts the scaler state.
        y_state = {k: v.to(self.dtype) for k, v in self.y_scaler.state.items()}
        y_algo, y_compat = self.y_scaler.algo, self.y_scaler.compat_reference
        basis = self.extra_basis

        def bk(a):
            return backward_transform_stateless(
                y_algo, y_state, a[:, None], y_compat).reshape(-1)

        def obj_fn(params, post, cost):
            with torch.no_grad():
                mu_f, std_f = predict_f(params, post, Xv_t, basis_fn=basis)
            mu_y = bk(mu_f)
            std_y = 0.5 * (bk(mu_f + std_f) - bk(mu_f - std_f))
            return _metric(obj, mu_y, std_y, ys)
        return obj_fn

    def optimize_fused(self, Xv=None, yv=None, **args):
        """``optimize()`` with the whole loop on the device
        (``opt/fused_loop.py``; ``scfgp_tpu/models/model.py:811-960``).

        The semantics of ``optimize()`` for nbatches=1 (early stopping,
        annealing, best-params restore), with the annealing uniforms drawn
        from a ``torch.Generator`` on the model's device, seeded from
        ``self._rng``.  The objective is the training cost, or the
        validation metric ``obj`` when ``Xv``/``yv`` are given.  Per-
        iteration history is COST only; the validation metrics get one
        final entry.

        ``checkpoint_path`` + ``checkpoint_every=k`` pause the loop at
        k-iteration boundaries and save a checkpoint at each; after a crash,
        ``load()`` + ``optimize_fused(resume=True)`` (same Xv/yv) replays the
        uninterrupted run bitwise.  A fused state written by the JAX package
        carries a threefry key no torch generator can replay, and resuming
        it raises ``ValueError``.  ``recalibrate=True`` ends with
        ``recalibrate_dispersion()``."""
        if args.get("mesh") is not None:
            raise _not_ported("optimize_fused(mesh=...)",
                              "item 8 (parallel)")
        resume = bool(args.get("resume", False))
        fts = self._fused_train_state if resume else None
        if resume and not fts:
            raise ValueError(
                "optimize_fused(resume=True) requires a prior "
                "optimize_fused(checkpoint_path=...) or a load()ed fused "
                "checkpoint (no fused train state found)")
        obj = args.get("obj", fts["obj"] if resume else "COST").upper()
        obj = obj if obj in self.evals else "COST"
        algo = args.get("algo") or (dict(fts["algo"]) if resume
                                    else dict(DEFAULT_OPT))
        if not isinstance(algo, dict) or algo.get("algo") is None:
            algo = dict(DEFAULT_OPT)
        cvrg_tol = args.get("cvrg_tol", fts["cvrg_tol"] if resume else 1e-4)
        max_cvrg = args.get("max_cvrg", fts["max_cvrg"] if resume else 18)
        max_iter = args.get("max_iter", fts["max_iter"] if resume else 500)
        checkpoint_path = args.get(
            "checkpoint_path", fts.get("checkpoint_path") if resume else None)
        checkpoint_every = int(args.get(
            "checkpoint_every",
            (fts.get("checkpoint_every") or 0) if resume else 0) or 0)

        for metric in self.evals:
            self.evals[metric][1] = []

        generator = torch.Generator(device=self.device)
        generator.manual_seed(self._rng.randint(0, 2**31 - 1))
        loop_state = None
        if resume:
            # Checked before the state moves to the device: a JAX key raises.
            set_generator_state(generator, fts["state"].key)
            loop_state = opt_state_from_numpy(fts["state"], self.device)
        tx = make_optimizer(algo["algo"], algo.get("algo_params"))
        X, y = _trainable(self.X), _trainable(self.y)
        basis = self.extra_basis

        def value_and_grad(q):
            (cost, aux), grads = loss_and_grad(q, X, y, basis_fn=basis)
            return (cost, aux.post), grads

        eval_loss = self._eval_fn()

        def eval_fn(q):
            cost, aux = eval_loss(q, X, y)
            return cost, aux.post

        obj_fn = None
        if Xv is not None and yv is not None and obj != "COST":
            obj_fn = self._validation_objective(obj, Xv, yv)

        def run(state, upto):
            return fused_optimize(value_and_grad, tx, self.params, generator,
                                  max_iter=max_iter, cvrg_tol=cvrg_tol,
                                  max_cvrg=max_cvrg, obj_fn=obj_fn,
                                  eval_fn=eval_fn, state=state, upto=upto)

        def record(res, done):
            self._fused_train_state = {
                "state": opt_state_to_numpy(res.state),
                "obj": obj, "algo": algo, "max_iter": int(max_iter),
                "cvrg_tol": float(cvrg_tol), "max_cvrg": int(max_cvrg),
                "checkpoint_path": checkpoint_path,
                "checkpoint_every": checkpoint_every, "done": bool(done),
            }

        t0 = time.time()
        if checkpoint_path and checkpoint_every > 0:
            it0 = 0 if loop_state is None else int(loop_state.it)
            while True:
                boundary = min(
                    (it0 // checkpoint_every + 1) * checkpoint_every,
                    max_iter)
                res = run(loop_state, boundary)
                loop_state, it0 = res.state, res.num_iters
                record(res, res.done)
                self.params = res.params  # checkpoint carries best-so-far
                self.post = res.post
                self.save(checkpoint_path)
                if res.done:
                    break
        else:
            res = run(loop_state, None)
            record(res, True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        self.params = res.params
        self._stats = None  # params changed: update_data cache is stale
        self._ensemble = None  # a fresh point fit supersedes any mixture
        self.post = res.post
        if args.get("recalibrate", False):
            self.recalibrate_dispersion()
        n = res.num_iters
        self.evals["COST"][1] = res.cost_history[:n].tolist()
        self.evals["TIME(s)"][1] = list(
            np.linspace(wall / max(n, 1), wall, max(n, 1)))
        if Xv is not None and yv is not None:
            self._predict_scaled_and_log(self._scale_X(Xv),
                                         np.asarray(yv).reshape(-1, 1))
        # Histories differ in length in fused mode (per-iteration COST, one
        # final entry per validation metric): -1 is the best-params entry
        # of every series.
        self.min_obj_ind = -1
        return self

    def fit_fast(self, X, y, Xv=None, yv=None, **opt_params):
        """One-call fused training: set_data + optimize_fused."""
        self.set_data(X, y)
        self.optimize_fused(Xv, yv, **opt_params)
        return self

    def fit_ensemble(self, X, y, Xv=None, yv=None, k: int = 5,
                     mix_best: Optional[int] = None, **opt_params):
        """Deep-ensemble fit (``scfgp_tpu/models/model.py:968-1036``): k
        independent restarts trained as one batched fused loop
        (``fit_fast_batch``), predictions mixed as an equal-weight GP
        mixture (law of total variance over members).  ``mix_best=j``
        mixes only the j best members by the final validation objective,
        the selection rule of the reference's best-model tournament
        (``reference: boston_housing.py:90-102``).

        After this call ``predict`` returns the mixture, and ``params`` /
        ``post`` hold the best single member."""
        members = [SCFGP(sparsity=self.S, nfeats=self.M,
                         X_scaling_method=self.X_scaler.algo,
                         y_scaling_method=self.y_scaler.algo,
                         seed=self._rng.randint(0, 2**31 - 1),
                         dtype=self.dtype, extra_basis=self.extra_basis,
                         device=self.device)
                   for _ in range(int(k))]
        has_val = Xv is not None and yv is not None
        data = [(X, y, Xv, yv) if has_val else (X, y)] * len(members)
        fit_fast_batch(members, data, **opt_params)

        # Members share scaler state (fitted on the same X, y): adopt it.
        m0 = members[0]
        self.X_scaler, self.y_scaler = m0.X_scaler, m0.y_scaler
        self.X, self.y = m0.X, m0.y
        self.N, self.D, self.S = m0.N, m0.D, m0.S
        obj = opt_params.get("obj", "COST").upper()
        obj = obj if obj in self.evals and has_val else "COST"

        def final_obj(m):
            series = m.evals[obj][1]
            return series[-1] if series else np.inf

        if mix_best is not None and has_val:
            members = sorted(members, key=final_obj)[:max(1, int(mix_best))]
        best = min(members, key=final_obj)
        self.params, self.post = best.params, best.post
        self._stats = None
        self._ensemble = [(m.params, m.post) for m in members]
        for metric in self.evals:
            self.evals[metric][1] = (list(best.evals[metric][1])
                                     if metric in ("COST", "TIME(s)") else [])
        if has_val:  # metrics of the mixture
            self._predict_scaled_and_log(self._scale_X(Xv),
                                         np.asarray(yv).reshape(-1, 1))
        self.min_obj_ind = -1
        return self

    def fit_bayes(self, *args, **kwargs):
        """``scfgp_tpu`` ``SCFGP.fit_bayes``: not ported yet."""
        raise _not_ported("fit_bayes", "item 7 (Bayes layer)")

    # -- prediction -----------------------------------------------------------

    def _predict_scaled_and_log(self, Xs_t, ys):
        mu_y, std_y = self._predict_unscale(Xs_t)
        for k, v in regression_metrics(mu_y, std_y, ys).items():
            self.evals[k][1].append(v)
        return mu_y, std_y

    @torch.inference_mode()
    def _predict_unscale(self, Xs_t):
        """Predict on transformed inputs; un-scale with the half-range std
        rule for nonlinear y-scalers (``SCFGP.py:281-284``).  A mixture
        (``_ensemble``) predicts by the law of total variance."""
        if self.post is None:
            raise RuntimeError(
                "predict() before training: load() a checkpoint with a "
                "stored posterior, or call set_data() on a loaded model")
        if self._ensemble:
            mus, var = [], 0.0
            for p, post in self._ensemble:
                mu_j, std_j = predict_f(p, post, Xs_t,
                                        basis_fn=self.extra_basis)
                mus.append(mu_j)
                var = var + std_j * std_j / len(self._ensemble)
            mu_f = sum(mus) / len(self._ensemble)
            var = var + sum((m - mu_f) ** 2 for m in mus) / len(self._ensemble)
            return self._unscale_moments(mu_f, torch.sqrt(var))
        mu_f, std_f = predict_f(self.params, self.post, Xs_t,
                                basis_fn=self.extra_basis)
        return self._unscale_moments(mu_f, std_f)

    def _unscale_moments(self, mu_f, std_f):
        """Scaled-space (mu, std) -> original units as NumPy arrays (N, 1),
        half-range std rule (``SCFGP.py:281-284``)."""
        mu_f = mu_f[:, None]
        std_f = std_f[:, None]
        mu_y = self.y_scaler.backward_transform(mu_f)
        up = self.y_scaler.backward_transform(mu_f + std_f)
        dn = self.y_scaler.backward_transform(mu_f - std_f)
        return _to_numpy(mu_y), _to_numpy(0.5 * (up - dn))

    def predict(self, Xs, ys=None):
        """Predictive mean/std in original units; logs metrics if ys given
        (``SCFGP.py:278-294``)."""
        Xs_t = self._scale_X(Xs)
        if ys is not None:
            return self._predict_scaled_and_log(Xs_t, np.asarray(ys))
        return self._predict_unscale(Xs_t)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str):
        """Checkpoint params, scalers, posterior and history as plain arrays,
        in the JAX package's format (``scfgp_tpu/models/model.py:1734-1776``).
        Mid-training checkpoints carry the resume state (optimizer
        accumulators, iteration, host RNG, the fused loop's carry) as NumPy
        arrays of their own dtypes; posterior draws read by ``load`` are
        written back unchanged."""
        train_state = fused_ts = None
        if self._train_state is not None:
            train_state = dict(self._train_state)
            for k in ("opt_state", "params", "argmin_params"):
                train_state[k] = opt_state_to_numpy(train_state[k])
        if self._fused_train_state is not None:
            fused_ts = dict(self._fused_train_state)
            fused_ts["state"] = opt_state_to_numpy(fused_ts["state"])
        state = {
            "ID": self.ID, "S": self.S, "M": self.M, "N": self.N, "D": self.D,
            "X_scaler": self.X_scaler.to_state_dict(),
            "y_scaler": self.y_scaler.to_state_dict(),
            "params": self.params,
            "post": self.post,
            "evals": self.evals,
            "min_obj_ind": self.min_obj_ind,
            "thetas": self.thetas,
            "train_state": train_state,
            "fused_train_state": fused_ts,
            "ensemble": self._ensemble or None,
        }
        from ..utils.checkpoint import save_state
        save_state(path, state)

    def load(self, path: str):
        """Load a checkpoint written by either package, cast to this model's
        dtype and device (``scfgp_tpu/models/model.py:1778-1811``)."""
        from ..utils.checkpoint import load_state
        state, _fmt = load_state(path)
        self.ID = state["ID"]
        self.S, self.M = state["S"], state["M"]
        self.N, self.D = state["N"], state["D"]
        self.X_scaler = Scaler.from_state_dict(state["X_scaler"]).to(
            self.device)
        self.y_scaler = Scaler.from_state_dict(state["y_scaler"]).to(
            self.device)
        self._stats = None
        if state["params"] is not None:
            self.params = SCFGPParams(*map(self._tensor, state["params"]))
        if state["post"] is not None:
            self.post = Posterior(*map(self._tensor, state["post"]))
        self.evals = state["evals"]
        self.min_obj_ind = state.get("min_obj_ind", 0)
        self._train_state = state.get("train_state")
        self._fused_train_state = state.get("fused_train_state")
        self._ensemble = None
        if state.get("ensemble"):
            self._ensemble = [
                (SCFGPParams(*map(self._tensor, p)),
                 Posterior(*map(self._tensor, q)))
                for p, q in state["ensemble"]]
        if state.get("thetas") is not None:
            self.thetas = self._tensor(state["thetas"])
        self.NAME = "SCFGP (Sparsity=%d, Fourier Features=%d)" % (self.S, self.M)
        return self

    # -- legacy result attributes (reference README.md:44-52) ----------------

    _LEGACY_MAP = {
        "TsMAE": "MAE", "TsNMAE": "NMAE", "TsMSE": "MSE", "TsNMSE": "NMSE",
        "TsRMSE": "RMSE", "TsMNLP": "MNLP", "SCORE": "SCORE",
    }

    def __getattr__(self, name):
        # Legacy v0.1.0 result attributes (TsMAE, TsRMSE, ...) of the
        # reference's old API (abalone.py:58-79, kin8nm.py:53-74); TrTime is
        # the total training time.
        if name in SCFGP._LEGACY_MAP:
            series = self.evals[SCFGP._LEGACY_MAP[name]][1]
            if not series:
                raise AttributeError(f"{name}: no evaluations recorded yet")
            ix = self.min_obj_ind if self.min_obj_ind < len(series) else -1
            return series[ix]
        if name == "TrTime":
            series = self.evals["TIME(s)"][1]
            if not series:
                raise AttributeError("TrTime: no training recorded yet")
            return series[-1]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # -- reporting ------------------------------------------------------------

    def _print_current_evals(self):
        for metric in sorted(self.evals.keys()):
            if len(self.evals[metric][1]) < len(self.evals["COST"][1]):
                continue
            best = self.evals[metric][1][self.min_obj_ind]
            self.message(self.NAME, "%7s = %.4e" % (metric, best))
