"""Streaming training: the step of ``experiments/tpu_streaming_1m.py``.

One unit is one optimizer step over all of the cell's rows: the port's
``ops/streaming.py::loss_and_grad_streaming`` (pass 1's statistics, the
posterior solve, pass 2's expected NLL, all in blocks), then adam
(``opt/optimizers.py::make_optimizer``, Nesterov 0.9) and ``tree_add``.

Set-up makes X and y on the device from the seed, draws the
hyperparameters, builds the step with its optimizer state and takes its
first ``warm_steps`` steps through the same call the window drives.  The
reference follows the first three from the same start
(``check.training_numbers``).
"""

from __future__ import annotations

import torch

from .. import traffic as tr
from ..check import training_numbers
from ..reference import scfgp as ref
from ..work import model_flops

REFERENCE_STEPS = 3


class Session:
    def __init__(self, ctx):
        from scfgp_tpu_torch.models.params import SCFGPParams
        from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
        from scfgp_tpu_torch.opt.optimizers import make_optimizer, tree_add

        cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
        self.n, self.d = cfg["n_rows"], cfg["input_dim"]
        self.s, self.m = cfg["sparsity"], cfg["nfeats"]
        self.block = mix["block_size"]
        self.lr, self.beta2 = mix["learning_rate"], mix["beta2"]
        self.fault = ctx.fault
        self.X, self.y = tr.synthetic_rows(self.n, self.d, ctx.seed, dev)
        self.p0 = tr.init_params(self.d, self.s, self.m, ctx.seed, dev)
        # The program's feed: all rows, or half of them for the planted
        # fault (the mean then taken over the rest).
        rows = self.n // 2 if self.fault == "half" else self.n
        Xf, yf = self.X[:rows], self.y[:rows]
        tx = make_optimizer("adam", {"learning_rate": self.lr,
                                     "beta2": self.beta2})
        kw = dict(stats_impl=mix["stats_impl"], block_size=self.block,
                  mm_precision=cfg["mm_precision"])

        def step(p, state):
            (cost, _), grads = loss_and_grad_streaming(p, Xf, yf, **kw)
            delta, state = tx.update(grads, state, p)
            if self.fault != "frozen":
                p = tree_add(p, delta)
            return p, state, cost

        self._step = step
        self.p = SCFGPParams(*self.p0)
        self.state = tx.init(self.p)
        self.costs, self.g1, self.p3 = [], None, None
        for i in range(mix["warm_steps"]):
            self.p, self.state, c = step(self.p, self.state)
            self.costs.append(c)
            if i == 0:
                # adam's first moment after one step is (1 - beta1) g.
                self.g1 = [m / (1 - 0.9) for m in self.state.inner.m]
            if i + 1 == REFERENCE_STEPS:
                self.p3 = list(self.p)
        self.window_costs = []
        self.work_per_unit = self.n / 1e6  # Mrows a step
        self.steps_per_unit = 1
        self.flops_per_step = model_flops(self.n, self.d, self.s, self.m)

    def unit(self):
        self.p, self.state, c = self._step(self.p, self.state)
        self.window_costs.append(c)

    def failed(self) -> int:
        if not self.window_costs:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_costs))).sum())

    def release(self):
        """Free the program's state: the reference runs after it."""
        self.p = self.state = self._step = None
        self.window_costs = []

    def _grad64(self, X, y):
        """The reference's first gradient in float64 (the mask of the
        leaves that move, ``check.moving_leaves``)."""
        return ref.cost_and_grad(tuple(t.double() for t in self.p0),
                                 X.double(), y.double(), self.block)[1]

    def _reference(self, tf32=False):
        p = tuple(t.clone() for t in self.p0)
        opt = ref.AdamNesterov(p, lr=self.lr, beta2=self.beta2)
        costs, g1 = [], None
        with ref.precision(tf32):
            for i in range(REFERENCE_STEPS):
                c, g = ref.cost_and_grad(p, self.X, self.y, self.block)
                costs.append(c)
                g1 = g if i == 0 else g1
                p = opt.step(p, g)
        delta = [a - b for a, b in zip(p, self.p0)]
        return costs, g1, delta

    def readings(self, detail=None) -> dict:
        costs, g1, delta = self._reference()
        prog_delta = [a - b for a, b in zip(self.p3, self.p0)]
        return training_numbers(self.costs[:REFERENCE_STEPS], costs,
                                self.g1, g1, prog_delta, delta, detail=detail,
                                mask_grad=self._grad64(self.X, self.y))

    def control_readings(self, detail=None) -> dict:
        """The reference in TF32 put in the program's place."""
        costs, g1, delta = self._reference()
        c32, g32, d32 = self._reference(tf32=True)
        return training_numbers(c32, costs, g32, g1, d32, delta,
                                detail=detail,
                                mask_grad=self._grad64(self.X, self.y))


def setup(ctx):
    return Session(ctx)
