"""Data-parallel streaming training over the cards of one host: the step
of ``stream_train`` on every rank with ``axis_name=mesh.group("data")``.

Each rank streams its own rows (``n_rows`` a card, made on its card from
the seed and its rank) and the port all-reduces pass 1's statistics, pass
2's row sums and the gradient, so every rank takes the global step.  The
ranks are spawned by the port's ``parallel/launch.py::run`` and joined
over NCCL (``run.py``).

The check: every rank ends the reference's steps with the same params and
losses as rank 0 (exactly), and rank 0's first steps follow the plain
reference over all ranks' rows together, regenerated on rank 0's card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import traffic as tr
from ..check import training_numbers
from ..reference import scfgp as ref
from ..work import model_flops
from .stream_train import REFERENCE_STEPS

ROW_STREAM = 10  # rank r's rows come from stream ROW_STREAM + r


def rank_rows(n, d, seed, rank, device):
    gen = tr.generator(seed, ROW_STREAM + rank, device)
    X = torch.rand((n, d), generator=gen, device=device)
    y = torch.randn((n,), generator=gen, device=device)
    return X, y


class Session:
    def __init__(self, ctx):
        from scfgp_tpu_torch.models.params import SCFGPParams
        from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
        from scfgp_tpu_torch.opt.optimizers import make_optimizer, tree_add
        from scfgp_tpu_torch.parallel.mesh import make_mesh

        cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
        self.n, self.d = cfg["n_rows"], cfg["input_dim"]
        self.s, self.m = cfg["sparsity"], cfg["nfeats"]
        self.block = mix["block_size"]
        self.lr, self.beta2 = mix["learning_rate"], mix["beta2"]
        self.world, self.rank = ctx.world, ctx.rank
        self.seed, self.dev = ctx.seed, dev
        mesh = make_mesh()
        group = None if ctx.fault == "exchange" else mesh.group("data")
        X, y = rank_rows(self.n, self.d, ctx.seed, self.rank, dev)
        if ctx.fault == "half":
            X, y = X[:self.n // 2], y[:self.n // 2]
        self.p0 = tr.init_params(self.d, self.s, self.m, ctx.seed, dev)
        tx = make_optimizer("adam", {"learning_rate": self.lr,
                                     "beta2": self.beta2})
        kw = dict(stats_impl=mix["stats_impl"], block_size=self.block,
                  mm_precision=cfg["mm_precision"], axis_name=group)

        def step(p, state):
            (cost, _), grads = loss_and_grad_streaming(p, X, y, **kw)
            delta, state = tx.update(grads, state, p)
            if ctx.fault != "frozen":
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
                self.g1 = [m / (1 - 0.9) for m in self.state.inner.m]
            if i + 1 == REFERENCE_STEPS:
                self.p3 = list(self.p)
        self.window_costs = []
        self.work_per_unit = self.world * self.n / 1e6  # Mrows, all ranks
        self.steps_per_unit = 1
        self.flops_per_step = model_flops(self.world * self.n, self.d,
                                          self.s, self.m)

    def unit(self):
        self.p, self.state, c = self._step(self.p, self.state)
        self.window_costs.append(c)

    def failed(self) -> int:
        if not self.window_costs:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_costs))).sum())

    def release(self):
        self.p = self.state = self._step = None
        self.window_costs = []

    def _rank_gap(self) -> float:
        """max |x_r - x_0| over ranks of the losses and params after the
        reference's steps: 0 when every rank took the same global step."""
        mine = torch.cat([torch.stack(self.costs[:REFERENCE_STEPS])]
                         + [t.reshape(-1) for t in self.p3])
        every = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(every, mine)
        return float(max((e - every[0]).abs().max() for e in every))

    def _grad64(self, X, y):
        """The reference's first gradient in float64 (the mask of the
        leaves that move, ``check.moving_leaves``)."""
        return ref.cost_and_grad(tuple(t.double() for t in self.p0),
                                 X.double(), y.double(), self.block)[1]

    def _rows(self):
        parts = [rank_rows(self.n, self.d, self.seed, r, self.dev)
                 for r in range(self.world)]
        return (torch.cat([X for X, _ in parts]),
                torch.cat([y for _, y in parts]))

    def _reference(self, tf32=False):
        X, y = self._rows()
        p = tuple(t.clone() for t in self.p0)
        opt = ref.AdamNesterov(p, lr=self.lr, beta2=self.beta2)
        costs, g1 = [], None
        with ref.precision(tf32):
            for i in range(REFERENCE_STEPS):
                c, g = ref.cost_and_grad(p, X, y, self.block)
                costs.append(c)
                g1 = g if i == 0 else g1
                p = opt.step(p, g)
        return costs, g1, [a - b for a, b in zip(p, self.p0)]

    def readings(self, detail=None) -> dict:
        rank_gap = self._rank_gap()
        if self.rank != 0:
            return {"rank_gap": rank_gap}
        costs, g1, delta = self._reference()
        out = training_numbers(
            self.costs[:REFERENCE_STEPS], costs, self.g1, g1,
            [a - b for a, b in zip(self.p3, self.p0)], delta, detail=detail,
            mask_grad=self._grad64(*self._rows()))
        out["rank_gap"] = rank_gap
        return out

    def control_readings(self, detail=None) -> dict:
        if self.rank != 0:
            return {}
        costs, g1, delta = self._reference()
        c32, g32, d32 = self._reference(tf32=True)
        out = training_numbers(c32, costs, g32, g1, d32, delta,
                               detail=detail,
                               mask_grad=self._grad64(*self._rows()))
        out["rank_gap"] = 0.0
        return out


def setup(ctx):
    return Session(ctx)
