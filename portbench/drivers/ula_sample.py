"""Full-batch Langevin sampling: ``experiments/sgld_scale.py``'s
``ula-streaming`` leg.

One unit is one transition of all chains: ``bayes/sgld.py::sgld_sample``
continuing its chain (``init_carry``) over
``make_minibatch_value_and_grad(X, y, D, S, M, 0, streaming_block=...)``,
whose gradient is one streaming log posterior of all chains, the chains as
its trial axis.  Set-up makes X, y and the chains' start on the device
from the seed and takes the warm-up transitions.

The sampler draws its noise from a generator the benchmark seeds, one
(chains, P) normal a transition; the reference draws the same from a
generator seeded alike.  After the window a sample of the window's
transitions, drawn from the seed with the last among them, is checked:
the log density and gradient at the position the chain stepped from, the
preconditioner's update, and the move.  The reference follows the
sampler from the program's own position and metric at each sampled
transition (``PERF.md``).
"""

from __future__ import annotations

import torch

from .. import traffic as tr
from ..check import rel_gap
from ..reference import scfgp as ref
from ..work import model_flops

NOISE_STREAM = 3


def _leaves(d: int, s: int, m: int) -> list:
    """The slices of a position [a, b, c, l_F, r_F] that are leaves."""
    i = 3 + d * s
    return [slice(0, 1), slice(1, 2), slice(2, 3), slice(3, i),
            slice(i, i + m * s)]


def leaf_gap(prog, want, leaves) -> float:
    """The worst chain's worst leaf: ‖prog - want‖ of the leaf against
    the larger of ‖want‖ of the leaf and of the chain's median leaf."""
    prog, want = prog.double(), want.double()
    if prog.dim() == 1:
        prog, want = prog[None], want[None]
    diff = torch.stack([(prog[:, sl] - want[:, sl]).norm(dim=1)
                        for sl in leaves], dim=1)
    norm = torch.stack([want[:, sl].norm(dim=1) for sl in leaves], dim=1)
    floor = torch.maximum(norm, norm.median(dim=1, keepdim=True).values)
    return float((diff / floor.clamp_min(1e-30)).max())


class Session:
    def __init__(self, ctx):
        from scfgp_tpu_torch.bayes.sgld import (make_minibatch_value_and_grad,
                                                sgld_sample)

        cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
        self.n, self.d = cfg["n_rows"], cfg["input_dim"]
        self.s, self.m = cfg["sparsity"], cfg["nfeats"]
        self.block = mix["block_size"]
        self.chains = mix["chains"]
        self.eps, self.warm = mix["step_size"], mix["warmup"]
        self.alpha, self.lam = mix["precond_alpha"], mix["precond_lambda"]
        self.fault, self.seed, self.dev = ctx.fault, ctx.seed, dev
        self.checked = mix["checked_transitions"]
        self.leaves = _leaves(self.d, self.s, self.m)
        self.X, self.y = tr.synthetic_rows(self.n, self.d, ctx.seed, dev)
        q0 = tr.chain_positions(self.d, self.s, self.m, self.chains,
                                ctx.seed, dev)
        rows = self.n // 2 if self.fault == "half" else self.n
        vg = make_minibatch_value_and_grad(
            self.X[:rows], self.y[:rows], self.d, self.s, self.m, 0,
            streaming_block=self.block, mm_precision=cfg["mm_precision"])
        self.trail = []  # (q, v, value, grad) a transition, then q', v'
        last = {}

        def recorded(q, rows_):
            vals, grads = vg(q, rows_)
            last["vg"] = (vals, grads)
            return vals, grads

        self.gen = tr.generator(ctx.seed, NOISE_STREAM, dev)
        kw = dict(step_size=self.eps, precond_alpha=self.alpha,
                  precond_lambda=self.lam)

        def transition(carry, warm=0):
            res = sgld_sample(recorded, q0, self.gen, num_warmup=warm,
                              num_samples=1, init_carry=carry, **kw)
            new = res.final_carry
            if self.fault == "frozen":
                new = (carry[0],) + tuple(new[1:])
            return new

        self._transition = transition
        self._sample = sgld_sample
        # Warm-up: the first transition starts the chain and the
        # metric; the rest are the warm-up the sampler is run with.
        self.carry = self._sample(recorded, q0, self.gen, num_warmup=0,
                                  num_samples=1, **kw).final_carry
        for _ in range(self.warm - 1):
            self.carry = transition(self.carry)
        self._last = last
        self.bad0 = int(self.carry[3])
        self.work_per_unit = float(self.chains)  # draws a transition
        self.steps_per_unit = 1
        self.flops_per_step = model_flops(self.n, self.d, self.s, self.m,
                                          trials=self.chains)

    def unit(self):
        before = self.carry
        self.carry = self._transition(before)
        vals, grads = self._last["vg"]
        self.trail.append((before[0], before[1], vals, grads,
                           self.carry[0], self.carry[1]))

    def failed(self) -> int:
        return int(self.carry[3]) - self.bad0

    def release(self):
        self._transition = self._sample = None
        self._last = {}

    def _noise(self):
        """The sampler's normals, one (chains, P) a transition from its
        first, regenerated from the seed."""
        gen = tr.generator(self.seed, NOISE_STREAM, self.dev)
        P = self.trail[0][0].shape[1] if self.trail else 0
        while True:
            yield torch.randn((self.chains, P), generator=gen,
                              device=self.dev)

    def _follow(self, q, v, g, xi):
        """One transition of the reference from (q, v) with gradient g."""
        ok = torch.isfinite(g).all(dim=1)
        g2 = torch.where(ok[:, None], g * g, torch.zeros_like(g))
        n_ok = ok.sum().to(g.dtype)
        v_new = self.alpha * v + (1.0 - self.alpha) * g2.sum(dim=0) / (
            n_ok.clamp_min(1.0))
        v_new = torch.where(n_ok > 0, v_new, v)
        G = 1.0 / (self.lam + torch.sqrt(v_new))[None, :]
        q_new = q + 0.5 * self.eps * G * g + torch.sqrt(self.eps * G) * xi
        return q_new, v_new

    def _numbers(self, tf32=False, against_program=True):
        picks = tr.sample_indices(len(self.trail), self.checked, self.seed)
        noise = self._noise()
        first = self.warm  # transitions before the window
        xis = {}
        for i in range(first + len(self.trail)):
            xi = next(noise)
            j = i - first
            if j in picks:
                xis[j] = xi
        out = {"logp_gap": 0.0, "grad_gap": 0.0, "metric_gap": 0.0,
               "move_gap": 0.0}
        for j in picks:
            q, v, vals, grads, q1, v1 = self.trail[j]
            with ref.precision(False):
                lp, g = ref.logpost_and_grad(q, self.X, self.y, self.d,
                                             self.s, self.m, self.block)
            if against_program:
                lp_p, g_p, q1_p, v1_p = vals, grads, q1, v1
            else:
                with ref.precision(tf32):
                    lp_p, g_p = ref.logpost_and_grad(
                        q, self.X, self.y, self.d, self.s, self.m,
                        self.block)
                q1_p, v1_p = self._follow(q, v, g_p, xis[j])
            q_want, v_want = self._follow(q, v, g, xis[j])
            out["logp_gap"] = max(out["logp_gap"], rel_gap(lp_p, lp))
            out["grad_gap"] = max(out["grad_gap"],
                                  leaf_gap(g_p, g, self.leaves))
            out["metric_gap"] = max(out["metric_gap"],
                                    leaf_gap(v1_p, v_want, self.leaves))
            out["move_gap"] = max(out["move_gap"],
                                  leaf_gap(q1_p - q, q_want - q, self.leaves))
        return out

    def readings(self) -> dict:
        return self._numbers()

    def control_readings(self) -> dict:
        """The reference in TF32 put in the program's place, at the
        positions the program visited."""
        return self._numbers(tf32=True, against_program=False)


def setup(ctx):
    return Session(ctx)
