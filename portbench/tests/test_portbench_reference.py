"""The plain reference agrees with the port's plain CPU path at a tiny
size: the objective and its gradient dense, in blocks and with a trial
axis; the Langevin log posterior; the optimizer step."""

import pytest
import torch

from portbench import traffic as tr
from portbench.reference import scfgp as ref
from scfgp_tpu_torch.bayes.predictive import (batched_value_and_grad,
                                              make_logposterior)
from scfgp_tpu_torch.models.objective import loss_and_grad
from scfgp_tpu_torch.models.params import SCFGPParams
from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
from scfgp_tpu_torch.opt.optimizers import make_optimizer, tree_add

D, S, M, N = 5, 3, 7, 700
CPU = torch.device("cpu")


def problem(seed, trials=None):
    X, y = tr.synthetic_rows(N, D, seed, CPU)
    p = tr.init_params(D, S, M, seed, CPU, trials=trials)
    p = (0.3 * p[0],) + p[1:3] + (0.3 * p[3],) + p[4:]
    return X.double(), y.double(), tuple(t.double() for t in p)


def close(a, b, tol=1e-9):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("block", [0, 128])
def test_cost_and_grad_match_the_port(block):
    X, y, p = problem(1)
    c, g = ref.cost_and_grad(p, X, y, block)
    if block:
        (pc, _), pg = loss_and_grad_streaming(SCFGPParams(*p), X, y,
                                              block_size=block)
    else:
        (pc, _), pg = loss_and_grad(SCFGPParams(*p), X, y)
    close(c, pc)
    for a, b in zip(g, pg):
        close(a, b)


def test_trial_axis_matches_the_port():
    X, y, p = problem(2, trials=3)
    Xb, yb = X.expand(3, -1, -1).contiguous(), y.expand(3, -1).contiguous()
    c, g = ref.cost_and_grad(p, Xb, yb)
    (pc, _), pg = loss_and_grad(SCFGPParams(*p), Xb, yb)
    close(c, pc)
    for a, b in zip(g, pg):
        close(a, b)


@pytest.mark.parametrize("block", [0, 200])
def test_logpost_matches_the_port(block):
    X, y, _ = problem(3)
    q = tr.chain_positions(D, S, M, 4, 3, CPU).double()
    q[:, 0] *= 0.3
    lp, g = ref.logpost_and_grad(q, X, y, D, S, M, block)
    plp, pg = batched_value_and_grad(make_logposterior(
        X, y, D, S, M, streaming_block=block))(q)
    close(lp, plp)
    close(g, pg)


def test_adam_nesterov_matches_the_port():
    _, _, p = problem(4)
    tx = make_optimizer("adam", {"learning_rate": 0.01, "beta2": 0.99})
    state, pp = tx.init(SCFGPParams(*p)), SCFGPParams(*p)
    opt, rp = ref.AdamNesterov(p, lr=0.01, beta2=0.99), p
    for k in range(4):
        g = tuple(torch.sin(t * (k + 1.0)) for t in p)
        delta, state = tx.update(SCFGPParams(*g), state, pp)
        pp = tree_add(pp, delta)
        rp = opt.step(rp, g)
    for a, b in zip(rp, pp):
        close(a, b, 1e-12)
