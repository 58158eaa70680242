"""Plain PyTorch reference of the SCFGP objective, its gradient, the
optimizer step and the Langevin log posterior.

Written from the model's equations (the reference Theano graph,
``SCFGP/SCFGP.py:92-148``) in float32 with no kernel, no cache and nothing
of the program under test: autograd takes the gradient, torch's own
Cholesky and triangular solve factor the 2K x 2K system, and the streaming
form sums the same row sums over blocks of rows under
``torch.utils.checkpoint``, so that it fits beside a million rows.

Params are the tuple ``(a, b, c, l_F, r_F, l_phase, phase)``; every leaf
may carry a leading trial axis B, and X may be (n, D), shared by the
trials, or (B, n, D).  TF32 is off unless ``precision(tf32=True)`` turns
it on (the control's arithmetic).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

EPSILON = 1e-6  # jitter added to the noise variance (SCFGP.py:93,105)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matrix products in IEEE float32, or in TF32 for the control."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def _col(t, dims):
    """A per-trial value () or (B,) shaped to broadcast over ``dims``
    trailing axes."""
    return t.reshape(t.shape + (1,) * dims)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def features(p, X):
    """Φ = sig_f sqrt(2/M) [cos T, sin T], T = X [l_F | l_F r_Fᵀ] + the
    mean-centred phases (SCFGP.py:83-102)."""
    a, b, c, l_F, r_F, l_phase, phase = p
    M = r_F.shape[-2]
    F = l_F @ r_F.mT
    Fcat = torch.cat([l_F, F], dim=-1)
    pcat = torch.cat([l_phase - l_F.mean(dim=-2), phase - F.mean(dim=-2)],
                     dim=-1)
    T = X @ Fcat + pcat.unsqueeze(-2)
    scale = torch.exp(b) * math.sqrt(2.0 / M)
    return _col(scale, 2) * torch.cat([torch.cos(T), torch.sin(T)], dim=-1)


def kl_penalty(p):
    """The KL-style regulariser on the frequencies (SCFGP.py:94,114-127)."""
    _, _, _, l_F, r_F, _, _ = p
    S, M = l_F.shape[-1], r_F.shape[-2]
    F = l_F @ r_F.mT

    def kl(mu, sig):
        return sig + mu * mu - torch.log(sig)

    mu_l = l_F.mean(dim=-1).sum(dim=-1)
    sig_l = l_F.std(dim=-1, correction=0).sum(dim=-1)
    mu_w = F.mean(dim=-1).sum(dim=-1)
    sig_w = F.std(dim=-1, correction=0).sum(dim=-1)
    return (kl(mu_w, sig_w) * M + kl(mu_l, sig_l) * S) / (S + M)


def _blocks(X, y, block):
    n = X.shape[-2]
    step = n if not block else block
    return [(X[..., i:i + step, :], y[..., i:i + step])
            for i in range(0, n, step)]


def _maybe_checkpoint(fn, *args, on):
    if on:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def cost(p, X, y, block=0, residual=False):
    """The objective (nlml + penalty) / n, one value a trial: dense, or
    over blocks of ``block`` rows in two passes (the statistics, then the
    expected NLL).  ``residual`` takes the data fit from the residuals,
    as the log posterior does."""
    a, _, c, _, r_F, _, _ = p
    M = r_F.shape[-2]
    on = bool(block)
    parts = _blocks(X, y, block)

    def stats_of(Xb, yb):
        Phi = features(p, Xb)
        yb = yb.expand(Phi.shape[:-1])
        return (Phi.mT @ Phi, (Phi.mT @ yb.unsqueeze(-1)).squeeze(-1),
                (yb * yb).sum(dim=-1))

    G = Py = yy = 0.0
    for Xb, yb in parts:
        g, py, s = _maybe_checkpoint(stats_of, Xb, yb, on=on)
        G, Py, yy = G + g, Py + py, yy + s
    n = float(X.shape[-2])
    sig2 = torch.exp(2.0 * a)
    noise = softplus(c)
    w = G.shape[-1]
    eye = torch.eye(w, dtype=G.dtype, device=G.device)
    L = torch.linalg.cholesky(G + _col(sig2 + EPSILON, 2) * eye)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    beta = (Li @ Py.unsqueeze(-1)).squeeze(-1)
    alpha = (Li.mT @ beta.unsqueeze(-1)).squeeze(-1)

    def enll_of(Xb, yb):
        Phi = features(p, Xb)
        yb = yb.expand(Phi.shape[:-1])
        mu = (Phi @ alpha.unsqueeze(-1)).squeeze(-1)
        PL = Phi @ Li.mT
        var = (PL * PL).sum(dim=-1)
        dsp = _col(noise, 1) * (var + 1.0)
        r = mu - yb
        e = (0.5 * r * r + 0.5 * var) / dsp + 0.5 * torch.log(
            2.0 * math.pi * dsp)
        return e.sum(dim=-1), (r * r).sum(dim=-1)

    enll = r2 = 0.0
    for Xb, yb in parts:
        e, rr = _maybe_checkpoint(enll_of, Xb, yb, on=on)
        enll, r2 = enll + e, r2 + rr
    if residual:
        fit = r2 + (sig2 + EPSILON) * (alpha * alpha).sum(dim=-1)
    else:
        fit = yy - (beta * beta).sum(dim=-1)
    nlml = (2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)
            + 2.0 * enll + fit / sig2 + 2.0 * (n - M) * a)
    return (nlml + kl_penalty(p)) / n


def cost_and_grad(p, X, y, block=0):
    """(cost, grads): the cost of each trial and the gradient of each
    trial's own cost, leaf by leaf."""
    leaves = tuple(t.detach().clone().requires_grad_() for t in p)
    with torch.enable_grad():
        c = cost(leaves, X, y, block)
        grads = torch.autograd.grad(c.sum(), leaves)
    return c.detach(), tuple(g.detach() for g in grads)


def unpack_reduced(q, D, S, M):
    """[a, b, c, l_F, r_F] (C, P) to params with the phases at zero."""
    C = q.shape[0]
    i = 3 + D * S
    zeros = q.new_zeros
    return (q[:, 0], q[:, 1], q[:, 2], q[:, 3:i].reshape(C, D, S),
            q[:, i:i + M * S].reshape(C, M, S), zeros((C, S)),
            zeros((C, M)))


def logpost_and_grad(q, X, y, D, S, M, block=0):
    """log p(θ | data) = -n/2 · cost (residual data fit) at each chain's
    position q (C, P), and its gradient (C, P)."""
    n = float(X.shape[-2])
    q = q.detach().clone().requires_grad_()
    with torch.enable_grad():
        lp = -0.5 * n * cost(unpack_reduced(q, D, S, M), X, y, block,
                             residual=True)
        g, = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), g.detach()


class AdamNesterov:
    """Adam with the reference's epsilon placement and its step count in
    float32 (Optimizer.py:278-331), inside Nesterov momentum 0.9
    (Optimizer.py:62-97, SCFGP.py:130-131), leaf by leaf."""

    def __init__(self, params, lr=0.01, beta1=0.9, beta2=0.99, eps=1e-8,
                 momentum=0.9):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.mom = momentum
        self.t = torch.zeros((), dtype=torch.float32,
                             device=params[0].device)
        self.m = [torch.zeros_like(t) for t in params]
        self.v = [torch.zeros_like(t) for t in params]
        self.vel = [torch.zeros_like(t) for t in params]

    def step(self, params, grads):
        self.t = self.t + 1.0
        a_t = self.lr * torch.sqrt(1.0 - self.b2 ** self.t) / (
            1.0 - self.b1 ** self.t)
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = self.b1 * self.m[i] + (1 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1 - self.b2) * g * g
            delta = -(a_t * self.m[i] / (torch.sqrt(self.v[i]) + self.eps))
            self.vel[i] = self.mom * self.vel[i] + delta
            out.append(p + (self.mom * self.vel[i] + delta))
        return tuple(out)
