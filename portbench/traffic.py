"""Traffic generators: every input of a run, made from ``--seed``.

A traffic mix is a data file of parameters (``workloads/<cell>.json``,
key ``traffic``); the generators here read it.  Nothing here imports the
port: the benchmark makes the inputs and hands the same to the program and
to the reference.

- ``synthetic_rows`` is a frozen copy of the data half of
  ``scfgp_tpu_torch/experiments/sgld_scale.py::problem``: X uniform and y
  standard normal, made on the device by a ``torch.Generator`` there.
- ``init_params`` draws the SCFGP hyperparameters with the reference's
  distributions (a, b, c, l_F ~ N(0, 1); r_F ~ U(0, 1); phases ~ U(0, 2π)),
  on the device, in one call a leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MOD = 2 ** 62  # seeds above 32 bits are folded, never refused


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed, so
    that data, params and noise never share draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % SEED_MOD)
    return g


def synthetic_rows(n: int, d: int, seed: int, device):
    """X (n, d) uniform on [0, 1) and y (n,) standard normal, on
    ``device``: the cost of a step does not depend on the values."""
    gen = generator(seed, 1, device)
    X = torch.rand((n, d), generator=gen, device=device)
    y = torch.randn((n,), generator=gen, device=device)
    return X, y


def init_params(d: int, s: int, m: int, seed: int, device, trials=None,
                stream: int = 2):
    """A tuple of the seven leaves (a, b, c, l_F, r_F, l_phase, phase),
    each with a leading ``trials`` axis when it is given."""
    gen = generator(seed, stream, device)
    lead = () if trials is None else (trials,)
    g = dict(generator=gen, device=device, dtype=torch.float32)
    two_pi = 2.0 * math.pi
    return (torch.randn(lead, **g), torch.randn(lead, **g),
            torch.randn(lead, **g), torch.randn(lead + (d, s), **g),
            torch.rand(lead + (m, s), **g),
            two_pi * torch.rand(lead + (s,), **g),
            two_pi * torch.rand(lead + (m,), **g))


def chain_positions(d: int, s: int, m: int, chains: int, seed: int, device):
    """(chains, 3 + d s + m s) initial positions of a sampler in the
    reduced layout [a, b, c, l_F, r_F] (the phases pinned at zero)."""
    a, b, c, l_F, r_F, _, _ = init_params(d, s, m, seed, device,
                                          trials=chains)
    return torch.cat([a[:, None], b[:, None], c[:, None],
                      l_F.reshape(chains, -1), r_F.reshape(chains, -1)],
                     dim=1).contiguous()


def sample_indices(count: int, k: int, seed: int) -> list:
    """``k`` distinct indices of ``range(count)`` drawn from the seed,
    sorted, always with the last (the longest-running) in them."""
    if count <= 0:
        return []
    rs = np.random.RandomState(int(seed) % (2 ** 32))
    pick = set(rs.choice(count, size=min(k, count), replace=False).tolist())
    pick.add(count - 1)
    return sorted(pick)
