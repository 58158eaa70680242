"""MCMC convergence diagnostics: rank-normalized split-R-hat and bulk/tail
effective sample size (Vehtari, Gelman, Simpson, Carpenter, Burkner 2021,
"Rank-normalization, folding, and localization: an improved R-hat for
assessing convergence of MCMC").

A copy of ``scfgp_tpu/bayes/diagnostics.py:20-261``, which is NumPy only:
the port keeps its own so that it imports nothing of the JAX package, and
``tests/test_torch_bayes.py`` pins every function bitwise equal to the
original.  One part is rewritten, with the same results: the average
ranks of ``_rank_normalize`` are taken for all columns at once
(``_average_ranks``), not in a Python loop over each sorted column.
Diagnostics are a one-shot pass over the (draws, chains, P) draws read
back to the host for ``SCFGP.thetas``; ``SCFGP.fit_bayes`` scores every
sampler by them and warns when ``max R-hat > 1.05``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = [
    "split_rhat", "ess_bulk", "ess_tail", "ess_mean", "diagnose",
    "Diagnostics",
]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(T, C, ...) -> (T//2, 2C, ...): each chain split into halves.

    Splitting catches non-stationarity (e.g. a slow trend) that whole-chain
    R-hat misses; an odd leading draw is dropped (Stan convention)."""
    t = (x.shape[0] // 2) * 2
    half = t // 2
    return np.concatenate([x[:half], x[half:t]], axis=1)


def _average_ranks(cols: np.ndarray) -> np.ndarray:
    """1-based ranks of each column of ``cols`` (S, K), ties averaged.

    The original ranks one column at a time and walks each sorted column
    in a Python loop to average its ties (``diagnostics.py:44-66``), about
    a minute for 9,600 draws of a 1163-dimensional posterior.  This is the
    same per column at once: the same stable sort, and each run of equal
    sorted values given the mean of its positions, ``(first + last) / 2 +
    1``, which is what the original's ``mean`` of consecutive integers
    gives exactly; NaN equals nothing, so each NaN is its own run there and
    here."""
    rows = np.ascontiguousarray(cols.T)  # one series a row: faster sorts
    s = rows.shape[1]
    order = np.argsort(rows, axis=1, kind="mergesort")
    sv = np.take_along_axis(rows, order, axis=1)
    idx = np.broadcast_to(np.arange(s), rows.shape)
    starts = np.ones(rows.shape, dtype=bool)
    starts[:, 1:] = sv[:, 1:] != sv[:, :-1]
    ends = np.ones(rows.shape, dtype=bool)
    ends[:, :-1] = starts[:, 1:]
    first = np.maximum.accumulate(np.where(starts, idx, 0), axis=1)
    last = np.minimum.accumulate(np.where(ends, idx, s - 1)[:, ::-1],
                                 axis=1)[:, ::-1]
    ranks = np.empty(rows.shape, dtype=np.float64)
    np.put_along_axis(ranks, order, (first + last) / 2.0 + 1.0, axis=1)
    return ranks.T


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional-rank -> standard-normal transform over ALL draws jointly.

    Ranks use averaged ties; the offset 3/8 follows Blom's approximation
    (the paper's eq. 14: z = Phi^-1((r - 3/8) / (S + 1/4)))."""
    shape = x.shape
    flat = x.reshape(-1, *shape[2:]) if x.ndim > 2 else x.reshape(-1)
    s = flat.shape[0]
    ranks = _average_ranks(flat.reshape(s, -1)).reshape(flat.shape)
    from scipy.stats import norm
    z = norm.ppf((ranks - 0.375) / (s + 0.25))
    return z.reshape(shape)


def _rhat_basic(x: np.ndarray) -> np.ndarray:
    """Classic split-R-hat on (T, C, P) draws (already split/normalized).

    sqrt(var_plus / W) with var_plus = (T-1)/T W + B/T."""
    t, c = x.shape[0], x.shape[1]
    chain_mean = x.mean(axis=0)                       # (C, P)
    chain_var = x.var(axis=0, ddof=1)                 # (C, P)
    w = chain_var.mean(axis=0)                        # (P,)
    b = t * chain_mean.var(axis=0, ddof=1)            # (P,)
    var_plus = (t - 1) / t * w + b / t
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / w)
    # constant chains (w == 0): converged by definition
    return np.where(w > 0, rhat, 1.0)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat per parameter.

    ``samples``: (T, C, P) (or (T, C)).  Returns (P,) (or scalar): the max
    of bulk R-hat (rank-normalized draws) and tail R-hat (rank-normalized
    folded draws |x - median|), per the paper's recommendation.
    Values <= 1.01 indicate convergence; > 1.05 is a failure."""
    x = np.asarray(samples, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    xs = _split_chains(x)
    bulk = _rhat_basic(_rank_normalize(xs))
    folded = np.abs(xs - np.median(xs, axis=(0, 1), keepdims=True))
    tail = _rhat_basic(_rank_normalize(folded))
    out = np.maximum(bulk, tail)
    return out[0] if squeeze else out


def _ess_from_draws(x: np.ndarray) -> np.ndarray:
    """ESS of (T, C, P) draws via multi-chain autocovariance with Geyer's
    initial monotone positive sequence truncation (the paper's S-hat,
    eq. 10; matches Stan's ess computation)."""
    t, c = x.shape[0], x.shape[1]
    if t < 4:
        return np.full(x.shape[2:], np.nan)
    # per-chain autocovariance via FFT (biased, /T — Stan convention)
    xc = x - x.mean(axis=0, keepdims=True)
    n_fft = int(2 ** np.ceil(np.log2(2 * t)))
    f = np.fft.rfft(xc, n=n_fft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=0)[:t].real / t
    chain_var = acov[0] * t / (t - 1.0)               # (C, P) unbiased
    w = chain_var.mean(axis=0)                        # (P,)
    mean_acov = acov.mean(axis=1)                     # (T, P)
    if c > 1:
        b_over_t = x.mean(axis=0).var(axis=0, ddof=1)  # (P,)
        var_plus = (t - 1) / t * w + b_over_t
    else:
        var_plus = (t - 1) / t * w
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (w[None, :] - mean_acov) / var_plus[None, :]  # (T, P)
    rho = np.nan_to_num(rho, nan=0.0)

    # Geyer: pair sums P_k = rho_{2k} + rho_{2k+1}; truncate at the first
    # negative pair; enforce monotone non-increasing pair sums.
    t_even = (t // 2) * 2
    pairs = rho[:t_even].reshape(t_even // 2, 2, -1).sum(axis=1)  # (K, P)
    pos = pairs > 0
    # first k with non-positive pair (always stop at k=0's rho_0+rho_1 > 0)
    first_neg = np.where(pos.all(axis=0), pairs.shape[0],
                         np.argmin(pos, axis=0))
    k_idx = np.arange(pairs.shape[0])[:, None]
    keep = k_idx < first_neg[None, :]
    mono = np.minimum.accumulate(np.where(keep, pairs, np.inf), axis=0)
    mono = np.where(keep, mono, 0.0)  # zero beyond truncation (min.accumulate
    # would otherwise carry the last kept value forward)
    tau = np.maximum(-1.0 + 2.0 * mono.sum(axis=0), 1.0 / np.log10(t + 10.0))
    ess = c * t / tau
    # cap: antithetic chains can post ESS > draws; Stan caps at S log10(S)
    total = c * t
    ess = np.minimum(ess, total * np.log10(max(total, 10)))
    return np.where(w > 0, ess, total)


def ess_mean(samples: np.ndarray) -> np.ndarray:
    """Plain (non-rank-normalized) ESS of the mean estimator, per param."""
    x = np.asarray(samples, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    out = _ess_from_draws(_split_chains(x))
    return out[0] if squeeze else out


def ess_bulk(samples: np.ndarray) -> np.ndarray:
    """Bulk ESS: ESS of the rank-normalized split draws (paper sec. 4.1)."""
    x = np.asarray(samples, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    out = _ess_from_draws(_rank_normalize(_split_chains(x)))
    return out[0] if squeeze else out


def ess_tail(samples: np.ndarray) -> np.ndarray:
    """Tail ESS: min of the ESS of the 5%- and 95%-quantile indicator
    functions (paper sec. 4.3) — sensitivity of interval estimates."""
    x = np.asarray(samples, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    xs = _split_chains(x)
    q05, q95 = np.quantile(xs, [0.05, 0.95], axis=(0, 1))
    lo = _ess_from_draws((xs <= q05[None, None]).astype(np.float64))
    hi = _ess_from_draws((xs <= q95[None, None]).astype(np.float64))
    out = np.minimum(lo, hi)
    return out[0] if squeeze else out


class Diagnostics(NamedTuple):
    """Per-parameter convergence scores + scalar summaries."""

    rhat: np.ndarray           # (P,) rank-normalized split-R-hat
    ess_bulk: np.ndarray       # (P,)
    ess_tail: np.ndarray       # (P,)
    max_rhat: float
    min_ess_bulk: float
    min_ess_tail: float
    num_draws: int             # total draws T*C
    divergences: int           # count over the sampling phase (-1 = unknown)
    # Function-space scores (R-hat/ESS of the per-draw log density): the
    # SCFGP posterior is invariant under feature sign flips/permutations
    # (Phi's cos/sin pairs), so chains exploring symmetric images of the
    # same region show coordinate R-hat >> 1 while every predictive
    # quantity has mixed.  The log density is symmetry-invariant —
    # coordinate R-hat high + log-density R-hat ~ 1 reads "symmetric or
    # equal-density basins", not "stuck chains".  nan when the sampler
    # provided no log densities.
    rhat_logdensity: float = float("nan")
    ess_bulk_logdensity: float = float("nan")

    @property
    def converged(self) -> bool:
        return bool(self.max_rhat <= 1.05)

    def summary(self) -> str:
        fs = ("" if not np.isfinite(self.rhat_logdensity) else
              " rhat_logdens=%.4f ess_logdens=%.1f" % (
                  self.rhat_logdensity, self.ess_bulk_logdensity))
        return ("max_rhat=%.4f min_ess_bulk=%.1f min_ess_tail=%.1f "
                "draws=%d divergences=%s%s" % (
                    self.max_rhat, self.min_ess_bulk, self.min_ess_tail,
                    self.num_draws,
                    self.divergences if self.divergences >= 0 else "n/a",
                    fs))


def diagnose(samples, divergences: Optional[int] = None,
             logdensities=None) -> Diagnostics:
    """Full diagnostic pass over (T, C, P) draws (any array-like).

    Use ``min_ess_bulk / wall_seconds`` as the honest throughput metric
    (ESS/s); divergences, when the sampler reports them, count transitions
    whose energy error exceeded the divergence threshold during sampling.
    ``logdensities`` (T, C), when given, adds the symmetry-invariant
    function-space scores (see ``Diagnostics.rhat_logdensity``)."""
    x = np.asarray(samples, np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.ndim != 3:
        raise ValueError(f"expected (draws, chains, P) samples, got {x.shape}")
    rh = split_rhat(x)
    eb = ess_bulk(x)
    et = ess_tail(x)
    rh_ld, ess_ld = float("nan"), float("nan")
    if logdensities is not None:
        ld = np.asarray(logdensities, np.float64)
        if ld.ndim == 2 and ld.shape[0] >= 4:
            rh_ld = float(split_rhat(ld[:, :, None])[0])
            ess_ld = float(ess_bulk(ld[:, :, None])[0])
    return Diagnostics(
        rhat=rh, ess_bulk=eb, ess_tail=et,
        max_rhat=float(np.nanmax(rh)),
        min_ess_bulk=float(np.nanmin(eb)),
        min_ess_tail=float(np.nanmin(et)),
        num_draws=int(x.shape[0] * x.shape[1]),
        divergences=int(divergences) if divergences is not None else -1,
        rhat_logdensity=rh_ld, ess_bulk_logdensity=ess_ld)
