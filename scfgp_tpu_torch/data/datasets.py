"""Dataset loaders (boston, abalone, kin8nm, co2), the surrogates' Bayes
floors, and the scaling synthetics.

A NumPy-only carry of ``scfgp_tpu/data/datasets.py:43-582`` (the split, the
real-file sniffing, the deterministic synthetic surrogates and their floor
oracles) and of its synthetics ``synthetic_gp_rff`` and ``synthetic_large``
(``:584-610``), so the port loads the same rows and measures the same
floors as the JAX package without importing it.  Each loader:

1. loads a real file from ``experiments/data/`` if one is present (schemas
   below), else
2. generates the deterministic synthetic surrogate of the JAX package,
   reported via ``meta["source"]``.

All loaders return ``(X_train, y_train, X_valid, y_valid, meta)`` with the
reference's split proportions and take a ``seed`` for the split RNG
(``reference: experiments/boston_housing/boston_housing.py:80``).
``surrogate_floor`` gives the Bayes floor of a surrogate's held-out split,
the anchor of the sweeps' ``nmse_over_floor``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "experiments", "data")


def _split(X, y, prop, rng):
    """Random train/valid split, reference style (boston_housing.py:53-59)."""
    n = X.shape[0]
    train_inds = rng.choice(range(n), int(prop * n), replace=False)
    valid_inds = np.setdiff1d(range(n), train_inds)
    return (X[train_inds].copy(), y[train_inds].copy(),
            X[valid_inds].copy(), y[valid_inds].copy())


# -- real-data ingestion ------------------------------------------------------
#
# Accepted on-disk schemas (drop any of these into ``experiments/data/`` and
# the loaders use them instead of the surrogate; ``meta["source"] == "real"``):
#
#   boston   boston.csv | boston.data | housing.data | housing.csv
#            14 numeric columns (CRIM..LSTAT, MEDV last), comma- or
#            whitespace-separated, optional header row.  This is the classic
#            UCI/StatLib ``housing.data`` layout that sklearn's removed
#            ``load_boston`` wrapped (reference:
#            experiments/boston_housing/boston_housing.py:50-60).
#   abalone  abalone.csv | abalone.data
#            UCI raw: ``Sex,Length,Diameter,Height,Whole,Shucked,Viscera,
#            Shell,Rings`` with Sex in {M,F,I}.  Sex is one-hot encoded in
#            sorted-unique order (F,I,M) exactly like the reference's
#            ``label_binarize(X_cate, np.unique(X_cate))``
#            (experiments/abalone/abalone.py:23-26), giving D=10 features and
#            y=Rings.  A pre-numericized 9-column file (sex coded 0/1/2) is
#            one-hot encoded the same way; a >=10-column numeric file is
#            assumed already encoded (last column = rings).
#   kin8nm   kin8nm.csv | kin8nm.data | dataset_2175_kin8nm.csv
#            DELVE/OpenML: 9 numeric columns (theta1..theta8, y last),
#            comma- or whitespace-separated, optional header.
#   co2      co2_mm_mlo.txt | co2_mm_mlo.csv | co2.csv | mauna_loa.csv
#            Either the NOAA monthly Mauna Loa file (comment lines start
#            with '#'; columns ``year month decimal_date average
#            [deseasonalized ...]``; missing averages coded -99.99 fall back
#            to the deseasonalized column or are dropped), or a simple
#            2-column table (time, ppm).  X is the (1-D) time coordinate and
#            y the ppm series (experiments/co2/CO2_1d_regression.py:45-58).
#
# Every parser is format-sniffing (delimiter + header detection), returns
# float64; the port's copies are held equal to the JAX package's on its
# authentic-format fixture files by tests/test_torch_serving.py.

_REAL_FILES = {
    "boston": ("boston.csv", "boston.data", "housing.data", "housing.csv"),
    "abalone": ("abalone.csv", "abalone.data"),
    "kin8nm": ("kin8nm.csv", "kin8nm.data", "dataset_2175_kin8nm.csv"),
    "co2": ("co2_mm_mlo.txt", "co2_mm_mlo.csv", "co2.csv", "mauna_loa.csv"),
}


def _find_real_file(name: str):
    # DATA_DIR is looked up through the module (not captured at import) so
    # tests can point it at fixture directories.
    for fname in _REAL_FILES[name]:
        path = os.path.join(DATA_DIR, fname)
        if os.path.exists(path):
            return path
    return None


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _parse_table(path: str):
    """Sniff delimiter/header and return a list of token rows (strings).

    Skips blank lines and comment lines ('#', '%', '"' quote-only); a first
    row containing any non-numeric token among otherwise-numeric rows is
    treated as a header and dropped (unless a column is categorically
    non-numeric in every row, like abalone's sex)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line[0] in "#%":
                continue
            toks = ([t.strip().strip('"') for t in line.split(",")]
                    if "," in line else line.split())
            toks = [t for t in toks if t != ""]
            if toks:
                rows.append(toks)
    if not rows:
        raise ValueError(f"{path}: no data rows")
    if len(rows) > 1:
        # Header heuristic: a column whose first token is non-numeric but is
        # numeric in the second row means row 0 is a header.
        for j in range(min(len(rows[0]), len(rows[1]))):
            if not _is_number(rows[0][j]) and _is_number(rows[1][j]):
                return rows[1:]
    return rows


def _numeric_block(rows, path, ncols=None):
    if ncols is None:
        ncols = len(rows[0])
    bad = [i for i, r in enumerate(rows) if len(r) != ncols]
    if bad:
        raise ValueError(
            f"{path}: row {bad[0]} has {len(rows[bad[0]])} columns, "
            f"expected {ncols}")
    return np.array([[float(t) for t in r] for r in rows], dtype=np.float64)


def _numeric_table(path: str) -> np.ndarray:
    """All-numeric table file -> float64 array, by the Python sniffing path
    (the JAX package's native parser is a fast path to the same result)."""
    return _numeric_block(_parse_table(path), path)


def _load_real_boston(path):
    """UCI housing: 14 numeric columns, MEDV (target) last."""
    arr = _numeric_table(path)
    if arr.shape[1] != 14:
        raise ValueError(
            f"{path}: boston housing needs 14 columns (13 features + MEDV), "
            f"got {arr.shape[1]}")
    return arr[:, :13], arr[:, 13]


def _load_real_abalone(path):
    """UCI abalone: string sex column one-hot in sorted order (F,I,M).

    Mirrors reference experiments/abalone/abalone.py:23-26
    (``label_binarize(X_cate, np.unique(X_cate))`` then hstack with the
    seven morphometrics); y = Rings."""
    rows = _parse_table(path)
    first = rows[0][0]
    if not _is_number(first):
        if len(rows[0]) != 9:
            raise ValueError(
                f"{path}: UCI abalone needs 9 columns (Sex + 7 numeric + "
                f"Rings), got {len(rows[0])}")
        sex = np.array([r[0] for r in rows])
        num = np.array([[float(t) for t in r[1:]] for r in rows], np.float64)
        classes = np.unique(sex)                 # sorted: F, I, M
        onehot = (sex[:, None] == classes[None, :]).astype(np.float64)
        return np.hstack([onehot, num[:, :7]]), num[:, 7]
    arr = _numeric_block(rows, path)
    if arr.shape[1] == 9:                        # sex numerically coded
        classes = np.unique(arr[:, 0])
        onehot = (arr[:, :1] == classes[None, :]).astype(np.float64)
        return np.hstack([onehot, arr[:, 1:8]]), arr[:, 8]
    return arr[:, :-1], arr[:, -1]               # already encoded


def _load_real_kin8nm(path):
    """DELVE kin-8nm: 9 numeric columns, y last."""
    arr = _numeric_table(path)
    if arr.shape[1] != 9:
        raise ValueError(
            f"{path}: kin8nm needs 9 columns (8 angles + y), "
            f"got {arr.shape[1]}")
    return arr[:, :8], arr[:, 8]


def _load_real_co2(path):
    """Mauna Loa CO2: NOAA monthly file or a simple (time, ppm) table."""
    rows = _parse_table(path)
    ncols = len(rows[0])
    if ncols >= 4:
        # NOAA co2_mm_mlo: year month decimal_date average [deseason ...]
        arr = _numeric_block(rows, path)
        t, avg = arr[:, 2], arr[:, 3]
        missing = avg <= -99.0
        if ncols >= 5:
            avg = np.where(missing, arr[:, 4], avg)
            missing = avg <= -99.0
        keep = ~missing
        return t[keep, None], avg[keep]
    if ncols == 2:
        arr = _numeric_block(rows, path)
        return arr[:, :1], arr[:, 1]
    raise ValueError(
        f"{path}: co2 needs the NOAA monthly format (>=4 columns) or a "
        f"2-column (time, ppm) table, got {ncols} columns")


_REAL_PARSERS = {
    "boston": _load_real_boston,
    "abalone": _load_real_abalone,
    "kin8nm": _load_real_kin8nm,
    "co2": _load_real_co2,
}


def _try_csv(name: str):
    """Load the real dataset from experiments/data/ if a known file exists."""
    path = _find_real_file(name)
    if path is None:
        return None
    return _REAL_PARSERS[name](path)


# -- boston housing (N=506, D=13) -------------------------------------------

def _synthetic_boston(rng):
    """Surrogate with boston-like feature typing and scale (medv in [5, 50])."""
    n = 506
    z = rng.randn(n, 4)  # latent socio-economic factors
    crim = np.exp(1.2 * z[:, 0] - 3.0)                      # skewed, positive
    zn = np.clip(25 * (z[:, 1] > 1.0) * (z[:, 1] - 1.0), 0, 100)
    indus = np.clip(11 + 6 * z[:, 0] + rng.randn(n), 0.5, 28)
    chas = (rng.rand(n) < 0.07).astype(float)               # binary
    nox = np.clip(0.55 + 0.1 * z[:, 0] + 0.02 * rng.randn(n), 0.38, 0.87)
    rm = np.clip(6.3 + 0.6 * z[:, 2] + 0.2 * rng.randn(n), 3.5, 8.8)
    age = np.clip(68 + 25 * z[:, 0] + 5 * rng.randn(n), 2.9, 100)
    dis = np.exp(1.18 + 0.5 * (-z[:, 0]) + 0.2 * rng.randn(n))
    rad = np.clip(np.round(9.5 + 7 * z[:, 3]), 1, 24)
    tax = np.clip(408 + 160 * z[:, 3] + 20 * rng.randn(n), 187, 711)
    ptratio = np.clip(18.4 + 2 * z[:, 0] + rng.randn(n), 12.6, 22)
    b = np.clip(356 - 60 * np.abs(z[:, 1]) - 10 * rng.randn(n), 0.3, 396.9)
    lstat = np.clip(np.exp(2.3 + 0.6 * z[:, 0] + 0.3 * rng.randn(n)), 1.7, 38)
    X = np.stack([crim, zn, indus, chas, nox, rm, age, dis, rad, tax,
                  ptratio, b, lstat], axis=1)
    y = (22.5 + 5.0 * (rm - 6.3) - 0.35 * (lstat - 12.0)
         - 9.0 * (nox - 0.55) + 2.0 * chas
         - 0.25 * (ptratio - 18.4) + 0.04 * (b - 356) / 3.0
         + 1.5 * np.sin(dis) + rng.randn(n) * 2.5)
    y = np.clip(y, 5.0, 50.0)
    return X, y


def load_boston(prop: float = 0.9, seed: Optional[int] = None):
    """Boston config: N=506, D=13, 90/10 split (boston_housing.py:50-60)."""
    rng = np.random.RandomState(seed)
    real = _try_csv("boston")
    if real is not None:
        X, y = real
        source = "real"
    else:
        X, y = _synthetic_boston(np.random.RandomState(506))
        source = "synthetic-surrogate"
    Xt, yt, Xv, yv = _split(X, y, prop, rng)
    return Xt, yt, Xv, yv, {"name": "boston_housing", "source": source}


# -- abalone (N=4177, D=8 -> 10 with one-hot sex) ---------------------------

def _synthetic_abalone(rng):
    """Surrogate: rings (age) from shell morphometrics, 3-way sex category."""
    n = 4177
    sex = rng.choice(3, n, p=[0.366, 0.321, 0.313])  # M, F, I
    infant = (sex == 2).astype(float)
    growth = np.clip(rng.gamma(6.0, 0.12, n) - 0.25 * infant, 0.05, 1.2)
    length = np.clip(0.15 + 0.45 * growth + 0.02 * rng.randn(n), 0.07, 0.82)
    diameter = np.clip(length * (0.78 + 0.03 * rng.randn(n)), 0.05, 0.65)
    height = np.clip(length * (0.26 + 0.04 * rng.randn(n)), 0.0, 0.3)
    whole = np.clip(1.9 * length**3.1 * np.exp(0.1 * rng.randn(n)), 0.002, 2.9)
    shucked = whole * np.clip(0.43 + 0.05 * rng.randn(n), 0.2, 0.6)
    viscera = whole * np.clip(0.22 + 0.03 * rng.randn(n), 0.08, 0.4)
    shell = whole * np.clip(0.28 + 0.04 * rng.randn(n), 0.12, 0.5)
    rings = np.clip(np.round(
        3.5 + 11.0 * growth - 2.0 * infant
        + 4.0 * shell / (whole + 0.05) + rng.randn(n) * 2.2), 1, 29)
    # one-hot sex + 7 numeric columns, reference encoding (abalone.py:23-26)
    onehot = np.zeros((n, 3))
    onehot[np.arange(n), sex] = 1.0
    X = np.concatenate([onehot, np.stack(
        [length, diameter, height, whole, shucked, viscera, shell], axis=1)],
        axis=1)
    return X, rings.astype(float)


def load_abalone(prop: float = 0.8, seed: Optional[int] = None):
    rng = np.random.RandomState(seed)
    real = _try_csv("abalone")
    if real is not None:
        X, y = real
        source = "real"
    else:
        X, y = _synthetic_abalone(np.random.RandomState(4177))
        source = "synthetic-surrogate"
    Xt, yt, Xv, yv = _split(X, y, prop, rng)
    return Xt, yt, Xv, yv, {"name": "abalone", "source": source}


# -- kin8nm (N=8192, D=8): 8-joint arm forward kinematics, med noise --------

def _synthetic_kin8nm(rng):
    """Physical simulation of the DELVE kin-8nm family.

    8 revolute joints, unit-sum link lengths, end-effector distance from a
    fixed target in 3-D, plus moderate ("m") multiplicative noise.  The real
    DELVE generator differs in constants, but the learning problem —
    smooth trig response surface in 8 angles — is the same family.
    """
    n = 8192
    theta = rng.uniform(-np.pi / 2, np.pi / 2, (n, 8))
    lengths = np.full(8, 1.0 / 8)
    # Planar-chain x/y + a twist-driven z for genuine 3-D structure.
    cum = np.cumsum(theta, axis=1)
    x = (lengths * np.cos(cum)).sum(axis=1)
    yy = (lengths * np.sin(cum)).sum(axis=1)
    z = (lengths * np.sin(theta * 1.5)).sum(axis=1) * 0.3
    target = np.array([0.2, 0.3, 0.1])
    dist = np.sqrt((x - target[0])**2 + (yy - target[1])**2
                   + (z - target[2])**2)
    y = dist * (1.0 + 0.03 * rng.randn(n)) + 0.02 * rng.randn(n)
    return theta, y


def load_kin8nm(prop: float = 0.8, seed: Optional[int] = None):
    rng = np.random.RandomState(seed)
    real = _try_csv("kin8nm")
    if real is not None:
        X, y = real
        source = "real"
    else:
        X, y = _synthetic_kin8nm(np.random.RandomState(8192))
        source = "synthetic-surrogate"
    Xt, yt, Xv, yv = _split(X, y, prop, rng)
    return Xt, yt, Xv, yv, {"name": "kin8nm", "source": source}


# -- co2 (1-D monthly series, extrapolation demo) ---------------------------

def _synthetic_co2(rng):
    """Mauna-Loa-like monthly series: quadratic trend + seasonal harmonics."""
    months = np.arange(526)  # ~1958-2001 monthly, like fetch_mldata's copy
    t = months / 12.0
    ppm = (314.7 + 0.75 * t + 0.0125 * t**2
           + 2.87 * np.sin(2 * np.pi * t + 0.35)
           + 0.8 * np.sin(4 * np.pi * t + 1.3)
           + 0.25 * rng.randn(months.shape[0]))
    return months[:, None].astype(float), ppm


def load_co2(prop: float = 0.8, seed: Optional[int] = None):
    rng = np.random.RandomState(seed)
    real = _try_csv("co2")
    if real is not None:
        X, y = real
        X = X.reshape(-1, 1)
        source = "real"
    else:
        X, y = _synthetic_co2(np.random.RandomState(526))
        source = "synthetic-surrogate"
    Xt, yt, Xv, yv = _split(X, y, prop, rng)
    return Xt, yt, Xv, yv, {"name": "co2", "source": source}


# -- surrogate floor oracles -------------------------------------------------
#
# Each surrogate's generative process above is known exactly, so the Bayes-
# optimal (conditional-mean) predictor is computable in closed form — the
# measured "floor" any regressor can reach on these splits.  This is the
# parity anchor when real CSVs are absent: a model matching the reference's
# *real-data* quality should land within a small factor of the surrogate
# floor here (VERDICT.md round 1, item 1).  Only meaningful when the loader
# reported source == "synthetic-surrogate".

def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)


def _norm_cdf(z):
    from math import erf
    return 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))


def _clipped_normal_mean(f, sigma, lo, hi):
    """E[clip(Z, lo, hi)] for Z ~ N(f, sigma^2), elementwise."""
    a = (lo - f) / sigma
    b = (hi - f) / sigma
    Fa, Fb = _norm_cdf(a), _norm_cdf(b)
    return lo * Fa + hi * (1.0 - Fb) + f * (Fb - Fa) \
        + sigma * (_norm_pdf(a) - _norm_pdf(b))


def _clipped_normal_var(f, sigma, lo, hi):
    """Var[clip(Z, lo, hi)] for Z ~ N(f, sigma^2), elementwise.

    E[X^2] = lo^2 F(a) + hi^2 (1-F(b)) + int_a^b (f + s z)^2 phi(z) dz with
    int z phi = phi(a)-phi(b) and int z^2 phi = (F(b)-F(a)) + a phi(a) -
    b phi(b)."""
    a = (lo - f) / sigma
    b = (hi - f) / sigma
    Fa, Fb = _norm_cdf(a), _norm_cdf(b)
    pa, pb = _norm_pdf(a), _norm_pdf(b)
    mid = Fb - Fa
    ex2 = (lo ** 2 * Fa + hi ** 2 * (1.0 - Fb)
           + f ** 2 * mid + 2.0 * f * sigma * (pa - pb)
           + sigma ** 2 * (mid + a * pa - b * pb))
    m = _clipped_normal_mean(f, sigma, lo, hi)
    return np.maximum(ex2 - m ** 2, 1e-12)


def oracle_boston(X):
    """E[y | X] for the boston surrogate (columns as _synthetic_boston)."""
    chas, nox, rm, dis = X[:, 3], X[:, 4], X[:, 5], X[:, 7]
    ptratio, b, lstat = X[:, 10], X[:, 11], X[:, 12]
    f = (22.5 + 5.0 * (rm - 6.3) - 0.35 * (lstat - 12.0)
         - 9.0 * (nox - 0.55) + 2.0 * chas
         - 0.25 * (ptratio - 18.4) + 0.04 * (b - 356) / 3.0
         + 1.5 * np.sin(dis))
    return _clipped_normal_mean(f, 2.5, 5.0, 50.0)


def oracle_abalone(X):
    """Plug-in E[rings | X] for the abalone surrogate.

    ``length`` is the (noisy) sufficient statistic for the latent growth
    factor — every other morphometric derives from length — so the plug-in
    inversion growth ≈ (length - 0.15)/0.45 is near-optimal; the residual
    noise (rings noise 2.2, propagated growth noise 11*0.02/0.45 ≈ 0.49,
    rounding) IS the floor."""
    infant = X[:, 2]
    length, whole, shell = X[:, 3], X[:, 6], X[:, 9]
    growth = np.clip((length - 0.15) / 0.45, 0.05, 1.2)
    f = 3.5 + 11.0 * growth - 2.0 * infant + 4.0 * shell / (whole + 0.05)
    sigma = np.sqrt(2.2 ** 2 + (11.0 * 0.02 / 0.45) ** 2)
    return _clipped_normal_mean(f, sigma, 1.0, 29.0)


def oracle_kin8nm(X):
    """E[y | theta]: the arm kinematics are deterministic given the angles."""
    lengths = np.full(8, 1.0 / 8)
    cum = np.cumsum(X, axis=1)
    x = (lengths * np.cos(cum)).sum(axis=1)
    yy = (lengths * np.sin(cum)).sum(axis=1)
    z = (lengths * np.sin(X * 1.5)).sum(axis=1) * 0.3
    target = np.array([0.2, 0.3, 0.1])
    return np.sqrt((x - target[0]) ** 2 + (yy - target[1]) ** 2
                   + (z - target[2]) ** 2)


def oracle_co2(X):
    """E[ppm | month]: deterministic trend + harmonics."""
    t = X[:, 0] / 12.0
    return (314.7 + 0.75 * t + 0.0125 * t ** 2
            + 2.87 * np.sin(2 * np.pi * t + 0.35)
            + 0.8 * np.sin(4 * np.pi * t + 1.3))


ORACLES = {
    "boston_housing": oracle_boston,
    "abalone": oracle_abalone,
    "kin8nm": oracle_kin8nm,
    "co2": oracle_co2,
}


# Conditional predictive STD oracles (per point), from each surrogate's
# known noise model — the calibration floor that anchors MNLP the way the
# mean oracles anchor NMSE (round-2 VERDICT item 6).  The MNLP *metric* is
# Gaussian (utils/metrics.py), so the floor is the best GAUSSIAN predictive:
# mu = E[y|x], sigma^2 = Var[y|x].

def oracle_std_boston(X):
    """Clipped-normal residual: y = clip(N(f, 2.5), 5, 50)."""
    chas, nox, rm, dis = X[:, 3], X[:, 4], X[:, 5], X[:, 7]
    ptratio, b, lstat = X[:, 10], X[:, 11], X[:, 12]
    f = (22.5 + 5.0 * (rm - 6.3) - 0.35 * (lstat - 12.0)
         - 9.0 * (nox - 0.55) + 2.0 * chas
         - 0.25 * (ptratio - 18.4) + 0.04 * (b - 356) / 3.0
         + 1.5 * np.sin(dis))
    return np.sqrt(_clipped_normal_var(f, 2.5, 5.0, 50.0))


def oracle_std_abalone(X):
    """Rings noise 2.2 + propagated growth noise (11*0.02/0.45) +
    round-to-integer variance 1/12, through the [1, 29] clip."""
    infant = X[:, 2]
    length, whole, shell = X[:, 3], X[:, 6], X[:, 9]
    growth = np.clip((length - 0.15) / 0.45, 0.05, 1.2)
    f = 3.5 + 11.0 * growth - 2.0 * infant + 4.0 * shell / (whole + 0.05)
    sigma = np.sqrt(2.2 ** 2 + (11.0 * 0.02 / 0.45) ** 2 + 1.0 / 12.0)
    return np.sqrt(_clipped_normal_var(f, sigma, 1.0, 29.0))


def oracle_std_kin8nm(X):
    """Heteroscedastic: y = dist (1 + 0.03 e1) + 0.02 e2."""
    dist = oracle_kin8nm(X)
    return np.sqrt((0.03 * dist) ** 2 + 0.02 ** 2)


def oracle_std_co2(X):
    return np.full(X.shape[0], 0.25)


ORACLE_STDS = {
    "boston_housing": oracle_std_boston,
    "abalone": oracle_std_abalone,
    "kin8nm": oracle_std_kin8nm,
    "co2": oracle_std_co2,
}


def surrogate_floor(name: str, Xv, yv) -> dict:
    """Bayes-floor metrics of the named surrogate on a held-out split.

    Evaluates the closed-form conditional-mean oracle — no model can do
    better in expectation — plus the Bayes-optimal MNLP (Gaussian
    predictive at the true conditional mean/std; no Gaussian-metric
    calibration can beat it in expectation).  Returns the floor in the same
    metric definitions the experiments report (utils/metrics.py)."""
    Xv = np.asarray(Xv, np.float64)
    pred = ORACLES[name](Xv)
    std = ORACLE_STDS[name](Xv)
    yv = np.asarray(yv, np.float64).reshape(-1)
    err = yv - pred
    mse = float(np.mean(err ** 2))
    mnlp = float(np.mean(0.5 * (err / std) ** 2
                         + 0.5 * np.log(2 * np.pi * std ** 2)))
    # Best single-sigma Gaussian (sigma^2 = mse minimizes the Gaussian MNLP):
    # the floor WITHIN the homoscedastic family SCFGP's scalar dispersion c
    # lives in.  On heteroscedastic surrogates (kin8nm: noise scales with
    # the target) MNLP_HOMO is the fair calibration anchor; MNLP (above) is
    # the unrestricted Bayes floor.
    mnlp_homo = float(0.5 * (1.0 + np.log(2 * np.pi * mse)))
    return {
        "MAE": float(np.mean(np.abs(err))),
        "MSE": mse,
        "RMSE": float(np.sqrt(mse)),
        "NMSE": mse / float(np.var(yv)),
        "MNLP": mnlp,
        "MNLP_HOMO": mnlp_homo,
    }


# -- synthetics for tests and scaling benchmarks ----------------------------

def synthetic_gp_rff(n: int, d: int, s: int, m: int, noise_std: float = 0.1,
                     seed: int = 0, dtype=np.float64):
    """Data drawn from the SCFGP model family, with a known noise floor
    (``scfgp_tpu/data/datasets.py:584-599``): a well-fit model approaches
    NMSE ~= noise_std² / var(y)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d)
    F = rng.randn(d, s).dot(rng.randn(m, s).T) * 2.0
    phases = rng.rand(m) * 2 * np.pi
    Phi = np.sqrt(2.0 / m) * np.cos(X.dot(F) + phases)
    w = rng.randn(m)
    f = Phi.dot(w)
    y = f + noise_std * rng.randn(n)
    return X.astype(dtype), y.astype(dtype)


def synthetic_large(n: int = 1_000_000, d: int = 256, seed: int = 0,
                    dtype=np.float32):
    """The weak-scaling configuration of ``BASELINE.json`` (N=1e6, D=256)
    that the streaming objective trains
    (``scfgp_tpu/data/datasets.py:602-610``)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(dtype)
    w1 = rng.randn(d, 16).astype(dtype)
    w2 = rng.randn(16).astype(dtype)
    y = np.tanh(X @ w1) @ w2 + 0.1 * rng.randn(n).astype(dtype)
    return X, y.astype(dtype)
