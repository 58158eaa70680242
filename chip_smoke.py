#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, streaming and Cholesky paths
on one card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. card and precision: name and power limit (nvidia-smi), torch and CUDA
   versions; float32 matrix products must not run in TF32;
2. build the CUDA kernels K1f (csrc/phi_fwd.cu), K1b (csrc/phi_bwd.cu),
   K2f (csrc/gram_fwd.cu), K2b (csrc/gram_bwd.cu), and K4 and K3
   (csrc/cholesky.cu) from this checkout, one nvcc each, started together;
3. K1f against its plain PyTorch version on the card at the slice's shapes
   (kin8nm, bench, ragged, D=256 and the streaming block), with both times
   (CUDA events, median of repeats): device time (``ms``) and time per call
   with the host's share (``call_ms``); the same call twice must give
   bitwise equal features;
3b. K1b the same way, against ``phi_bwd_ref`` and against autograd through
   the plain feature map, with a stated error bound; the same call twice
   must give bitwise equal gradients;
3c, 3d. K2f and K2b the same way, against ``sufficient_stats_ref`` and
   ``gram_bwd_ref``, with error bounds from a rounding model
   (k2f_tolerance, k2b_tolerance), bitwise repeatable, at kin8nm, bench,
   ragged, the streaming block and zero-weight rows;
3e. K4 and K3 against torch's pair (``cholesky_ref``,
   ``cholesky_inverse_ref``) at n from 1 to 4096, with the bounds of a
   rounding model (chol_tolerance) on L Lᵀ - A, L⁻¹ L - I and the
   differences from the plain versions; strict upper triangles exactly 0,
   bitwise repeatable, gradients through the kernels' autograd Functions
   against the plain ones, and an indefinite matrix that must return with
   every pivot positive; each n's times against the plain versions (and
   their ratio), ``cholesky_ex``'s at n = 554, and ``diag_kernel``'s µs a
   block column at n = 554 and 4096 from a profile;
4. serve the kin8nm model trained by the JAX package
   (experiments/results/kin8nm/best_model.pkl): load, then predict request
   batches of 1, 17, 256 rows and the full 1639-row split;
5. condition and update: set_data on the 6553 training rows, update_data
   with 256 held-out rows, recalibrate_dispersion; each posterior and each
   prediction is held against the same computation with the plain feature
   map on the card;
6. train step: cost and every gradient leaf of ``loss_and_grad``, kernel
   path against plain path, at kin8nm full width (S=8, M=269, N=6553) and at
   the bench configuration (N=8192, D=8, S=50, M=200); the median time of
   one loss + grad + adam/Nesterov step on each path, and the device-busy
   share of a ``torch.profiler`` window;
7. fit_fast: the reference kin8nm protocol at full width
   (experiments/kin8nm.py: SCFGP(sparsity=-1, nfeats=269), obj SCORE, adam
   lr 0.01, max_iter 200, cvrg_tol 1e-5, max_cvrg 8), ending in the
   package's dispersion recalibration, from a fixed seed,
   held against the same fit with the plain feature map on the card, the
   quality anchors of tests/test_end_to_end.py, and a run split into
   checkpoint segments and resumed after a simulated crash, which must equal
   the one-shot run bitwise;
8. fit: the host loop, 40 iterations, against a run checkpointed at 20 and
   resumed by a fresh model from the file, which must equal it bitwise;
9. streaming: ``loss_fn_streaming`` at N=1e6, D=256, S=56, M=200, block
   16384 (experiments/tpu_streaming_1m.py, uncut): the kernel route against
   the GEMM route and the dense path, five adam steps on each route, and
   the peak memory of a step (see ``streaming``);
10. the Cholesky crossover (scfgp_tpu_torch/experiments/chol_crossover.py)
   at n = 512, 1024, 2048, 4096: K4 and K3 against torch's pair and the
   block-Neumann inverse, each leg's device time and time per call;
10b. the served kin8nm model's posterior (2K = 554, 6553 rows) rebuilt
   through K3 and held against ``solve_posterior`` (torch's pair);
11. batched sweeps and ensembles (BATCH_SHAPES and below): 11a K1f and K1b
   with a trial axis, each trial bitwise its 2-D call, with the device
   times of the batched launch, of B 2-D launches and of the plain batched
   version; 11b ``fit_fast_batch`` of 10 boston trials against sequential
   ``fit_fast`` (float32 through the kernels, K1b launched once a step of
   the batch; float32 with every product past Phi per trial, and float64
   on the plain map, both at the JAX tolerances); 11c the
   ported boston driver's batched sweep at full width (50 trials x m in
   {10..50}); 11d its floor-closing ensembles on seeds 0-2; 11e the co2
   driver (plain and composite) and the abalone and kin8nm drivers with
   --quick, with the floor pins of tests/test_end_to_end.py.

The launch counts of the six kernels are set to 0 just before each path
(the serving path, phases 4-5, each training phase, the streaming kernel
and GEMM routes, the crossover, the posterior through K3, and each path of
phase 11) and read just after; every training phase must launch K1f and
K1b, the streaming kernel
route K1f, K1b, K2f and K2b, its GEMM route K1f and K1b but neither K2f
nor K2b, the crossover K4 and K3, the posterior K3; the serving,
training and streaming paths must launch neither K3 nor K4 (their
posterior stays on torch's pair).  The line before the last is a JSON
object with each kernel's launches, error and times, its bound (the
larger of its FP32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s,
from this run's shapes) and the time of one library call for the same
function where there is one, at the shape KERNELS_LINE_SHAPES names first
(``at``; K1f, K1b, K2f and K2b at one streaming block) and the same
readings at the others (``beside``); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
there is no CUDA device or no package beside it.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# cuBLAS picks its reduction order by workspace; a fixed workspace keeps
# repeated products bitwise equal, which the resume checks rely on.  Set
# before torch creates a cuBLAS handle.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "experiments", "results", "kin8nm",
                    "best_model.pkl")
U32 = 2.0 ** -24  # float32 unit roundoff
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12  # FLOP/s
PEAK_HBM = 3.35e12  # bytes/s

# Phase 9: the defaults of experiments/tpu_streaming_1m.py:32-33, uncut.
STREAM = dict(N=1_000_000, D=256, S=56, M=200, block=16384, steps=5)
# (N, D, K) of one block of phase 9, where pass 2 launches K1f and K1b and
# pass 1 K2f and K2b.
STREAM_BLOCK = (STREAM["block"], STREAM["D"], STREAM["S"] + STREAM["M"])
# Shapes (N, D, K) of phase 3: the served kin8nm model, the bench
# configuration (S=50, M=200), ragged ones, D=256 (synthetic_large) and the
# streaming block.
K1_SHAPES = [("kin8nm", 6553, 8, 277), ("bench", 8192, 8, 250),
             ("ragged-1", 1, 3, 37), ("ragged-777", 777, 3, 37),
             ("d256", 4096, 256, 500), ("block", *STREAM_BLOCK)]
# Kernel and plain feature maps differ by float32 rounding of T (|T| reaches
# tens).  Measured on the CPU, a Phi perturbation of that size moves each
# field of the kin8nm posterior by at most 3e-4 of its largest entry (alpha,
# cond(A) ~ 1.3e4), the predictions by 6e-5 of their largest value and the
# cost by 5e-6; update_data's Gram, summed in two parts, moves alpha by as
# much again.  Held at about 10x that:
POST_TOL = 3e-3   # per field, relative to its largest entry
PRED_TOL = 3e-4   # mean: relative to its largest value; std: relative
COST_TOL = 1e-4   # relative
C_TOL = 1e-3      # absolute on c, a log of the recalibrated dispersion
# K1f equals the plain map bitwise at kin8nm (cuBLAS sums T there in the
# kernel's order d = 0..D-1; ``equals_plain`` of phase 3 shows where it does
# elsewhere), and K1b's sums over rows differ
# from autograd's only in order, so the two loss gradients differ by float32
# rounding carried through the Cholesky backward (cond(A) ~ 1e4): measured
# ~5e-7 of each leaf's largest entry on an H100, held at 1e-4.  Phase
# gradients are pure gauge (about zero), so they are held to that bound
# relative to the largest gradient entry of any leaf.
GRAD_TOL = 1e-4
# The cost histories of two fits that differ only in that rounding drift
# apart along the trajectory (measured 3e-6 over the first 20 steps); held
# at 1e-4 relative, and their final NMSE within 10%.
FIT_COST_TOL = 1e-4
FIT_NMSE_TOL = 0.10
# The factor c of the K1b error bound (k1b_tolerance).
K1B_C = 4.0
# The factor on the root-sum-square term of the K2 error bounds
# (k2f_tolerance, k2b_tolerance), as K1B_C.
K2_C = 4.0
# K4 and K3 (phase 3e) and torch's pair are backward stable (Higham,
# "Accuracy and Stability of Numerical Algorithms", ch. 8 and 10): with
# g = CHOL_C n u, a computed factor has |L Lᵀ - A| <= g |L| |L|ᵀ and a
# computed triangular inverse |L⁻¹ L - I| <= g |L⁻¹| |L|, entry by entry.
# Two such factors of one A differ by about g cond(A) |L| (the factor's
# forward error), their inverses by g cond(A)^1.5 |L⁻¹| (through
# L⁻¹ dL L⁻¹), and the gradients of a loss of (L, L⁻¹) by g cond(A)^2 of
# the gradient's largest entry (chol_tolerance).
CHOL_C = 4.0
# n of phase 3e: 1 and ragged sizes, the bench, streaming and kin8nm
# posteriors (2K = 500, 512, 554) and the crossover's sizes.
CHOL_SIZES = [1, 37, 200, 500, 512, 554, 1024, 2048, 4096]
CHOL_GRAD_SIZES = (37, 554)
# Where a call's device time goes, by kernel (torch.profiler).
CHOL_PROFILE_SIZES = (554, 4096)
# K4's library call (torch.linalg.cholesky_ex, cuSOLVER) is timed at the
# kin8nm posterior's n, the n of the kernels line.
CHOL_LIBRARY_SIZE = 554

# Shapes (N, D, K) of phases 3c and 3d: kin8nm, bench, ragged ones, the
# streaming block of phase 9 (K = S + M = 256, D = 256), and one whose
# weights are 0 on a third of the rows (the zero-weight padding rows of the
# JAX package's streaming blocks).
K2_SHAPES = [("kin8nm", 6553, 8, 277, False), ("bench", 8192, 8, 250, False),
             ("ragged-1", 1, 3, 37, False), ("ragged-777", 777, 3, 37, False),
             ("block", *STREAM_BLOCK, False),
             ("weighted", 5000, 16, 100, True)]
# The shapes (names of K1_SHAPES and K2_SHAPES) at which the kernels line
# reports K1f, K1b, K2f and K2b: first where a streaming step spends its
# time, one block of phase 9, then the served kin8nm model beside it, and
# for K1f and K1b the batched launches of phase 11a.
KERNELS_LINE_SHAPES = {"phi_fwd": ("block", "kin8nm", "batch-boston",
                                   "batch-kin8nm", "batch-d256"),
                       "phi_bwd": ("block", "kin8nm", "batch-boston",
                                   "batch-kin8nm", "batch-d256"),
                       "gram_fwd": ("block", "kin8nm"),
                       "gram_bwd": ("block", "kin8nm")}
# The kernel route, the GEMM route and the dense path each sum the 1e6 rows
# of the statistics in float32 in another order: by the probabilistic
# rounding model (Higham and Mary 2019) each statistic is off by at most
# about u sqrt(N) ~ 6e-5 of the sum of its terms' magnitudes, typically far
# less.  The cost is held at that relative bound; the gradient passes
# through the Cholesky backward, which amplifies by cond(A) (printed), and
# is held at 1e-3 of each leaf's largest entry (phases, pure gauge: of the
# largest entry of any leaf).
STREAM_COST_TOL = 6e-5
STREAM_GRAD_TOL = 1e-3
# A streaming step keeps O(block) tensors: Phi of one block, Phi Li^T, their
# squares and gradients, and the kernels' workspaces, each at most about
# block x 2K float32 (32 MiB at the streaming block).  Held at 16 of those
# plus 64 MiB for the 2K x 2K matrices, over what was allocated before the
# step (X and y included), whatever N.
STREAM_PEAK_BLOCKS = 16
STREAM_PEAK_EXTRA = 64 << 20

# Phase 11a: (name, B, N, D, K) of K1f and K1b with a trial axis: the
# boston sweep's trials (50 trials, 455 training rows, D=13, m=50 with
# S=20: K=70), eight kin8nm trials at the served model's width, and four at
# D=256, where both kernels take their wide design.
BATCH_SHAPES = [("boston", 50, 455, 13, 70), ("kin8nm", 8, 6553, 8, 277),
                ("d256", 4, 4096, 256, 500)]
# Phase 11b: the trials of fit_fast_batch against sequential fit_fast.  In
# float64 (the plain feature map on the card) they are held at the JAX
# package's tolerances (tests/test_batch_fit.py:49-72): equal iteration
# counts, costs at rtol 1e-6, params at rtol 1e-4 and atol 1e-7, final
# validation metrics at rtol 1e-5.  In float32 the batched products
# (cuBLAS strided-batched GEMMs, the batched Cholesky) round otherwise than
# the 2-D ones, and the loop's threshold tests (improved by less than
# cvrg_tol, stall annealing past max_cvrg / 2) can flip on that rounding:
# on an H100 one of ten boston trials took another branch at step 21 and
# ended at NMSE 0.427 against 0.332, both legitimate trajectories, and the
# others drifted by up to 5e-4 in cost.  So in float32 each trial's
# fit_fast_batch alone (B = 1) must equal its fit_fast bitwise; in the
# batch of all trials the first BATCH_FIT_EXACT_STEPS costs, before any
# annealing can act, must agree within FIT_COST_TOL; and the same batch
# with every product past Phi per trial (per_trial_products: the loop,
# its masks and generators, K1f and K1b stay batched) must agree with the
# sequential fits at the JAX tolerances over whole runs.
BATCH_FIT_TRIALS = 10
BATCH_FIT_EXACT_STEPS = 10
BATCH_FIT_COST_RTOL = 1e-6
BATCH_FIT_PARAM_RTOL = 1e-4
BATCH_FIT_PARAM_ATOL = 1e-7
BATCH_FIT_METRIC_RTOL = 1e-5
# Phases 11c-11e: the floor pins of tests/test_end_to_end.py: the boston
# sweep's mean NMSE/floor at m=20 over seeds 0-2 (:32-57), the ensembles'
# (:60-83) and the co2 composite's (:169-196).
SWEEP_PIN_M, SWEEP_PIN = 20, 1.35
ENSEMBLE_PIN = 1.2
CO2_PIN = 1.2

# The reference kin8nm protocol (experiments/kin8nm.py:35-47 through
# utils/experiment.py:109-111): full rank S=D=8, M=269 (2K=554).
KIN8NM_MODEL = dict(sparsity=-1, nfeats=269)
ADAM = {"algo": "adam", "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                                        "beta2": 0.999, "epsilon": 1e-8}}
FIT_KW = dict(obj="SCORE", algo=ADAM, max_iter=200, cvrg_tol=1e-5,
              max_cvrg=8)
# fit_fast ends with the package's closed-form dispersion recalibration
# (recalibrate=True).  Without it the reference protocol leaves the
# predictive std inflated: on an H100 one fit from SEED stopped after 43
# iterations at NMSE 0.0467 but a self-calibration excess of 0.49, and the
# JAX package's own 50-trial sweep at this width averages MNLP -0.64 +- 0.47
# (experiments/results/kin8nm/results.json), so the 0.30 anchor cannot hold
# for one fit without it.  The fit stops before 50 iterations, so the
# checkpoint segments are 20 iterations long, to split it at all.
FIT_FAST_KW = dict(FIT_KW, recalibrate=True)
CHECKPOINT_EVERY = 20
SEED = 0


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps=21, inner=10, hide_host=False):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events (``utils/profiling.py::time_fn``).  Plain, this is the
    time per call as a caller sees it, host work included.  With
    ``hide_host`` a sleep kernel holds the stream while the host enqueues
    the calls, so the events time the device work alone."""
    from scfgp_tpu_torch.utils.profiling import time_fn
    fn()
    clock = "device" if hide_host else "call"
    return statistics.median(
        time_fn(fn, iters=inner, warmup=0, clock=clock)["ms_per_call"]
        for _ in range(reps))


def k1_tolerance(X, F, p, s):
    """float32 rounding of T carries over one to one into cos and sin."""
    T = X.double() @ F.double() + p.double()
    return 2e-5 * abs(float(s)) * max(1.0, float(T.abs().max()))


def rel_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)


def k1b_tolerance(X, F, p, s, g):
    """Error bounds of K1b's (dFcat, dpcat, ds) against a plain float32
    version, under the usual model of independent rounding errors.  Both
    versions round T = X F + p along a D-term FMA chain and evaluate cos and
    sin to about an ulp, so per (row, feature) their values of dT differ by
    about u E with E = s (|g_cos| + |g_sin|) sqrt(D + 2) (1 + |T|abs),
    |T|abs = sum_d |X F| + |p|; then each sums over rows in its own order,
    which costs about u times the sum of the terms' magnitudes.  With
    c = K1B_C:

      dFcat: c u max_ij [sum_r |X_ri| |dT_rj| + sqrt(sum_r (|X_ri| E_rj)^2)]
      dpcat: c u max_j  [sum_r |dT_rj| + sqrt(sum_r E_rj^2)]
      ds:    c u [sum (|g_cos cos T| + |g_sin sin T|) + sqrt(sum (E / s)^2)]
    """
    X, F, p, s, g = (t.double() for t in (X, F, p, s, g))
    k = F.shape[1]
    T = X @ F + p
    e = ((g[:, :k].abs() + g[:, k:].abs()) * math.sqrt(X.shape[1] + 2)
         * (1.0 + X.abs() @ F.abs() + p.abs()))
    dT = (s * (g[:, k:] * torch.cos(T) - g[:, :k] * torch.sin(T))).abs()
    ax = X.abs().T
    cu = K1B_C * U32
    terms = (g[:, :k] * torch.cos(T)).abs() + (g[:, k:] * torch.sin(T)).abs()
    return (cu * float((ax @ dT + torch.sqrt((ax * ax) @ (s * e) ** 2))
                       .max()),
            cu * float((dT.sum(dim=0) + torch.sqrt(((s * e) ** 2)
                                                    .sum(dim=0))).max()),
            cu * float(terms.sum() + torch.sqrt((e * e).sum())))


def _t_rounding(X, F, p):
    """The float32 rounding of T = X F + p and of its cos and sin, in units
    of u, per (row, feature): sqrt(D + 2) (1 + |T|abs), as in
    k1b_tolerance."""
    return math.sqrt(X.shape[1] + 2) * (1.0 + X.abs() @ F.abs() + p.abs())


def k2f_tolerance(X, F, p, s, y, w):
    """Error bounds of K2f's (phiTphi, phiTy, yTy, n) against the plain
    float32 version.  Each version rounds Phi (an entry is off by about
    u e, e = |s| E, E of _t_rounding, independently across rows), then sums
    over the N rows in its own order: by the probabilistic model of Higham
    and Mary (2019), off by at most about u sqrt(N) times the sum of the
    terms' magnitudes.  With c = K2_C on the root-sum-square term:

      phiTphi: u max_ij [sqrt(N) sum_r |w_r Phi_ri Phi_rj|
                         + c sqrt(sum_r w_r^2 (e_ri |Phi_rj| + |Phi_ri| e_rj)^2)]
      phiTy:   u max_j  [sqrt(N) sum_r |w_r y_r Phi_rj|
                         + c sqrt(sum_r (w_r y_r e_rj)^2)]
      yTy:     u sqrt(N) sum_r |w_r| y_r^2;   n: u sqrt(N) sum_r |w_r|
    """
    X, F, p, s, y = (t.double() for t in (X, F, p, s, y))
    w = torch.ones_like(y) if w is None else w.double()
    T = X @ F + p
    a = (s * torch.cat([torch.cos(T), torch.sin(T)], dim=1)).abs()
    e = s.abs() * _t_rounding(X, F, p)
    e = torch.cat([e, e], dim=1)
    rn = math.sqrt(X.shape[0])
    w2 = (w * w)[:, None]
    m1 = (w2 * e * e).T @ (a * a)
    rss = m1 + m1.T + 2.0 * (w2 * e * a).T @ (e * a)
    order = (w.abs()[:, None] * a).T @ a
    wy = (w * y).abs()[:, None]
    return (U32 * float((rn * order + K2_C * rss.sqrt()).max()),
            U32 * float((rn * (wy * a).sum(dim=0)
                         + K2_C * ((wy * e) ** 2).sum(dim=0).sqrt()).max()),
            U32 * rn * float((w.abs() * y * y).sum()),
            U32 * rn * float(w.abs().sum()))


def k2b_tolerance(X, F, p, s, y, w, cbar, pbar):
    """Error bounds of K2b's (dFcat, dpcat, ds) against the plain float32
    version, under the model of k2f_tolerance.  An entry of
    G = w (s phi Abar + y pbar) is off by about u eG,
    eG = |w| (|s| (sqrt(2K) |phi| + E) |Abar| + |y pbar|) (the 2K-term
    product in another order, and phi's own rounding); an entry of
    dT = s (G_sin cos T - G_cos sin T) by u edT,
    edT = |s| ((|G_cos| + |G_sin|) E + eG_cos + eG_sin), independently
    across rows.  With c = K2_C:

      dFcat: u max_ij [sqrt(N) sum_r |X_ri dT_rj|
                       + c sqrt(sum_r (|X_ri| edT_rj)^2)]
      dpcat: u max_j  [sqrt(N) sum_r |dT_rj| + c sqrt(sum_r edT_rj^2)]
      ds:    u [sqrt(N) sum |G_cos cos T| + |G_sin sin T|
                + c sqrt(sum_r (sum_j (|G_cos| + |G_sin|) E + eG)^2)]
    """
    X, F, p, s, y, cbar, pbar = (t.double()
                                 for t in (X, F, p, s, y, cbar, pbar))
    w = torch.ones_like(y) if w is None else w.double()
    k = F.shape[1]
    T = X @ F + p
    c, sn = torch.cos(T), torch.sin(T)
    phi = torch.cat([c, sn], dim=1)
    E = _t_rounding(X, F, p)
    A = cbar + cbar.T
    G = w[:, None] * (s * phi @ A + y[:, None] * pbar)
    eG = w.abs()[:, None] * (
        s.abs() * (math.sqrt(2 * k) * phi.abs() + torch.cat([E, E], dim=1))
        @ A.abs() + (y[:, None] * pbar).abs())
    g_abs = G[:, :k].abs() + G[:, k:].abs()
    e_ds = g_abs * E + eG[:, :k] + eG[:, k:]
    edT = s.abs() * e_ds
    dT = (s * (G[:, k:] * c - G[:, :k] * sn)).abs()
    ax = X.abs().T
    rn = math.sqrt(X.shape[0])
    terms = (G[:, :k] * c).abs() + (G[:, k:] * sn).abs()
    return (U32 * float((rn * (ax @ dT)
                         + K2_C * ((ax * ax) @ edT ** 2).sqrt()).max()),
            U32 * float((rn * dT.sum(dim=0)
                         + K2_C * (edT ** 2).sum(dim=0).sqrt()).max()),
            U32 * float(rn * terms.sum()
                        + K2_C * (e_ds.sum(dim=1) ** 2).sum().sqrt()))


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time an H100 could take for work of
    ``flops`` FP32 operations moving ``nbytes``, the larger of the two at
    the card's peak rates."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


# (FP32 operations, bytes) of each kernel's function at (N, D, K) or n,
# float32: each input read once and each output written once.  sin and cos
# are not counted.
def k1f_work(n, d, k):  # T = X F + p; Φ (N, 2K) written
    return 2 * n * d * k, 4 * (n * d + d * k + k + 1 + 2 * n * k)


def k1b_work(n, d, k):  # T again, then Xᵀ dT; reads the gradient of Φ
    return 4 * n * d * k, 4 * (n * d + 2 * (d * k + k + 1) + 2 * n * k)


def k2f_work(n, d, k):  # T, then the upper triangle of ΦᵀΦ
    return (2 * n * d * k + n * 2 * k * (2 * k + 1),
            4 * (n * d + n + d * k + k + 1 + 4 * k * k + 2 * k + 2))


def k2b_work(n, d, k):  # T, Φ Ā (N, 2K) x (2K, 2K), then Xᵀ dT
    return (4 * n * d * k + 2 * n * (2 * k) ** 2,
            4 * (n * d + n + 2 * (d * k + k + 1) + 4 * k * k + 2 * k))


def chol_work(n, inverse):  # n³/3 for L, as much again for L⁻¹
    return ((2 if inverse else 1) * n ** 3 / 3,
            4 * n * n * (3 if inverse else 2))


def chol_tolerance(A, L, Li):
    """Bounds of phase 3e (see CHOL_C), in float64 from the kernel's L and
    L⁻¹: reconstruction, inverse residual, L and L⁻¹ against the plain
    versions, the gradient relative to its largest entry; and cond(A)."""
    A, L, Li = (t.double() for t in (A, L, Li))
    g = CHOL_C * A.shape[0] * U32
    ev = torch.linalg.eigvalsh(A)
    cond = float(ev[-1] / ev[0])
    return dict(recon=g * float((L.abs() @ L.abs().T).max()),
                inverse=g * float((Li.abs() @ L.abs()).max()),
                L=g * cond * float(L.abs().max()),
                Li=g * cond ** 1.5 * float(Li.abs().max()),
                grad=g * cond ** 2), cond


def cholesky_phase(dev):
    """Phase 3e: K4 and K3 against torch's pair at CHOL_SIZES on the
    crossover's input (B Bᵀ + I, B = randn(n, n)/sqrt(n), seed 0).  Returns
    the rows by n."""
    from scfgp_tpu_torch.experiments.chol_crossover import spd_input
    from scfgp_tpu_torch.models.objective import chol_and_inverse
    from scfgp_tpu_torch.ops.cholesky import (
        cholesky_cuda, cholesky_inverse_cuda, cholesky_inverse_kernel,
        cholesky_inverse_ref, cholesky_kernel, cholesky_ref)

    def grad(fn, A, loss):
        leaf = A.clone().requires_grad_()
        return torch.autograd.grad(loss(fn(leaf)), leaf)[0]

    def loss3(out):
        L, Li = out
        return torch.log(torch.diagonal(L)).sum() + (Li * Li).sum()

    def loss4(L):
        return torch.log(torch.diagonal(L)).sum() + 0.1 * L.sum()

    rows = {}
    for n in CHOL_SIZES:
        A = spd_input(n, dev)
        L4, L4b = cholesky_cuda(A), cholesky_cuda(A)
        (L, Li), (Lb, Lib) = cholesky_inverse_cuda(A), cholesky_inverse_cuda(A)
        torch.cuda.synchronize()
        Lp, Lip = cholesky_inverse_ref(A)
        tol, cond = chol_tolerance(A, L, Li)
        Ld, Lid, Ad = L.double(), Li.double(), A.double()
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        err = dict(
            recon=float((Ld @ Ld.T - Ad).abs().max()),
            recon_k4=float((L4.double() @ L4.double().T - Ad).abs().max()),
            inverse=float((Lid @ Ld - eye).abs().max()),
            L=float((L - Lp).abs().max()), L_k4=float((L4 - Lp).abs().max()),
            Li=float((Li - Lip).abs().max()))
        upper_zero = all(int(torch.triu(t, 1).count_nonzero()) == 0
                         for t in (L, Li, L4))
        bitwise = (torch.equal(L4, L4b) and torch.equal(L, Lb)
                   and torch.equal(Li, Lib))
        reps, inner = (5, 3) if n >= 2048 else (21, 10)
        k4, k3 = (lambda: cholesky_cuda(A)), (lambda: cholesky_inverse_cuda(A))
        p4, p3 = (lambda: cholesky_ref(A)), (lambda: cholesky_inverse_ref(A))
        row = dict(
            n=n, cond_A=cond, err=err, tol=tol, upper_zero=upper_zero,
            bitwise=bitwise, k4_equals_k3_L=torch.equal(L4, L),
            k4_ms=median_ms(k4, reps, inner, hide_host=True),
            k4_plain_ms=median_ms(p4, reps, inner, hide_host=True),
            k3_ms=median_ms(k3, reps, inner, hide_host=True),
            k3_plain_ms=median_ms(p3, reps, inner, hide_host=True),
            k4_call_ms=median_ms(k4, reps, inner),
            k4_plain_call_ms=median_ms(p4, reps, inner),
            k3_call_ms=median_ms(k3, reps, inner),
            k3_plain_call_ms=median_ms(p3, reps, inner))
        row.update(k4_vs_plain=row["k4_ms"] / row["k4_plain_ms"],
                   k3_vs_plain=row["k3_ms"] / row["k3_plain_ms"])
        if n == CHOL_LIBRARY_SIZE:
            row["k4_library_ms"] = median_ms(
                lambda: torch.linalg.cholesky_ex(A), reps, inner,
                hide_host=True)
        if n in CHOL_PROFILE_SIZES:
            for name, fn in (("k4", k4), ("k3", k3)):
                _, _, _, top = device_busy(fn, steps=3)
                row[f"{name}_top_kernels_ms"] = top
                diag_ms = [ms for key, ms in top.items()
                           if "diag_kernel" in key]
                check(len(diag_ms) == 1,
                      f"no diag_kernel in the profile of {name} at n={n}")
                row[f"{name}_diag_us_per_block"] = (
                    diag_ms[0] * 1e3 / math.ceil(n / 64))
        if n in CHOL_GRAD_SIZES:
            g3, g3p = (grad(cholesky_inverse_kernel, A, loss3),
                       grad(chol_and_inverse, A, loss3))
            g4, g4p = (grad(cholesky_kernel, A, loss4),
                       grad(torch.linalg.cholesky, A, loss4))
            row["grad_rel_err"] = dict(
                k3=rel_err(g3, g3p), k4=rel_err(g4, g4p))
        say("cholesky_vs_plain", **row)
        check(bitwise, f"K3/K4 are not bitwise repeatable at n={n}")
        check(upper_zero, f"K3/K4 upper triangles are not 0 at n={n}")
        check(err["recon"] <= tol["recon"] and err["recon_k4"] <= tol["recon"]
              and err["inverse"] <= tol["inverse"]
              and err["L"] <= tol["L"] and err["L_k4"] <= tol["L"]
              and err["Li"] <= tol["Li"],
              f"K3/K4 disagree with torch's pair at n={n}: {err} > {tol}")
        check(all(e <= tol["grad"] for e in row.get("grad_rel_err",
                                                     {}).values()),
              f"K3/K4 gradients differ at n={n}: {row.get('grad_rel_err')}")
        rows[n] = row

    # Not positive definite: the clamped pivot gives finite nonsense, inf
    # or NaN below the diagonal, never an error or a hang; every pivot is
    # in [1e-15, inf].
    A = indefinite_input(dev)
    L, Li = cholesky_inverse_cuda(A)
    L4 = cholesky_cuda(A)
    torch.cuda.synchronize()
    pivots_positive = all(bool((torch.diagonal(t) > 0).all()) for t in (L, L4))
    say("cholesky_indefinite", n=A.shape[0], returned=True,
        finite=[bool(torch.isfinite(t).all()) for t in (L, Li, L4)],
        nan=[bool(torch.isnan(t).any()) for t in (L, Li, L4)],
        pivots_positive=pivots_positive,
        plain_nan=bool(torch.isnan(cholesky_ref(A)).any()))
    check(pivots_positive, "K3/K4 gave a pivot that is not positive on the "
          "indefinite matrix")
    return rows


def indefinite_input(dev, n=200):
    """S + Sᵀ, S = randn(n, n) from RandomState(1): not positive definite."""
    S = np.random.RandomState(1).randn(n, n)
    return torch.as_tensor(S + S.T, dtype=torch.float32, device=dev)


def plain_fourier_features(params, X):
    """The feature map by its plain PyTorch version, differentiable by
    autograd: the plain path the kernel path is held against."""
    from scfgp_tpu_torch.models.objective import derive_frequencies
    from scfgp_tpu_torch.ops.phi import fourier_features_ref
    fr = derive_frequencies(params)
    scale = torch.exp(params.b) * math.sqrt(2.0 / params.M)
    return fourier_features_ref(X, fr.Fcat, fr.pcat, scale)


@contextlib.contextmanager
def plain_feature_map():
    """Run the model's objective on the plain feature map: every loss,
    gradient and prediction inside skips K1f and K1b."""
    from scfgp_tpu_torch.models import objective
    kernel = objective.fourier_features
    objective.fourier_features = plain_fourier_features
    try:
        yield
    finally:
        objective.fourier_features = kernel


def trial_of(tree, b):
    """Trial b of a batched tensor or NamedTuple of tensors, each tensor a
    fresh copy (aligned as the 2-D call's own tensors are)."""
    if isinstance(tree, torch.Tensor):
        return tree[b].clone()
    return type(tree)(*(trial_of(t, b) for t in tree))


def stack_trials(trees):
    """The inverse of ``trial_of``: one batched tree of per-trial trees.
    Column-major matrices (L and L⁻¹, as LAPACK and cuSOLVER leave them,
    batched or not) stay column-major: a product with another layout takes
    another cuBLAS kernel and rounds otherwise."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        if first.dim() == 2 and not first.is_contiguous():
            return torch.stack([t.mT for t in trees]).mT
        return torch.stack(trees)
    parts = [stack_trials(list(t)) for t in zip(*trees)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


@contextlib.contextmanager
def per_trial_products():
    """Run ``fit_fast_batch``'s objective with only its feature map batched:
    each trial's frequencies are derived alone and stacked, one K1f and one
    K1b launch serve all trials, and every product past Phi (Gram,
    Cholesky, moments, penalty, predictions) runs per trial on 2-D tensors.
    The loop, its masks, generators and optimizer state, and the
    validation metric stay batched.  Without a trial axis the objective is
    unchanged."""
    from scfgp_tpu_torch.models import model, objective
    from scfgp_tpu_torch.models.params import (derive_frequencies,
                                               feature_scale)
    from scfgp_tpu_torch.ops.phi import FourierFeatures
    saved = model.loss_fn, model.loss_and_grad, model.predict_f

    def features(trials, X, basis_fn):
        if basis_fn is not None:
            raise NotImplementedError("per_trial_products: no extra basis")
        fr = [derive_frequencies(q) for q in trials]
        return FourierFeatures.apply(
            X, torch.stack([f.Fcat for f in fr]),
            torch.stack([f.pcat for f in fr]),
            torch.stack([feature_scale(q) for q in trials]))

    def loss_fn(p, X, y, w=None, basis_fn=None):
        if X.dim() == 2 or w is not None:
            return objective.loss_fn(p, X, y, w, basis_fn)
        trials = [trial_of(p, b) for b in range(X.shape[0])]
        Phi = features(trials, X, basis_fn)
        return stack_trials([
            objective.loss_from_phi(q, Phi[b].clone(), y[b].clone())
            for b, q in enumerate(trials)])

    def loss_and_grad(p, X, y, w=None, basis_fn=None):
        return objective.value_and_grad(loss_fn, p, X, y, w=w,
                                        basis_fn=basis_fn)

    def predict_f(p, post, Xs, basis_fn=None):
        if Xs.dim() == 2:
            return objective.predict_f(p, post, Xs, basis_fn)
        trials = [trial_of(p, b) for b in range(Xs.shape[0])]
        Phis = features(trials, Xs, basis_fn)
        return stack_trials([
            objective.predict_from_phi(q, trial_of(post, b), Phis[b].clone())
            for b, q in enumerate(trials)])

    model.loss_fn, model.loss_and_grad, model.predict_f = (
        loss_fn, loss_and_grad, predict_f)
    try:
        yield
    finally:
        model.loss_fn, model.loss_and_grad, model.predict_f = saved


# Launched only by the Cholesky paths (phases 10, 10b): the serving,
# training and streaming posteriors stay on torch's pair.
CHOL_KERNELS = ("cholesky", "cholesky_inverse")


class Launches:
    """The kernels' launch counts, set to 0 before a path and read after."""

    def __init__(self, **kernels):
        self.kernels = kernels
        self.by_path = {}

    def start(self):
        for fn in self.kernels.values():
            fn.launches = 0

    def read(self, path, need=("phi_fwd", "phi_bwd"), none=CHOL_KERNELS):
        counts = {name: fn.launches for name, fn in self.kernels.items()}
        for name in need:
            check(counts[name] > 0, f"{name} was not launched in {path}")
        for name in none:
            check(counts[name] == 0, f"{name} was launched in {path}")
        self.by_path[path] = counts
        return counts

    def total(self, name):
        return sum(c[name] for c in self.by_path.values())

    def of(self, name):
        return {p: c[name] for p, c in self.by_path.items()}


def params_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def device_busy(fn, steps=10):
    """(device ms per call, wall ms per call, busy share, the six kernels
    with the most device ms per call) of ``steps`` calls under
    torch.profiler: the device time is the sum of the kernels' time on the
    card (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / steps
    # Kernels only: a CPU op (aten::mm) also carries the device time of the
    # kernels it launched, which would count it twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev = sum(e.self_device_time_total for e in events) / 1e3 / steps
    check(dev > 0, "torch.profiler recorded no device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return dev, wall, dev / wall, {
        e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top}


def grad_errors(g, ref):
    """Each gradient leaf's largest difference from ``ref``, relative to the
    leaf's largest entry; phase leaves, pure gauge (about zero), relative to
    the largest entry of any leaf."""
    top = max(float(t.abs().max()) for t in ref)
    errs = {}
    for field, a, b in zip(ref._fields, g, ref):
        den = top if "phase" in field else float(b.abs().max())
        errs[field] = float((a - b).abs().max()) / max(den, 1e-30)
    return errs


def streaming(dev, launches):
    """Phase 9, the streaming objective at the configuration of
    experiments/tpu_streaming_1m.py (N=1e6, D=256, S=56, M=200, block
    16384, adam lr 0.01), from random params made from SEED:

    (a) cost and gradient through ``loss_fn_streaming`` on the kernel route
        (K2f, K2b in pass 1; K1f, K1b in pass 2) against the GEMM route (K1f
        and K1b in both passes) and the dense ``loss_and_grad``, the two
        routes' launches counted each on its own;
    (b) five loss + grad + adam steps on each route, in turns, with ms per
        step, Mrows/s, the first and final cost, and the device-busy share;
    (c) the peak device memory of one step on each route and of the dense
        step, over what was allocated before it."""
    from scfgp_tpu_torch.data.datasets import synthetic_large
    from scfgp_tpu_torch.models.objective import loss_and_grad
    from scfgp_tpu_torch.models.params import SCFGPParams, init_params
    from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
    from scfgp_tpu_torch.opt.optimizers import make_optimizer, tree_add

    cfg = STREAM
    t0 = time.perf_counter()
    X_np, y_np = synthetic_large(n=cfg["N"], d=cfg["D"], seed=SEED)
    X, y = torch.as_tensor(X_np).to(dev), torch.as_tensor(y_np).to(dev)
    del X_np, y_np
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    p0 = SCFGPParams(*[t.to(dev) for t in init_params(
        torch.Generator().manual_seed(SEED), cfg["D"], cfg["S"], cfg["M"])])
    k2 = 2 * (cfg["S"] + cfg["M"])
    tx = make_optimizer("adam", {"learning_rate": 0.01})

    def grad(route, p=p0):
        if route == "dense":
            return loss_and_grad(p, X, y)
        return loss_and_grad_streaming(p, X, y, block_size=cfg["block"],
                                       stats_impl=route)

    def step(route, p, state):
        (cost, _), g = grad(route, p)
        delta, state = tx.update(g, state, p)
        return tree_add(p, delta), state, cost

    # (a) the kernel route against the GEMM route and the dense path
    launches.start()
    (cost, aux), g = grad("kernel")
    torch.cuda.synchronize()
    counts = launches.read("streaming", need=("phi_fwd", "phi_bwd",
                                              "gram_fwd", "gram_bwd"))
    out = {"kernel": (cost, g)}
    launches.start()
    (c, _), gr = grad("gemm")
    torch.cuda.synchronize()
    gemm_counts = launches.read("streaming_gemm",
                                none=CHOL_KERNELS + ("gram_fwd", "gram_bwd"))
    out["gemm"] = (c, gr)
    (c, _), gr = grad("dense")
    out["dense"] = (c, gr)
    torch.cuda.synchronize()
    agree = {}
    for a, b in (("kernel", "gemm"), ("kernel", "dense"), ("gemm", "dense")):
        e_cost = abs(float(out[a][0]) - float(out[b][0])) / abs(
            float(out[b][0]))
        e_grad = grad_errors(out[a][1], out[b][1])
        agree[f"{a}_vs_{b}"] = dict(cost_rel_err=e_cost, grad_rel_err=e_grad)
    L = aux.post.L.double()
    cond = float(torch.linalg.cond(L @ L.T))
    say("streaming_agreement", n=cfg["N"], d=cfg["D"], s=cfg["S"],
        m=cfg["M"], block=cfg["block"], data_s=t_data, cost=float(cost),
        cond_A=cond, launches=counts, gemm_launches=gemm_counts, **agree)
    for route, (c, gr) in out.items():
        check(math.isfinite(float(c))
              and all(bool(torch.isfinite(t).all()) for t in gr),
              f"streaming: {route} cost or gradient not finite")
    for pair, e in agree.items():
        check(e["cost_rel_err"] <= STREAM_COST_TOL
              and max(e["grad_rel_err"].values()) <= STREAM_GRAD_TOL,
              f"streaming: {pair} differ: {e}")
    del out, g

    # (b) five steps on each route, in turns
    def run(route):
        p, state, costs = p0, tx.init(p0), []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(cfg["steps"]):
            p, state, c = step(route, p, state)
            costs.append(c)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) * 1e3 / cfg["steps"],
                [float(c) for c in costs])

    runs = {"kernel": [], "gemm": []}
    for order in (("kernel", "gemm"), ("gemm", "kernel")):
        for route in order:
            runs[route].append(run(route))
    for route, rs in runs.items():
        state = tx.init(p0)
        dev_ms, wall_ms, busy, top = device_busy(
            lambda: step(route, p0, state), steps=2)
        ms = statistics.median(r[0] for r in rs)
        costs = rs[0][1]
        say("streaming_steps", route=route, steps=cfg["steps"],
            ms_per_step=ms, ms_per_step_turns=[r[0] for r in rs],
            mrows_per_s=cfg["N"] / ms / 1e3, first_cost=costs[0],
            final_cost=costs[-1], costs=costs,
            repeat_bitwise=rs[0][1] == rs[1][1], device_ms=dev_ms,
            profiled_wall_ms=wall_ms, busy=busy, busy_unprofiled=dev_ms / ms,
            top_kernels_ms=top)
        check(all(math.isfinite(c) for r in rs for c in r[1]),
              f"streaming: a {route} cost is not finite")
        check(costs[-1] < costs[0],
              f"streaming: the {route} cost did not fall: {costs}")

    # (c) peak memory of one step, over what was allocated before it
    def peak(route):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(route, p0, tx.init(p0))
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    peaks = {route: peak(route) for route in ("kernel", "gemm", "dense")}
    bound = STREAM_PEAK_BLOCKS * cfg["block"] * k2 * 4 + STREAM_PEAK_EXTRA
    say("streaming_memory", peak_bytes_over_resident=peaks, bound=bound,
        x_y_bytes=X.nbytes + y.nbytes)
    for route in ("kernel", "gemm"):
        check(peaks[route] <= bound, f"streaming: the {route} route's peak "
              f"{peaks[route]} exceeds the block bound {bound}")


def crossover_phase(launches, chol):
    """Phase 10: the crossover at its sizes on the card, its launches
    counted; each kernel leg's difference from the plain leg and the
    Neumann inverse's held to the bounds phase 3e found at that n (the
    same input)."""
    from scfgp_tpu_torch.experiments.chol_crossover import SIZES, crossover
    launches.start()
    t = time.perf_counter()
    res = crossover(SIZES, "cuda", iters=3, reps=3,
                    report=lambda line: say("crossover", **line))
    torch.cuda.synchronize()
    counts = launches.read("crossover", need=CHOL_KERNELS, none=())
    table = {n: {leg: row["device_ms"] for leg, row in cell["legs"].items()}
             for n, cell in res["sizes"].items()}
    say("crossover_table", device=res["device"], device_ms=table,
        seconds=time.perf_counter() - t, launches=counts)
    for n, cell in res["sizes"].items():
        tol = chol[n]["tol"]
        legs = cell["legs"]
        check(legs["kernel_chol"]["max_abs_err"] <= tol["L"]
              and legs["kernel_fused"]["max_abs_err"] <= max(tol["L"],
                                                             tol["Li"])
              and cell["neumann_err"] <= tol["Li"],
              f"crossover at n={n}: a leg disagrees: {cell}")


def batched_kernels_phase(dev, rng):
    """Phase 11a: K1f and K1b with a trial axis at BATCH_SHAPES, each trial
    bitwise the 2-D call on its own inputs and within k1_tolerance and
    k1b_tolerance of the batched plain version, bitwise repeatable; device
    times of the batched launch, of B 2-D launches and of the plain batched
    version.  Returns the rows of K1f and of K1b by shape name."""
    from scfgp_tpu_torch.ops.phi import (fourier_features_bwd_cuda,
                                         fourier_features_cuda,
                                         fourier_features_ref, phi_bwd_ref)

    def outputs(x):  # K1f gives one tensor, K1b three
        return list(x) if isinstance(x, tuple) else [x]

    rows = {"k1f": {}, "k1b": {}}
    for name, B, n, d, k in BATCH_SHAPES:
        X, F, p, s, g = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                         for a in (rng.rand(B, n, d), 3.0 * rng.randn(B, d, k),
                                   rng.uniform(0, 2 * np.pi, (B, k)),
                                   rng.uniform(0.5, 1.5, B),
                                   rng.randn(B, n, 2 * k)))
        for phase, kern, plain, tolerance, nargs in (
                ("k1f", fourier_features_cuda, fourier_features_ref,
                 k1_tolerance, 4),
                ("k1b", fourier_features_bwd_cuda, phi_bwd_ref,
                 k1b_tolerance, 5)):
            args = (X, F, p, s, g)[:nargs]
            trials = [tuple(t[b] for t in args) for b in range(B)]
            out, again = (outputs(kern(*args)) for _ in range(2))
            one_by_one = [outputs(kern(*t)) for t in trials]
            torch.cuda.synchronize()
            ref = outputs(plain(*args))
            err = [[float((o[b] - r[b]).abs().max()) for o, r in zip(out, ref)]
                   for b in range(B)]
            tol = [outputs(tolerance(*t)) for t in trials]

            def loop(kern=kern, trials=trials):
                for t in trials:
                    kern(*t)
            row = dict(
                b=B, n=n, d=d, k=k, max_abs_err=float(np.max(err)),
                per_trial_bitwise=all(
                    torch.equal(o[b], ob) for b in range(B)
                    for o, ob in zip(out, one_by_one[b])),
                bitwise=all(torch.equal(a, c) for a, c in zip(out, again)),
                within_tol=bool(np.all(np.asarray(err) <= np.asarray(tol))),
                ms=median_ms(lambda: kern(*args), reps=11, inner=5,
                             hide_host=True),
                two_d_ms=median_ms(loop, reps=5, inner=2, hide_host=True),
                plain_ms=median_ms(lambda: plain(*args), reps=11, inner=5,
                                   hide_host=True),
                call_ms=median_ms(lambda: kern(*args), reps=11, inner=5),
                two_d_call_ms=median_ms(loop, reps=5, inner=2))
            rows[phase][name] = row
            say(f"{phase}_batched", shape=name, **row)
            check(row["per_trial_bitwise"], f"batched {phase} at {name}: a "
                  "trial differs from its 2-D call")
            check(row["bitwise"], f"batched {phase} at {name} is not "
                  "bitwise repeatable")
            check(row["within_tol"], f"batched {phase} at {name} disagrees "
                  f"with the plain version: {err} > {tol}")
        del X, F, p, s, g, out, again, one_by_one, ref
        torch.cuda.empty_cache()
    return rows["k1f"], rows["k1b"]


def batch_fit_phase(launches):
    """Phase 11b: ``fit_fast_batch`` of BATCH_FIT_TRIALS boston trials at
    m=30 (experiments/boston_housing.py:44-56) against the same trials by
    sequential ``fit_fast`` with the same seeds, (1) in float32 through K1f
    and K1b, where K1b must launch once a step of the batch and each trial
    batched alone must equal its fit_fast bitwise, (2) in float32 with
    every product past Phi per trial (``per_trial_products``), and (3) in
    float64 with the plain feature map on the card, (2) and (3) at the JAX
    tolerances of tests/test_batch_fit.py:49-72 (see BATCH_FIT_*)."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_boston
    from scfgp_tpu_torch.experiments.boston_housing import OPT
    from scfgp_tpu_torch.models.model import fit_fast_batch

    data = [load_boston(seed=b)[:4] for b in range(BATCH_FIT_TRIALS)]

    def models(dtype):
        return [SCFGP(sparsity=20, nfeats=30, seed=b, device="cuda",
                      dtype=dtype) for b in range(BATCH_FIT_TRIALS)]

    def run(dtype, path):
        launches.start()
        bat = models(dtype)
        t = time.perf_counter()
        fit_fast_batch(bat, data, **OPT)
        t_bat = time.perf_counter() - t
        need = ("phi_fwd", "phi_bwd") if dtype == torch.float32 else ()
        counts = launches.read(path, need=need)
        launches.start()
        seq = models(dtype)
        t = time.perf_counter()
        for m, d in zip(seq, data):
            m.fit_fast(*d, **OPT)
        torch.cuda.synchronize()
        t_seq = time.perf_counter() - t
        seq_counts = launches.read(path + "_sequential", need=need)
        return bat, seq, t_bat, t_seq, counts, seq_counts

    def compare(bat, seq):
        hist = [(np.asarray(b.evals["COST"][1]), np.asarray(s.evals["COST"][1]))
                for b, s in zip(bat, seq)]
        common = [min(len(a), len(c)) for a, c in hist]
        return dict(
            lengths=[[len(a), len(c)] for a, c in hist],
            cost_rel_err=[float(np.max(np.abs(a[:n] - c[:n]) / np.abs(c[:n])))
                          for (a, c), n in zip(hist, common)],
            first_cost_rel_err=[
                float(np.max(np.abs(a[:BATCH_FIT_EXACT_STEPS]
                                 - c[:BATCH_FIT_EXACT_STEPS])
                             / np.abs(c[:BATCH_FIT_EXACT_STEPS])))
                for a, c in hist],
            params_err=[max(float(((x - y).abs() - BATCH_FIT_PARAM_RTOL
                                   * y.abs()).max()) for x, y in
                            zip(b.params, s.params)) for b, s in zip(bat, seq)],
            metric_rel_err={k: [abs(b.evals[k][1][-1] - s.evals[k][1][-1])
                                / abs(s.evals[k][1][-1])
                                for b, s in zip(bat, seq)]
                            for k in ("NMSE", "MNLP", "SCORE", "RMSE")})

    bat, seq, t_bat, t_seq, counts, seq_counts = run(torch.float32,
                                                     "fit_fast_batch")
    iters = max(len(m.evals["COST"][1]) for m in bat)
    f32 = compare(bat, seq)
    alone = models(torch.float32)
    for m, d in zip(alone, data):
        fit_fast_batch([m], [d], **OPT)
    alone_bitwise = [params_equal(a.params, s.params)
                     and a.evals["COST"][1] == s.evals["COST"][1]
                     for a, s in zip(alone, seq)]
    say("fit_fast_batch", trials=BATCH_FIT_TRIALS, dtype="float32",
        batch_seconds=t_bat, sequential_seconds=t_seq,
        batch_ms_per_trial=t_bat * 1e3 / BATCH_FIT_TRIALS,
        sequential_ms_per_trial=t_seq * 1e3 / BATCH_FIT_TRIALS,
        loop_iterations=iters, launches=counts, sequential_launches=seq_counts,
        NMSE=[m.evals["NMSE"][1][-1] for m in bat],
        sequential_NMSE=[m.evals["NMSE"][1][-1] for m in seq],
        alone_bitwise=alone_bitwise, **f32)
    check(counts["phi_bwd"] == iters, f"fit_fast_batch: K1b launched "
          f"{counts['phi_bwd']} times for {iters} steps of the batch")
    check(seq_counts["phi_bwd"] == sum(len(m.evals["COST"][1]) for m in seq),
          "sequential fit_fast: K1b did not launch once a step")
    check(all(alone_bitwise), "fit_fast_batch of one trial differs from its "
          f"fit_fast: {alone_bitwise}")
    check(max(f32["first_cost_rel_err"]) <= FIT_COST_TOL
          and all(math.isfinite(m.evals["NMSE"][1][-1]) for m in bat),
          f"fit_fast_batch in float32 strays from sequential fit_fast: {f32}")
    # The same batch with every product past Phi per trial: what is left
    # batched (the loop, K1f and K1b) must replay the sequential fits.
    launches.start()
    witness = models(torch.float32)
    with per_trial_products():
        fit_fast_batch(witness, data, **OPT)
    w_counts = launches.read("fit_fast_batch_per_trial_products")
    w_iters = max(len(m.evals["COST"][1]) for m in witness)
    f32w = compare(witness, seq)
    w_bitwise = [params_equal(a.params, s.params)
                 and params_equal(a.post, s.post)
                 and all(a.evals[k][1] == s.evals[k][1] for k in
                         ("COST", "NMSE", "MNLP", "SCORE", "RMSE"))
                 for a, s in zip(witness, seq)]
    say("fit_fast_batch", trials=BATCH_FIT_TRIALS, dtype="float32",
        products="per_trial", loop_iterations=w_iters, launches=w_counts,
        bitwise=w_bitwise, **f32w)
    check(w_counts["phi_bwd"] == w_iters, "fit_fast_batch with per-trial "
          f"products: K1b launched {w_counts['phi_bwd']} times for {w_iters} "
          "steps of the batch")
    check(all(a == c for a, c in f32w["lengths"])
          and max(f32w["cost_rel_err"]) <= BATCH_FIT_COST_RTOL
          and max(f32w["params_err"]) <= BATCH_FIT_PARAM_ATOL
          and max(max(v) for v in f32w["metric_rel_err"].values())
          <= BATCH_FIT_METRIC_RTOL,
          "fit_fast_batch in float32 with per-trial products differs from "
          f"sequential fit_fast: {f32w}")
    with plain_feature_map():
        bat, seq, t_bat, t_seq, counts, seq_counts = run(torch.float64,
                                                         "fit_fast_batch_f64")
    f64 = compare(bat, seq)
    say("fit_fast_batch", trials=BATCH_FIT_TRIALS, dtype="float64",
        feature_map="plain", batch_seconds=t_bat, sequential_seconds=t_seq,
        launches=counts, **f64)
    check(all(a == c for a, c in f64["lengths"])
          and max(f64["cost_rel_err"]) <= BATCH_FIT_COST_RTOL
          and max(f64["params_err"]) <= BATCH_FIT_PARAM_ATOL
          and max(max(v) for v in f64["metric_rel_err"].values())
          <= BATCH_FIT_METRIC_RTOL,
          f"fit_fast_batch in float64 differs from sequential fit_fast: {f64}")


def sweeps_phase(launches, workdir):
    """Phases 11c-11e: the ported drivers.  11c the boston sweep at full
    width, 50 trials x m in {10..50}, batched; 11d the floor-closing
    ensembles on seeds 0-2; 11e the co2 plain and composite fits, and the
    abalone and kin8nm sweeps with --quick at full N.  Each is one path of
    the launch counts and is held to the floor pins of
    tests/test_end_to_end.py."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_boston, surrogate_floor
    from scfgp_tpu_torch.experiments import abalone, boston_housing, co2, kin8nm

    def out(name):
        return os.path.join(workdir, name)

    # 11c
    launches.start()
    t = time.perf_counter()
    sweep = boston_housing.main(["--batched", "--out", out("boston")])
    t_sweep = time.perf_counter() - t
    counts = launches.read("boston_sweep")
    at = sweep["nfeats_choices"].index(SWEEP_PIN_M)
    ratios = [a / f for a, f in zip(sweep["per_trial"]["NMSE"][at],
                                    sweep["per_trial"]["floor_NMSE"][at])]
    pin = float(np.mean(ratios[:3]))
    say("boston_sweep", seconds=t_sweep, size_seconds=sweep["seconds"],
        nfeats=sweep["nfeats_choices"], trials=sweep["trials"],
        NMSE=sweep["metrics"]["NMSE"]["mean"],
        MNLP=sweep["metrics"]["MNLP"]["mean"],
        nmse_over_floor=sweep["nmse_over_floor"], plots=sweep["plots"],
        pin_m=SWEEP_PIN_M, pin_ratios_seeds_0_2=ratios[:3], pin_mean=pin,
        launches=counts)
    check(pin < SWEEP_PIN, f"boston sweep: mean NMSE/floor {pin} at m="
          f"{SWEEP_PIN_M} over seeds 0-2 is not under {SWEEP_PIN}")

    # 11d
    launches.start()
    rows = []
    for seed in range(3):
        Xt, yt, Xv, yv, _ = load_boston(seed=seed)
        m = SCFGP(sparsity=20, nfeats=20, seed=seed, device="cuda",
                  extra_basis=boston_housing.linear_basis)
        t = time.perf_counter()
        m.fit_ensemble(Xt, yt, Xv, yv, k=16, mix_best=8,
                       **dict(boston_housing.OPT, max_iter=1500,
                              max_cvrg=40))
        rows.append(dict(seconds=time.perf_counter() - t,
                         NMSE=m.evals["NMSE"][1][-1],
                         MNLP=m.evals["MNLP"][1][-1],
                         ratio=m.evals["NMSE"][1][-1] / surrogate_floor(
                             "boston_housing", Xv, yv)["NMSE"]))
    counts = launches.read("boston_ensemble")
    mean = float(np.mean([r["ratio"] for r in rows]))
    say("boston_at_floor", k=16, mix_best=8, seeds=rows, mean_ratio=mean,
        launches=counts)
    check(mean < ENSEMBLE_PIN, f"boston ensembles: mean NMSE/floor {mean} "
          f"is not under {ENSEMBLE_PIN}")

    # 11e
    launches.start()
    t = time.perf_counter()
    rec = co2.main(["--out", out("co2")])
    counts = launches.read("co2")
    say("co2", seconds=time.perf_counter() - t, **rec, launches=counts)
    check(rec["nmse_over_floor"] < CO2_PIN, f"co2 composite: NMSE/floor "
          f"{rec['nmse_over_floor']} is not under {CO2_PIN}")
    for name, driver in (("abalone", abalone), ("kin8nm", kin8nm)):
        launches.start()
        t = time.perf_counter()
        s = driver.main(["--quick", "--out", out(name)])
        counts = launches.read(name)
        say(name, seconds=time.perf_counter() - t, size_seconds=s["seconds"],
            nfeats=s["nfeats_choices"], RMSE=s["metrics"]["RMSE"]["mean"],
            MNLP=s["metrics"]["MNLP"]["mean"],
            nmse_over_floor=s.get("nmse_over_floor"), launches=counts)
        check(all(math.isfinite(v) for v in s["metrics"]["RMSE"]["mean"]),
              f"{name}: an RMSE is not finite")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    from scfgp_tpu_torch.models.model import recalibrated_c
    from scfgp_tpu_torch.models.objective import (
        EPSILON, Posterior, fourier_features, loss_and_grad, loss_from_phi,
        predict_from_phi, softplus, solve_posterior, sufficient_stats)
    from scfgp_tpu_torch.models.params import init_params
    from scfgp_tpu_torch.ops import build
    from scfgp_tpu_torch.ops.cholesky import (cholesky_cuda,
                                              cholesky_inverse_cuda,
                                              cholesky_inverse_kernel)
    from scfgp_tpu_torch.ops.gram import (gram_bwd_ref,
                                          sufficient_stats_bwd_cuda,
                                          sufficient_stats_cuda,
                                          sufficient_stats_ref)
    from scfgp_tpu_torch.ops.phi import (fourier_features_bwd_cuda,
                                         fourier_features_cuda,
                                         fourier_features_ref, phi_bwd_ref)
    from scfgp_tpu_torch.opt.optimizers import make_optimizer, tree_add

    # 1. card and precision -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    tf32 = torch.backends.cuda.matmul.allow_tf32
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        matmul_allow_tf32=tf32)
    check(tf32 is False, "TF32 float32 matmul is on: posterior GEMMs change")
    dev = torch.device("cuda")

    # 2. build K1f, K1b, K2f, K2b and K3/K4, one nvcc each, together -------
    t0 = time.perf_counter()
    names = ("phi_fwd", "phi_bwd", "gram_fwd", "gram_bwd", "cholesky")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.build, names)))
    ptxas = {name: [ln.strip() for ln in so.with_suffix(".log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name, so in libs.items()}
    say("build", seconds=time.perf_counter() - t0,
        libraries=[so.name for so in libs.values()], ptxas=ptxas)

    # 3. K1 against its plain version ---------------------------------------
    rng = np.random.RandomState(0)
    k1 = {}
    for name, n, d, k in K1_SHAPES:
        X, F, p = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in (rng.rand(n, d), 3.0 * rng.randn(d, k),
                             rng.uniform(0, 2 * np.pi, k)))
        s = torch.tensor(0.7, device=dev)
        got = fourier_features_cuda(X, F, p, s)
        again = fourier_features_cuda(X, F, p, s)
        torch.cuda.synchronize()
        ref = fourier_features_ref(X, F, p, s)
        err = float((got - ref).abs().max())
        tol = k1_tolerance(X, F, p, s)
        kern = lambda: fourier_features_cuda(X, F, p, s)  # noqa: E731
        plain = lambda: fourier_features_ref(X, F, p, s)  # noqa: E731
        k1[name] = dict(
            n=n, d=d, k=k, max_abs_err=err, tol=tol,
            bitwise=torch.equal(got, again),
            equals_plain=torch.equal(got, ref),
            ms=median_ms(kern, hide_host=True),
            plain_ms=median_ms(plain, hide_host=True),
            call_ms=median_ms(kern), plain_call_ms=median_ms(plain))
        say("k1_vs_plain", shape=name, **k1[name])
        check(k1[name]["bitwise"], f"K1 is not bitwise repeatable at {name}")
        check(got.shape == (n, 2 * k) and err <= tol,
              f"K1 disagrees with the plain version at {name}: {err} > {tol}")

    # 3b. K1b against its plain version ------------------------------------
    k1b = {}
    for name, n, d, k in K1_SHAPES:
        X, F, p, g = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (rng.rand(n, d), 3.0 * rng.randn(d, k),
                                rng.uniform(0, 2 * np.pi, k),
                                rng.randn(n, 2 * k)))
        s = torch.tensor(0.7, device=dev)
        got = fourier_features_bwd_cuda(X, F, p, s, g)
        again = fourier_features_bwd_cuda(X, F, p, s, g)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = phi_bwd_ref(X, F, p, s, g)
        leaves = [t.clone().requires_grad_() for t in (F, p, s)]
        auto = torch.autograd.grad(fourier_features_ref(X, *leaves),
                                   leaves, grad_outputs=g)
        tol = k1b_tolerance(X, F, p, s, g)
        err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        err_auto = [float((a - b).abs().max()) for a, b in zip(got, auto)]
        kern = lambda: fourier_features_bwd_cuda(X, F, p, s, g)  # noqa: E731
        plain = lambda: phi_bwd_ref(X, F, p, s, g)  # noqa: E731
        k1b[name] = dict(
            n=n, d=d, k=k, max_abs_err=max(err), err=err,
            err_vs_autograd=err_auto, tol=list(tol), bitwise=bitwise,
            ms=median_ms(kern, hide_host=True),
            plain_ms=median_ms(plain, hide_host=True),
            call_ms=median_ms(kern), plain_call_ms=median_ms(plain))
        say("k1b_vs_plain", shape=name, **k1b[name])
        check(bitwise, f"K1b is not bitwise repeatable at {name}")
        check(all(e <= t for e, t in zip(err, tol))
              and all(e <= t for e, t in zip(err_auto, tol)),
              f"K1b disagrees with the plain version at {name}: "
              f"{err}, {err_auto} > {tol}")

    # 3c, 3d. K2f and K2b against their plain versions -----------------------
    def k2_inputs(n, d, k, weighted):
        X, F, p, y, cbar, pbar = (
            torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (rng.rand(n, d), 3.0 * rng.randn(d, k),
                      rng.uniform(0, 2 * np.pi, k), rng.randn(n),
                      rng.randn(2 * k, 2 * k), rng.randn(2 * k)))
        w = (torch.as_tensor(np.arange(n) % 3 != 0, dtype=torch.float32,
                             device=dev) if weighted else None)
        return X, y, w, F, p, torch.tensor(0.7, device=dev), cbar, pbar

    def kernel_vs_plain(phase, name, kern, plain, tol, n, d, k):
        got, again = kern(), kern()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = plain()
        err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        row = dict(n=n, d=d, k=k, max_abs_err=max(err), err=err,
                   tol=list(tol), bitwise=bitwise,
                   ms=median_ms(kern, hide_host=True),
                   plain_ms=median_ms(plain, hide_host=True),
                   call_ms=median_ms(kern), plain_call_ms=median_ms(plain))
        say(phase, shape=name, **row)
        check(bitwise, f"{phase}: not bitwise repeatable at {name}")
        check(all(e <= t for e, t in zip(err, tol)),
              f"{phase}: disagrees with the plain version at {name}: "
              f"{err} > {tol}")
        return got, row

    k2f, k2b = {}, {}
    for name, n, d, k, weighted in K2_SHAPES:
        X, y, w, F, p, s, cbar, pbar = k2_inputs(n, d, k, weighted)
        got, k2f[name] = kernel_vs_plain(
            "k2f_vs_plain", name,
            lambda: sufficient_stats_cuda(X, y, w, F, p, s),
            lambda: sufficient_stats_ref(X, y, w, F, p, s),
            k2f_tolerance(X, F, p, s, y, w), n, d, k)
        check(torch.equal(got[0], got[0].T), f"K2f's Gram is not symmetric "
              f"at {name}")
        _, k2b[name] = kernel_vs_plain(
            "k2b_vs_plain", name,
            lambda: sufficient_stats_bwd_cuda(X, y, w, F, p, s, cbar, pbar),
            lambda: gram_bwd_ref(X, y, w, F, p, s, cbar, pbar),
            k2b_tolerance(X, F, p, s, y, w, cbar, pbar), n, d, k)

    # 3e. K4 and K3 against torch's pair ------------------------------------
    chol = cholesky_phase(dev)

    ref_phi = plain_fourier_features

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def counted(phase):
        n = fourier_features_cuda.launches
        check(n > counted.last, f"K1f was not launched in phase {phase}")
        counted.last = n
        return n

    launches = Launches(phi_fwd=fourier_features_cuda,
                        phi_bwd=fourier_features_bwd_cuda,
                        gram_fwd=sufficient_stats_cuda,
                        gram_bwd=sufficient_stats_bwd_cuda,
                        cholesky=cholesky_cuda,
                        cholesky_inverse=cholesky_inverse_cuda)

    def check_post(post, ref, what):
        errs = {f: rel_err(getattr(post, f), getattr(ref, f))
                for f in post._fields}
        check(max(errs.values()) <= POST_TOL, f"{what}: posterior {errs}")
        return errs

    def check_pred(got, ref, what):
        e_mu = float(np.abs(got[0] - ref[0]).max() / np.abs(ref[0]).max())
        e_sd = float(np.abs((got[1] - ref[1]) / ref[1]).max())
        check(e_mu <= PRED_TOL and e_sd <= PRED_TOL,
              f"{what}: predictions differ from the plain path by "
              f"{e_mu}, {e_sd}")
        return e_mu, e_sd

    def ref_predict(model, params, post, Xs):
        with torch.inference_mode():
            return model._unscale_moments(
                *predict_from_phi(params, post,
                                  ref_phi(params, model._scale_X(Xs))))

    # 4. serve the JAX-trained model ----------------------------------------
    launches.start()
    counted.last = 0
    Xt, yt, Xv, yv, meta = load_kin8nm(prop=0.8, seed=0)
    m, t_load = timed(lambda: SCFGP(device="cuda").load(CKPT))
    (mu, sd), t_full = timed(lambda: m.predict(Xv, yv))
    check(mu.shape == sd.shape == (len(Xv), 1), "prediction shape")
    check(np.isfinite(mu).all() and np.isfinite(sd).all() and (sd > 0).all(),
          "predictions not finite, or std <= 0")
    # Batched rows may take other GEMM kernels, so each output may round
    # differently: a 2K-term float32 dot product is within 2K*u*sum|terms|
    # of exact, and |Phi_k| <= s, so scaled means of two orders differ by at
    # most 2 * 2K * u * s * |alpha|_1; the variance bound follows from
    # |Phi Li^T|_j <= s * |Li_j|_1.  Original units scale by the largest
    # slope of the y-scaler's backward map over the predictive band.
    with torch.inference_mode():
        two_k = m.post.alpha.numel()
        s = float(torch.exp(m.params.b)) * math.sqrt(2.0 / m.M)
        r = m.post.Li.abs().sum(dim=1).double()
        noise = float(softplus(m.params.c))
        mu_f, sd_f = predict_from_phi(  # plain map: no K1 launch counted
            m.params, m.post, ref_phi(m.params, m._scale_X(Xv)))
        tol_mu_f = 2 * two_k * U32 * s * float(m.post.alpha.abs().sum())
        var_f = sd_f.double() ** 2 / noise - 1.0
        tol_var = (8 * two_k * U32 * s * s * float((r * r).sum())
                   + 2 * two_k * U32 * float(var_f.max()))
        tol_sd_f = noise * tol_var / (2 * float(sd_f.min()))
        h = 1e-3
        band = torch.cat([mu_f - sd_f, mu_f, mu_f + sd_f]).double()[:, None]
        bt = m.y_scaler.backward_transform
        slope = float(((bt(band + h) - bt(band - h)) / (2 * h)).abs().max())
    tol_mu, tol_sd = slope * tol_mu_f, slope * (tol_mu_f + tol_sd_f)
    batches = {}
    start = 0
    for b in (1, 17, 256):
        rows = slice(start, start + b)
        (mb, sb), t_b = timed(lambda: m.predict(Xv[rows]))
        check(np.isfinite(mb).all() and (sb > 0).all(), f"batch {b}")
        e_mu = float(np.abs(mb - mu[rows]).max())
        e_sd = float(np.abs(sb - sd[rows]).max())
        check(e_mu <= tol_mu and e_sd <= tol_sd,
              f"batch {b} differs from the full split: {e_mu}, {e_sd}")
        batches[b] = dict(seconds=t_b, max_abs_diff_mu=e_mu,
                          max_abs_diff_std=e_sd)
        start += b
    # The same model in float64 on the host (the plain version): the f32
    # kernel path must agree with it to the kernel-vs-plain tolerance.
    host = SCFGP(device="cpu", dtype=torch.float64).load(CKPT)
    e_host = check_pred((mu, sd), host.predict(Xv, yv), "card vs host f64")
    nmse, mnlp = m.evals["NMSE"][1][-1], m.evals["MNLP"][1][-1]
    check(abs(nmse - host.evals["NMSE"][1][-1]) <= 1e-3 * nmse,
          "NMSE on the card differs from the host's")
    say("serve", source=meta["source"], load_s=t_load, predict_full_s=t_full,
        batches=batches, tol_mu=tol_mu, tol_std=tol_sd, NMSE=nmse,
        MNLP=mnlp, vs_host_f64=e_host, k1_launches=counted("serve"))

    # 5. condition and update -----------------------------------------------
    _, t_set = timed(lambda: m.set_data(Xt, yt))
    with torch.inference_mode():
        cost_ref, aux_ref = loss_from_phi(m.params, ref_phi(m.params, m.X),
                                          m.y)
    e_post = check_post(m.post, aux_ref.post, "set_data")
    e_cost = abs(float(m.cost) - float(cost_ref)) / abs(float(cost_ref))
    check(e_cost <= COST_TOL, f"set_data cost differs: {e_cost}")
    (mu, sd), t_pred = timed(lambda: m.predict(Xv, yv))
    e_pred = check_pred((mu, sd), ref_predict(m, m.params, aux_ref.post, Xv),
                        "after set_data")
    say("set_data", rows=m.N, seconds=t_set, predict_s=t_pred,
        cost=float(m.cost), post_rel_err=e_post, cost_rel_err=e_cost,
        pred_rel_err=e_pred, NMSE=m.evals["NMSE"][1][-1],
        MNLP=m.evals["MNLP"][1][-1], k1_launches=counted("set_data"))

    _, t_upd = timed(lambda: m.update_data(Xv[:256], yv[:256]))
    with torch.inference_mode():
        post_ref = solve_posterior(
            sufficient_stats(ref_phi(m.params, m.X), m.y),
            torch.exp(2.0 * m.params.a))
    e_post = check_post(m.post, post_ref, "update_data")
    (mu, sd), t_pred = timed(lambda: m.predict(Xv[256:], yv[256:]))
    e_pred = check_pred((mu, sd),
                        ref_predict(m, m.params, post_ref, Xv[256:]),
                        "after update_data")
    say("update_data", rows=m.N, seconds=t_upd, predict_s=t_pred,
        post_rel_err=e_post, pred_rel_err=e_pred,
        NMSE=m.evals["NMSE"][1][-1], MNLP=m.evals["MNLP"][1][-1],
        k1_launches=counted("update_data"))

    p0 = m.params
    _, t_rec = timed(m.recalibrate_dispersion)
    with torch.inference_mode():
        c_ref = recalibrated_c(
            *predict_from_phi(p0, m.post, ref_phi(p0, m.X)), m.y, p0.c)
    e_c = abs(float(m.params.c) - c_ref)
    check(e_c <= C_TOL, f"recalibrated c differs: {e_c}")
    (mu, sd), t_pred = timed(lambda: m.predict(Xv[256:], yv[256:]))
    p_ref = p0._replace(c=torch.tensor(c_ref, device=dev))
    e_pred = check_pred((mu, sd), ref_predict(m, p_ref, m.post, Xv[256:]),
                        "after recalibrate_dispersion")
    say("recalibrate", seconds=t_rec, predict_s=t_pred, c=float(m.params.c),
        c_abs_err=e_c, pred_rel_err=e_pred, NMSE=m.evals["NMSE"][1][-1],
        MNLP=m.evals["MNLP"][1][-1], k1_launches=counted("recalibrate"))

    launches.read("serve", need=("phi_fwd",))

    # 6. train step: kernel path against plain path -------------------------
    Xt, yt, Xv, yv, _ = load_kin8nm(prop=0.8, seed=0)
    kin = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda")
    kin.set_data(Xt, yt)  # scaled data and a random init from the seed
    Xb = rng.randn(8192, 8)
    yb = np.sin(Xb.sum(axis=1)) + 0.1 * rng.randn(8192)
    gen = torch.Generator().manual_seed(SEED)
    steps = {
        "kin8nm": (kin.params, kin.X, kin.y),
        "bench": (type(kin.params)(*[t.to(dev) for t in init_params(
            gen, 8, 50, 200, torch.float32)]),
                  torch.as_tensor(Xb, dtype=torch.float32, device=dev),
                  torch.as_tensor(yb, dtype=torch.float32, device=dev)),
    }
    launches.start()
    train_step = {}
    for name, (params, X, y) in steps.items():
        (cost, aux), grads = loss_and_grad(params, X, y)
        with plain_feature_map():
            (cost_p, _), grads_p = loss_and_grad(params, X, y)
        torch.cuda.synchronize()
        e_cost = abs(float(cost) - float(cost_p)) / abs(float(cost_p))
        e_grad = grad_errors(grads, grads_p)
        check(all(math.isfinite(float(g.abs().max())) for g in grads),
              f"train step at {name}: a gradient is not finite")
        check(e_cost <= COST_TOL and max(e_grad.values()) <= GRAD_TOL,
              f"train step at {name}: kernel and plain paths differ: cost "
              f"{e_cost}, gradients {e_grad}")
        tx = make_optimizer(ADAM["algo"], ADAM["algo_params"])
        state = tx.init(params)

        def step():
            _, g = loss_and_grad(params, X, y)
            delta, _ = tx.update(g, state, params)
            return tree_add(params, delta)

        # Host time varies more than device time: the two paths are timed
        # in turns (kernel, plain, plain, kernel, ...).
        times = {"kernel": [], "plain": []}
        for turn in range(6):
            for path in (("kernel", "plain") if turn % 2 == 0
                         else ("plain", "kernel")):
                with (plain_feature_map() if path == "plain"
                      else contextlib.nullcontext()):
                    times[path].append(median_ms(step, reps=5, inner=5))
        dev_ms, wall_ms, busy, top = device_busy(step)
        with plain_feature_map():
            plain_dev_ms, plain_wall_ms, plain_busy, plain_top = \
                device_busy(step)
        train_step[name] = dict(
            n=int(X.shape[0]), d=int(X.shape[1]), s=params.S, m=params.M,
            cost=float(cost), cost_rel_err=e_cost, grad_rel_err=e_grad,
            step_ms=statistics.median(times["kernel"]),
            plain_step_ms=statistics.median(times["plain"]),
            step_ms_turns=times["kernel"], plain_step_ms_turns=times["plain"],
            device_ms=dev_ms, plain_device_ms=plain_dev_ms,
            busy=busy, plain_busy=plain_busy,
            profiled_wall_ms=wall_ms, plain_profiled_wall_ms=plain_wall_ms,
            top_kernels_ms=top, plain_top_kernels_ms=plain_top)
        say("train_step", config=name, **train_step[name])
    say("train_step_launches", **launches.read("train_step"))

    # 7. fit_fast: the reference kin8nm protocol at full width --------------
    def fit_fast(**extra):
        m = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda")
        m.fit_fast(Xt, yt, Xv, yv, **FIT_FAST_KW, **extra)
        return m

    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    launches.start()
    m, t_fit = timed(fit_fast)
    n_it = len(m.evals["COST"][1])
    ckpt = os.path.join(workdir.name, "fused.ckpt")
    seg = fit_fast(checkpoint_path=ckpt, checkpoint_every=CHECKPOINT_EVERY)

    class Crash(Exception):
        pass

    save = SCFGP.save

    def crash_after_first_save(self, path):
        save(self, path)
        raise Crash

    SCFGP.save = crash_after_first_save
    try:
        fit_fast(checkpoint_path=ckpt, checkpoint_every=CHECKPOINT_EVERY)
        check(False, "the simulated crash did not happen")
    except Crash:
        pass
    finally:
        SCFGP.save = save
    resumed = SCFGP(device="cuda").load(ckpt)
    crashed_at = int(resumed._fused_train_state["state"].it)
    resumed.set_data(Xt, yt)
    resumed.optimize_fused(Xv, yv, resume=True, recalibrate=True)
    fit_launches = launches.read("fit_fast")
    with plain_feature_map():
        plain, t_plain = timed(fit_fast)
    hist = np.asarray(m.evals["COST"][1])
    hist_p = np.asarray(plain.evals["COST"][1])
    nmse, mnlp = m.evals["NMSE"][1][-1], m.evals["MNLP"][1][-1]
    mse = m.evals["MSE"][1][-1]
    nmse_p = plain.evals["NMSE"][1][-1]
    const_mnlp = 0.5 * (1 + math.log(2 * math.pi * float(np.var(yv))))
    self_cal = mnlp - 0.5 * (1 + math.log(2 * math.pi * mse))
    e_hist = float(np.max(np.abs(hist[:20] - hist_p[:20])
                          / np.abs(hist_p[:20])))
    say("fit_fast", iterations=n_it, seconds=t_fit, plain_seconds=t_plain,
        plain_iterations=len(hist_p), NMSE=nmse, MNLP=mnlp,
        plain_NMSE=nmse_p, plain_MNLP=plain.evals["MNLP"][1][-1],
        const_MNLP=const_mnlp, self_calibration=self_cal,
        first20_cost_rel_err=e_hist, crashed_at=crashed_at,
        segmented_bitwise=params_equal(m.params, seg.params),
        resumed_bitwise=params_equal(m.params, resumed.params),
        launches=fit_launches)
    check(np.isfinite(hist).all() and np.isfinite([nmse, mnlp]).all()
          and all(torch.isfinite(t).all() for t in m.params),
          "fit_fast: a value is not finite")
    check(crashed_at < n_it, "fit_fast: the crash left nothing to resume")
    check(e_hist <= FIT_COST_TOL,
          f"fit_fast: first 20 costs differ from the plain map's by {e_hist}")
    check(mnlp < const_mnlp - 1.0, f"fit_fast: MNLP {mnlp} is not 1 nat "
          f"below the constant predictive's {const_mnlp}")
    check(self_cal < 0.30, f"fit_fast: self-calibration excess {self_cal}")
    check(abs(nmse - nmse_p) <= FIT_NMSE_TOL * nmse_p,
          f"fit_fast: NMSE {nmse} vs the plain map's {nmse_p}")
    check(params_equal(m.params, seg.params)
          and m.evals["COST"][1] == seg.evals["COST"][1],
          "fit_fast: the segmented run differs from the one-shot run")
    check(params_equal(m.params, resumed.params)
          and m.evals["COST"][1] == resumed.evals["COST"][1],
          "fit_fast: the resumed run differs from the one-shot run")

    # 8. fit: the host loop, checkpointed at 20 and resumed -----------------
    host_kw = dict(FIT_KW, max_iter=40)

    def fit(**extra):
        m = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda")
        m.fit(Xt, yt, Xv, yv, **{**host_kw, **extra})
        return m

    launches.start()
    full, t_host = timed(fit)
    ckpt = os.path.join(workdir.name, "host.ckpt")
    fit(max_iter=20, checkpoint_path=ckpt, checkpoint_every=20)
    cont = SCFGP(device="cuda").load(ckpt)
    cont.set_data(Xt, yt)
    # obj and algo come from the checkpoint; the other settings do not.
    cont.optimize(Xv, yv, resume=True, max_iter=40,
                  cvrg_tol=FIT_KW["cvrg_tol"], max_cvrg=FIT_KW["max_cvrg"])
    host_launches = launches.read("fit")
    hist_c = cont.evals["COST"][1]
    hist_c = hist_c[:20] + hist_c[21:]  # drop the 20-iteration run's final
    say("fit", iterations=len(full.evals["COST"][1]) - 1, seconds=t_host,
        NMSE=full.evals["NMSE"][1][-1], MNLP=full.evals["MNLP"][1][-1],
        resumed_bitwise=params_equal(full.params, cont.params),
        launches=host_launches)
    check(params_equal(full.params, cont.params)
          and hist_c == full.evals["COST"][1],
          "fit: the resumed host loop differs from the uninterrupted one")
    workdir.cleanup()

    # 9. streaming: N=1e6, D=256, S=56, M=200 at full width ------------------
    streaming(dev, launches)

    # 10. the Cholesky crossover -------------------------------------------
    crossover_phase(launches, chol)

    # 10b. the served kin8nm posterior through K3 ---------------------------
    srv = SCFGP(device="cuda").load(CKPT)
    srv.set_data(Xt, yt)
    launches.start()
    with torch.inference_mode():
        stats = sufficient_stats(fourier_features(srv.params, srv.X), srv.y)
        sig2_n = torch.exp(2.0 * srv.params.a)
        ref = solve_posterior(stats, sig2_n)
        A = stats.phiTphi + (sig2_n + EPSILON) * torch.eye(
            stats.phiTphi.shape[0], device=dev)
        L, Li = cholesky_inverse_kernel(A)
        beta = Li @ stats.phiTy
        post = Posterior(L=L, Li=Li, alpha=Li.T @ beta, beta=beta,
                         log_diag_L=torch.log(torch.diagonal(L)))
        torch.cuda.synchronize()
    counts = launches.read("posterior", need=("cholesky_inverse",), none=())
    ev = torch.linalg.eigvalsh(A.double())
    e_post = check_post(post, ref, "posterior through K3")
    say("posterior_k3", n2k=int(A.shape[0]), rows=srv.N,
        cond_A=float(ev[-1] / ev[0]), post_rel_err=e_post, tol=POST_TOL,
        launches=counts)

    # 11. batched sweeps and ensembles -------------------------------------
    k1_batch, k1b_batch = batched_kernels_phase(dev, rng)
    batch_fit_phase(launches)
    sweep_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_sweeps_")
    sweeps_phase(launches, sweep_dir.name)
    sweep_dir.cleanup()

    row554 = chol[CHOL_LIBRARY_SIZE]
    kernels = [("phi_fwd", "csrc/phi_fwd.cu", "scfgp_tpu/ops/phi.py:65",
                {**k1, **{"batch-" + n: r for n, r in k1_batch.items()}},
                k1f_work),
               ("phi_bwd", "csrc/phi_bwd.cu", "scfgp_tpu/ops/phi.py:73",
                {**k1b, **{"batch-" + n: r for n, r in k1b_batch.items()}},
                k1b_work),
               ("gram_fwd", "csrc/gram_fwd.cu", "scfgp_tpu/ops/gram.py:45",
                k2f, k2f_work),
               ("gram_bwd", "csrc/gram_bwd.cu", "scfgp_tpu/ops/gram.py:85",
                k2b, k2b_work),
               ("cholesky", "csrc/cholesky.cu",
                "scfgp_tpu/ops/cholesky.py:160",
                {"n554": dict(n=row554["n"],
                              max_abs_err=row554["err"]["L_k4"],
                              ms=row554["k4_ms"],
                              plain_ms=row554["k4_plain_ms"],
                              library_ms=row554["k4_library_ms"])},
                lambda n: chol_work(n, inverse=False)),
               ("cholesky_inverse", "csrc/cholesky.cu",
                "scfgp_tpu/ops/cholesky.py:247",
                {"n554": dict(n=row554["n"],
                              max_abs_err=max(row554["err"]["L"],
                                              row554["err"]["Li"]),
                              ms=row554["k3_ms"],
                              plain_ms=row554["k3_plain_ms"])},
                lambda n: chol_work(n, inverse=True))]

    def reading(row, work):
        shape = [row[key] for key in ("n", "d", "k") if key in row]
        trials = row.get("b", 1)  # a batched launch does B trials' work
        bound_ms, bound_by = bound(*(trials * w for w in work(*shape)))
        out = dict(max_abs_err=row["max_abs_err"], ms=row["ms"],
                   plain_ms=row["plain_ms"], bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=row.get("library_ms"),
                   shape=shape)
        if "b" in row:
            out.update(trials=trials, two_d_ms=row["two_d_ms"])
        return out

    line = []
    for name, src, replaces, rows, work in kernels:
        first, *beside = KERNELS_LINE_SHAPES.get(name, list(rows))
        line.append({
            "name": name, "route": "cuda", "source": "scfgp_tpu_torch/" + src,
            "replaces": replaces, "launches": launches.total(name),
            **reading(rows[first], work), "at": first,
            "beside": {at: reading(rows[at], work) for at in beside},
            "by_path": launches.of(name)})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
