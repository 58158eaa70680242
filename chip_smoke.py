#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, streaming, Cholesky, sweep,
Bayes, command-line and parallel paths on one card.

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
   prediction is held against the same computation, in the model's
   resolved GEMM arithmetic, with the plain feature map on the card;
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
   --quick, with the floor pins of tests/test_end_to_end.py;
12. the Bayes layer at the JAX campaign's kin8nm width (S=20, M=50, D=8,
   sampling dimension 1163) on the seed-0 split: 12a the chain-batched log
   posterior and gradient of 32 chains, kernel path against the plain map,
   one K1f and one K1b launch for all chains, device and wall ms and the
   busy share; 12b the fleet recipe (32 random-init HMC chains, 300 + 300
   transitions of 16 steps, per-chain adaptation) through the ported probe
   experiment, ``predict_bayes`` raw and recalibrated, pinned at NMSE <= 0.034
   and MNLP <= -1.56; 12c tempered HMC (8 chains, 100 + 200, at most 12
   rungs) through the ladder probe, then a second call that must reuse the
   persisted adaptation; 12d static NUTS, VI and minibatch SGLD at cut
   budgets, below the MAP arm's NMSE; 12e one diverging chain inside a
   batch, counted while the others move.  K1b must launch once per batched
   gradient;
13. the command line, the served predictor and the helpers: 13a
   ``run.main`` at the kin8nm protocol's width with --fused, its metrics
   bitwise those of the direct ``fit_fast``, then --ensemble 4 and --bayes
   hmc at the JAX CLI test's budget, and ``python -m scfgp_tpu_torch
   --config`` as a subprocess; 13b phase 4's model exported
   (``export_predictor``, K1f as the registered operator) at 256 rows,
   reloaded (``ServedPredictor``) and held against ``predict`` at 1, 17
   and 256 rows, one K1f launch a call, both times, the blob's size, and a
   CUDA blob refused on the CPU; 13c the native Box-Cox library built and
   loaded on this host, its lambdas on kin8nm's training inputs against
   SciPy's, ``set_data``'s seconds with each; 13d the exact GP on the
   boston surrogate in float64 within 1.25x of the floor; 13e
   ``graft_entry.entry()``;
14. the rest of the Bayes layer: 14a the chain-batched streaming log
   posterior at the kin8nm campaign width in blocks of 1024 rows, 4 K1f and
   2 K1b launches a block at 1, 8 and 32 chains, its kernel path against
   the plain map at each and against the dense log posterior, device and
   wall ms; 14b ``fit_bayes(sampler="hmc", streaming_block=1024,
   chain_init="map")`` at a cut budget below the MAP arm's NMSE, its
   streaming mixture against the dense mixture of the same draws, and
   ``recalibrate=True`` refused; 14c experiments/sgld_scale.py at N=1e6,
   D=256, S=M=128, 4 chains (pSGLD at B = 4096 and 16384, streaming ULA
   cut to 5 + 15 steps): draws/s and the ULA leg's peak memory, and one
   gradient of each leg's log posterior at the shapes the leg gives K1f
   and K1b, kernel path against the plain map; 14d the dynamic NUTS (30 +
   30) and the host-looped NUTS and HMC (2 transitions each) at kin8nm
   width, 8 chains, max_depth 6: accept rate, depths, divergences and K1b
   launches against 2^d a transition; 14e experiments/bench_hmc.py at 5 +
   5; 14f experiments/bayes_predictive.py --tiny on co2, seed 0, every
   arm: each finite Bayes arm's recalibrated MNLP below its raw one;
15. the parallel layer (``parallel/``), all in turn: 15a ``fit_fast(mesh=
   make_mesh())`` in a world of one rank over NCCL in this process,
   bitwise ``fit_fast()`` at the kin8nm protocol with the same launches;
   15b two ranks spawned on the card (``parallel/launch.py``) over gloo,
   which stages CUDA tensors through host memory inside its collectives:
   the DP loss and gradient at kin8nm width against one rank's at phase
   6's bounds, ``loss_fn_streaming(axis_name=)`` at N=1e6, D=256, S=56,
   M=200, block 16384 (5e5 rows a rank) on both routes against one
   rank's stream at phase 9's, ``tp_loss`` on a (1, 2) mesh over one
   block at phase 6's, ``fit_fast(mesh=)`` at the kin8nm protocol within
   phase 7's NMSE bound of 15a's, and ``fit_fast_batch(mesh=)`` of 3
   boston trials bitwise unsharded (every product past Phi per trial);
   each rank's digests equal; K1f and K1b against the plain map at each
   rank's shapes of the DP loss, the TP strip and its trial stack of
   fit_fast_batch, at phase 6's bounds; 15c
   experiments/synthetic_scaling.py at 1 and 2 ranks (two ranks share the
   card: steps/s, no scaling result), each rank's six counts held as
   every other path's; 15d chain-parallel sampling on 15b's two ranks, 4
   of 8 chains a rank: the dry run's chain-sharded HMC, HMC fleet, NUTS
   fleet and SGLD at its tiny shapes (``graft_entry.chain_parts``), then
   those four samplers at phase 12's width (dimension 1163, 6553 rows) at
   10 + 10 transitions, each gathered and held bitwise against the same
   sampler run unsharded in this process on the same seeded draws (while
   the ranks run 15b), its log density taken in blocks of a rank's
   chains (every accept decision equal), one K1f and one K1b launch a
   batched gradient on each rank; K1f and K1b against the plain map at
   the shapes only 15d gives them (a rank's chains on the 6553 rows, and
   on a pSGLD minibatch), on every rank; 60 s, checked;
16. the precision policy (``ops/dispatch.py``), all in turn: 16a the
   objective's Gram and Φ·L⁻ᵀ GEMMs with their backward GEMMs at the
   kin8nm, bench and streaming-block shapes, 2-D and with 4 trials, under
   IEEE, "default", "high", "highest" and bf16: torch.profiler must show a
   TF32 kernel under "default" only and a bf16 kernel under bf16, each
   product's error against float64 within its setting's rounding bound
   (bf16 against the plain upcast product), TF32's above IEEE's, the TF32
   switch off after every call, device ms beside IEEE's; 16b kin8nm
   ``fit_fast`` under "auto" (TF32) and under IEEE, a TF32
   fit in two segments and resumed from its first checkpoint bitwise the
   one-shot fit, ``fit_fast_batch`` of 3 boston trials under "auto", the
   streaming objective at phase 9's width under "default" against IEEE
   where the Gram dominates the jitter, and a cut ``fit_bayes(hmc)`` that
   must run no TF32 kernel under "auto" (and must under an explicit
   "default"); 16c experiments/precision_quality.py at one trial a class
   and the co2 raw legs.  Each profile (``utils/profiling.py::
   kernel_profile``) reports the least lag from a launch to its kernel.
   Phase 16 runs in a process of its own (``precision_child``), whose
   counts this one holds.

The launch counts of the six kernels are set to 0 just before each path
(the serving path, phases 4-5, each training phase, the streaming kernel
and GEMM routes, the crossover, the posterior through K3, and each path of
phases 11 to 16; in 15b and 15c each rank, and in 16 its process, counts
its own launches and hands them back) and read just after;
every training phase must launch K1f and K1b, the streaming kernel route
K1f, K1b, K2f and K2b, its GEMM route K1f and K1b but neither K2f nor K2b,
the crossover K4 and K3, the posterior K3, the Bayes paths K1f and K1b but
no K2 kernel; the
serving, training, streaming and Bayes paths must launch neither K3 nor
K4 (their posterior stays on torch's pair), and a served request exactly
one K1f and nothing else.  The line before the last is a JSON object with
each kernel's launches, error and times, its bound (the larger of its
FP32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s, from this
run's shapes) and the time of one library call for the same
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
# for K1f and K1b the bench configuration and the batched launches of phase
# 11a.
KERNELS_LINE_SHAPES = {"phi_fwd": ("block", "kin8nm", "bench",
                                   "batch-boston", "batch-kin8nm",
                                   "batch-d256", "batch-bayes",
                                   "batch-tempered"),
                       "phi_bwd": ("block", "kin8nm", "bench",
                                   "batch-boston", "batch-kin8nm",
                                   "batch-d256", "batch-bayes",
                                   "batch-tempered"),
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
# D=256, where both kernels take their wide design; and the 32 chains of
# phase 12's fleet at the Bayes width (S=20, M=50: K=50), and the 96
# trials (8 chains x 12 rungs) of phase 12c's tempering at that width.
BATCH_SHAPES = [("boston", 50, 455, 13, 70), ("kin8nm", 8, 6553, 8, 277),
                ("d256", 4, 4096, 256, 500), ("bayes", 32, 6553, 8, 50),
                ("tempered", 96, 6553, 8, 50)]
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

# Phase 12: the Bayes layer at the JAX campaign's kin8nm width (S=20, M=50,
# D=8: sampling dimension 3 + D S + M S = 1163) on the seed-0 split; 12a's
# batched gradient at the fleet's 32 chains.
BAYES_MODEL = dict(sparsity=20, nfeats=50)
BAYES_CHAINS = 32
# 12b, the fleet recipe (experiments/kin8nm_bayes_probe.py): pinned in law
# against the JAX package's three seeds (experiments/results/
# bayes_predictive/results.json: NMSE 0.0283 +- 0.0020, MNLP -1.602 +-
# 0.013), at about mean + 3 sigma.  Both beat that campaign's MAP (0.0641,
# -1.241) and ensemble (0.0499, -1.314) arms.
FLEET_NMSE_PIN, FLEET_MNLP_PIN = 0.034, -1.56
# 12c, the campaign's tempered budget; the second call (the persisted
# adaptation, no probe and no warmup) samples TEMPERED_REUSE_SAMPLES more.
TEMPERED_KW = dict(sampler="tempered", chains=8, num_warmup=100,
                   num_samples=200, num_integration_steps=16,
                   init_step_size=0.003, max_rungs=12)
TEMPERED_REUSE_SAMPLES = 30
# 12d, cut to fit the run: static NUTS of depth 5 (32 batched gradients a
# transition), VI and minibatch SGLD, each from fit_ensemble's members (VI
# from the MAP: it starts at the chains' mean).  Pinned below the MAP arm's
# NMSE.
MAP_NMSE = 0.064
CUT_ARMS = {
    "nuts": dict(sampler="nuts", chains=8, num_warmup=25, num_samples=25,
                 depth=5, init_step_size=0.003, shared_adaptation=False,
                 chain_init="ensemble", map_iters=200),
    "vi": dict(sampler="vi", chains=8, num_warmup=600, num_samples=50,
               chain_init="map", map_iters=300),
    "sgld": dict(sampler="sgld", chains=8, num_warmup=300, num_samples=150,
                 thin=2, batch_size=256, init_step_size=1e-5,
                 chain_init="ensemble", map_iters=200),
}


# Phase 14: the rest of the Bayes layer.  14a, the chain-batched streaming
# log posterior at the campaign's kin8nm width, blocks of 1024 rows (7
# blocks of the 6553, the last ragged), against the dense one: the same
# sums in another order, held at phase 9's streaming bounds; its kernel
# path against the plain map at phase 6's, at each chain count: 1, the 8
# chains of 14b and 14d, and 32.  A streaming gradient launches K1f 4 times
# a block (pass 1, pass 2, and both again in the backward's recompute) and
# K1b twice, whatever the chain count.
STREAM_BAYES_BLOCK = 1024
STREAM_BAYES_CHAINS = (1, 8, BAYES_CHAINS)
# 14b, fit_bayes over the streaming objective from the MAP, cut to fit the
# run; pinned below the MAP arm's NMSE.  Its streaming mixture against the
# dense mixture of the same draws differs as update_data's posterior does
# (the Gram summed in blocks): held at STREAM_MIX_TOL, relative (the mean to
# its largest value, the std each).
STREAM_FIT = dict(sampler="hmc", chains=8, num_warmup=20, num_samples=20,
                  num_integration_steps=16, init_step_size=0.003,
                  chain_init="map", map_iters=300,
                  streaming_block=STREAM_BAYES_BLOCK)
STREAM_MIX_TOL = 1e-3
# 14c, experiments/sgld_scale.py at full width (N=1e6, D=256, S=M=128, 4
# chains, block 16384): the pSGLD legs at the JAX budgets (20 + 50), the
# ULA leg cut to 5 + 15.  The ULA leg's peak over resident must stay under
# ULA_PEAK_BOUND: O(C x block x 2K), far below X's 1.02 GB.  Then each leg's
# log posterior, on SGLD_CHECK_ROWS rows of the driver's data and its 4
# initial chains, gives K1f and K1b the leg's shapes: the ULA leg's
# streaming one in blocks of 16384 (each copied to 4 x 16384 x 256), the
# pSGLD legs' on 4096 and 16384 drawn rows (4 x B x 256); one gradient of
# each through the kernels is held against the plain map at COST_TOL and
# GRAD_TOL, as 14a is.
ULA_ARGS = ["--warmup", "5", "--samples", "15"]
ULA_PEAK_BOUND = 2 << 30
SGLD_CHECK_ROWS = 2 * 16384
# 14d, the dynamic NUTS and the host-looped samplers on the kin8nm log
# posterior: 8 random-init chains, max_depth 6.  The host-looped entries
# are the dynamic NUTS and HMC under JAX's signatures, and their parity with
# JAX's is pinned on the CPU: here each takes 2 transitions at the initial
# step size.
DYNAMIC_NUTS = dict(num_warmup=30, num_samples=30, max_depth=6,
                    init_step_size=0.003)
HOST_NUTS = dict(DYNAMIC_NUTS, num_warmup=0, num_samples=2)
HOST_HMC = dict(num_warmup=0, num_samples=2, num_integration_steps=16,
                init_step_size=0.003)
# 14e, experiments/bench_hmc.py at 5 + 5; 14f, experiments/
# bayes_predictive.py --tiny on co2, seed 0, every arm.  Both are cut from
# 30 + 30 and --quick to keep the whole run well inside its time limit on
# a slow host (a run with them took 1092 s of 1200), and 14e again from 10
# + 10 when 15d came (a run took 1359 s on a slower host); the full budgets
# run apart from this script.
BENCH_HMC_ARGS = ["--warmup", "5", "--samples", "5"]
CAMPAIGN_ARGS = ["--tiny", "--datasets", "co2", "--seeds", "1"]


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


class PlainFeatures:
    """``FourierFeatures`` by the plain PyTorch version, differentiable by
    autograd, for the streaming objective's blocks."""

    @staticmethod
    def apply(X, Fcat, pcat, scale):
        from scfgp_tpu_torch.ops.phi import fourier_features_ref
        return fourier_features_ref(X, Fcat, pcat, scale)


@contextlib.contextmanager
def plain_feature_map():
    """Run the model's objective, dense, streaming and tensor-parallel, on
    the plain feature map: every loss, gradient and prediction inside skips
    K1f and K1b."""
    from scfgp_tpu_torch.models import objective
    from scfgp_tpu_torch.ops import streaming
    from scfgp_tpu_torch.parallel import tp
    kernel, blocks, strips = (objective.fourier_features,
                              streaming.FourierFeatures, tp.FourierFeatures)
    objective.fourier_features = plain_fourier_features
    streaming.FourierFeatures = tp.FourierFeatures = PlainFeatures
    try:
        yield
    finally:
        objective.fourier_features = kernel
        streaming.FourierFeatures, tp.FourierFeatures = blocks, strips


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
def per_trial_products(plain=False):
    """Run ``fit_fast_batch``'s objective with only its feature map batched:
    each trial's frequencies are derived alone and stacked, one K1f and one
    K1b launch serve all trials, and every product past Phi (Gram,
    Cholesky, moments, penalty, predictions) runs per trial on 2-D tensors.
    The loop, its masks, generators and optimizer state, and the
    validation metric stay batched.  Without a trial axis the objective is
    unchanged.  ``plain``: the batched feature map by its plain version."""
    from scfgp_tpu_torch.models import model, objective
    from scfgp_tpu_torch.models.params import (derive_frequencies,
                                               feature_scale)
    from scfgp_tpu_torch.ops.phi import FourierFeatures
    saved = model.loss_fn, model.loss_and_grad, model.predict_f

    def features(trials, X, basis_fn):
        if basis_fn is not None:
            raise NotImplementedError("per_trial_products: no extra basis")
        fr = [derive_frequencies(q) for q in trials]
        return (PlainFeatures if plain else FourierFeatures).apply(
            X, torch.stack([f.Fcat for f in fr]),
            torch.stack([f.pcat for f in fr]),
            torch.stack([feature_scale(q) for q in trials]))

    def loss_fn(p, X, y, w=None, basis_fn=None, **prec):
        if X.dim() == 2 or w is not None:
            return objective.loss_fn(p, X, y, w, basis_fn, **prec)
        trials = [trial_of(p, b) for b in range(X.shape[0])]
        Phi = features(trials, X, basis_fn)
        return stack_trials([
            objective.loss_from_phi(q, Phi[b].clone(), y[b].clone(), **prec)
            for b, q in enumerate(trials)])

    def loss_and_grad(p, X, y, w=None, basis_fn=None, **prec):
        return objective.value_and_grad(loss_fn, p, X, y, w=w,
                                        basis_fn=basis_fn, **prec)

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
        return self.record(path, {name: fn.launches
                                  for name, fn in self.kernels.items()},
                           need, none)

    def record(self, path, counts, need=("phi_fwd", "phi_bwd"),
               none=CHOL_KERNELS):
        """``read`` of counts taken elsewhere (another process's), every
        kernel's."""
        check(set(counts) == set(self.kernels),
              f"{path}: counts of {sorted(counts)}, not of every kernel")
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


def kernel_launches():
    """A ``Launches`` of the six kernels' wrappers (each counts its own
    launches)."""
    from scfgp_tpu_torch.ops.cholesky import (cholesky_cuda,
                                              cholesky_inverse_cuda)
    from scfgp_tpu_torch.ops.gram import (sufficient_stats_bwd_cuda,
                                          sufficient_stats_cuda)
    from scfgp_tpu_torch.ops.phi import (fourier_features_bwd_cuda,
                                         fourier_features_cuda)
    return Launches(phi_fwd=fourier_features_cuda,
                    phi_bwd=fourier_features_bwd_cuda,
                    gram_fwd=sufficient_stats_cuda,
                    gram_bwd=sufficient_stats_bwd_cuda,
                    cholesky=cholesky_cuda,
                    cholesky_inverse=cholesky_inverse_cuda)


def params_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def device_busy(fn, steps=10):
    """(device ms per call, wall ms per call, busy share, the six kernels
    with the most device ms per call) of ``steps`` calls after one
    (``utils/profiling.py::kernel_profile``)."""
    from scfgp_tpu_torch.utils.profiling import kernel_profile
    prof = kernel_profile(fn, calls=steps)
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:6]
    return (prof["device_ms"], prof["wall_ms"],
            prof["device_ms"] / prof["wall_ms"], {k[:60]: v for k, v in top})


def timed(fn):
    """``fn()`` and its wall seconds, from a synchronised start to a
    synchronised end."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


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


# The Bayes paths launch K1f and K1b only: no statistics kernel (the
# streaming Bayes objective is not ported) and no Cholesky kernel.
BAYES_NONE = CHOL_KERNELS + ("gram_fwd", "gram_bwd")


def random_chains(m, chains, seed):
    """``chains`` random positions (chains, P) in model ``m``'s reduced
    sampling space, from ``init_params`` with a generator seeded ``seed``,
    on the model's device."""
    from scfgp_tpu_torch.bayes import reduced_dim
    from scfgp_tpu_torch.models.params import init_params, pack_params
    P = reduced_dim(m.D, m.S, m.M)
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([pack_params(init_params(gen, m.D, m.S, m.M))[:P]
                        for _ in range(chains)]).to(m.X.device)


def bayes_gradient_phase(launches, m):
    """Phase 12a: the chain-batched log posterior and its gradient on model
    ``m``'s scaled data at BAYES_CHAINS random positions: the kernel path
    against the plain feature map, each chain's value within COST_TOL and
    each block of the gradient (a b c, l_F, r_F) within GRAD_TOL of its
    largest entry over the chains (the bounds of phase 6); one K1f and one
    K1b launch for all chains; device and wall ms per batched gradient and
    the device-busy share (torch.profiler)."""
    from scfgp_tpu_torch.bayes import batched_value_and_grad, make_logposterior
    theta = random_chains(m, BAYES_CHAINS, SEED)
    C, P = theta.shape
    vg = batched_value_and_grad(make_logposterior(m.X, m.y, m.D, m.S, m.M))
    vg(theta)  # the first call copies X and y to (C, N, D) and (C, N)
    torch.cuda.synchronize()
    launches.start()
    ld, g = vg(theta)
    torch.cuda.synchronize()
    counts = launches.read("bayes_gradient", none=BAYES_NONE)
    with plain_feature_map():
        ld_p, g_p = vg(theta)
    ld_err, g_err = chain_errors(ld, g, ld_p, g_p, m.D, m.S)
    dev_ms, wall_ms, busy, top = device_busy(lambda: vg(theta))
    with plain_feature_map():
        plain_dev_ms, plain_wall_ms, plain_busy, _ = device_busy(
            lambda: vg(theta))
    row = dict(chains=C, dim=P, rows=m.N, d=m.D, s=m.S, m=m.M,
               ld_rel_err=ld_err, grad_rel_err=g_err, device_ms=dev_ms,
               wall_ms=wall_ms, chain_device_ms=dev_ms / C,
               chain_wall_ms=wall_ms / C, busy=busy,
               call_ms=median_ms(lambda: vg(theta), reps=5, inner=5),
               plain_device_ms=plain_dev_ms, plain_wall_ms=plain_wall_ms,
               plain_busy=plain_busy, top_kernels_ms=top, launches=counts)
    say("bayes_gradient", **row)
    check(counts["phi_fwd"] == 1 and counts["phi_bwd"] == 1,
          f"one batched gradient of {C} chains launched {counts}")
    check(bool(torch.isfinite(ld).all() and torch.isfinite(g).all()),
          "bayes gradient: a value is not finite")
    check(ld_err <= COST_TOL and max(g_err.values()) <= GRAD_TOL,
          f"bayes gradient: kernel and plain paths differ: value {ld_err}, "
          f"gradient {g_err}")


def hmc_gradients(cfg, probe_warmup=0):
    """Batched gradients of an HMC or tempered run: L + 1 a transition."""
    return ((probe_warmup + cfg["num_warmup"] + cfg["num_samples"])
            * (cfg["num_integration_steps"] + 1))


def bayes_fleet_phase(launches, workdir):
    """Phase 12b: the fleet recipe through the ported probe experiment on the
    kin8nm seed-0 split, then ``predict_bayes`` raw and recalibrated; K1b
    launched once per batched gradient, the pins FLEET_*_PIN."""
    from scfgp_tpu_torch.experiments import kin8nm_bayes_probe as probe
    launches.start()
    out = probe.main(["--skip-tempered", "--out", workdir])
    counts = launches.read("bayes_fleet", none=BAYES_NONE)
    rec = out["arms"]["hmc_fleet32"]
    grads = hmc_gradients(rec["config"])
    say("bayes_fleet", floor_nmse=out["floor_nmse"], **rec,
        batched_gradients=grads,
        gradients_per_s=grads / rec["sampler_wall_s"], launches=counts)
    check(counts["phi_bwd"] == grads, f"the fleet's {grads} batched "
          f"gradients launched K1b {counts['phi_bwd']} times")
    check(np.isfinite([rec["NMSE"], rec["MNLP"]]).all(),
          "fleet: a metric is not finite")
    check(rec["NMSE"] <= FLEET_NMSE_PIN and rec["MNLP"] <= FLEET_MNLP_PIN,
          f"fleet: NMSE {rec['NMSE']} / MNLP {rec['MNLP']} miss the pins "
          f"{FLEET_NMSE_PIN} / {FLEET_MNLP_PIN}")


def bayes_tempered_phase(launches, data, floor):
    """Phase 12c: tempered HMC with the ladder probe (a short HMC warmup,
    then the energy-matched ladder), then a second call on the same data
    and configuration, which must reuse the persisted adaptation: no probe,
    no warmup, only its own sampling gradients."""
    from scfgp_tpu_torch.experiments.kin8nm_bayes_probe import run_arm
    from scfgp_tpu_torch.utils.metrics import regression_metrics
    Xt, yt, Xv, yv = data
    launches.start()
    rec, m = run_arm(Xt, yt, Xv, yv, floor, **TEMPERED_KW)
    counts = launches.read("bayes_tempered", none=BAYES_NONE)
    probe_w = max(min(TEMPERED_KW["num_warmup"], 100), 10) + 8
    grads = hmc_gradients(TEMPERED_KW, probe_w)
    say("bayes_tempered", **rec, batched_gradients=grads,
        gradients_per_fit_s=grads / rec["wall_s"], launches=counts)
    check(counts["phi_bwd"] == grads, f"tempered: {grads} batched gradients "
          f"launched K1b {counts['phi_bwd']} times")
    check(np.isfinite([rec["NMSE"], rec["MNLP"]]).all()
          and rec["swap_rate"] > 0.0,
          f"tempered: NMSE {rec['NMSE']}, MNLP {rec['MNLP']}, swap rate "
          f"{rec['swap_rate']}")
    import warnings
    launches.start()
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(Xt, yt, **dict(TEMPERED_KW,
                                   num_samples=TEMPERED_REUSE_SAMPLES))
    wall = time.perf_counter() - t
    counts = launches.read("bayes_tempered_reuse", none=BAYES_NONE)
    met = regression_metrics(*m.predict_bayes(Xv), np.reshape(yv, (-1, 1)))
    steps = next(iter(m._bayes_adaptation.values()))["steps_done"]
    grads = TEMPERED_REUSE_SAMPLES * (TEMPERED_KW["num_integration_steps"]
                                      + 1)
    say("bayes_tempered_reuse", wall_s=wall, NMSE=met["NMSE"],
        MNLP=met["MNLP"], swap_rate=float(m.bayes_result.swap_rate),
        steps_done=steps, batched_gradients=grads, launches=counts)
    check(counts["phi_bwd"] == grads and m.bayes_result.warmup_state is None,
          f"tempered reuse: {grads} sampling gradients but K1b launched "
          f"{counts['phi_bwd']} times (a probe or a warmup ran)")
    check(steps == TEMPERED_KW["num_warmup"] + TEMPERED_KW["num_samples"]
          + TEMPERED_REUSE_SAMPLES, f"tempered reuse: {steps} steps done")
    check(np.isfinite([met["NMSE"], met["MNLP"]]).all(),
          "tempered reuse: a metric is not finite")


def bayes_cut_arms_phase(launches, data, floor):
    """Phase 12d: static NUTS, VI and minibatch SGLD at CUT_ARMS' budgets;
    each must give finite predictions below the MAP arm's NMSE, launching
    K1b at least once per batched gradient of its sampler (the chain
    inits' fits launch it too)."""
    from scfgp_tpu_torch.experiments.kin8nm_bayes_probe import run_arm
    for name, kw in CUT_ARMS.items():
        launches.start()
        rec, _ = run_arm(*data, floor, **kw)
        counts = launches.read(f"bayes_{name}", none=BAYES_NONE)
        grads = {"nuts": (kw["num_warmup"] + kw["num_samples"])
                 * 2 ** kw.get("depth", 0),
                 "vi": kw["num_warmup"],
                 "sgld": kw["num_warmup"] + kw["num_samples"]
                 * kw.get("thin", 1)}[name]
        say("bayes_" + name, **rec, sampler_gradients=grads, launches=counts)
        check(counts["phi_bwd"] >= grads, f"{name}: {grads} batched "
              f"gradients launched K1b {counts['phi_bwd']} times")
        check(np.isfinite([rec["NMSE"], rec["MNLP"]]).all()
              and rec["NMSE"] < MAP_NMSE,
              f"{name}: NMSE {rec['NMSE']} (MNLP {rec['MNLP']}) is not "
              f"finite and below the MAP arm's {MAP_NMSE}")


def bayes_diverging_phase(launches, m):
    """Phase 12e: fleet HMC over 8 chains at the Bayes width, chain 0 put
    at b = 1000, where the feature scale overflows and its log posterior
    is not finite: it must stay where it is and count a divergence every
    transition while the other chains move, with one K1b launch per
    batched gradient."""
    from scfgp_tpu_torch.bayes import hmc_sample, make_logposterior
    theta = random_chains(m, 8, SEED + 1)
    theta[0, 1] = 1e3
    lp = make_logposterior(m.X, m.y, m.D, m.S, m.M)
    cfg = dict(num_warmup=5, num_samples=10, num_integration_steps=4)
    gen = torch.Generator(device=theta.device).manual_seed(SEED)
    launches.start()
    res = hmc_sample(lp, theta, gen, init_step_size=0.003,
                     shared_adaptation=False, **cfg)
    torch.cuda.synchronize()
    counts = launches.read("bayes_diverging", none=BAYES_NONE)
    with torch.no_grad():
        ld0 = float(lp(theta[:1])[0])
    draws = res.samples
    row = dict(chains=8, ld_chain0=ld0,
               finite=bool(torch.isfinite(draws).all()),
               stuck=torch.equal(draws[:, 0],
                                 theta[0].expand(cfg["num_samples"], -1)),
               others_moved=bool((draws[-1, 1:] != theta[1:]).any(1).all()),
               divergences=int(res.divergences),
               accept=float(res.accept_rate), launches=counts)
    say("bayes_diverging", **row)
    check(not math.isfinite(ld0), "the diverging chain's log posterior is "
          "finite")
    check(row["finite"] and row["stuck"] and row["others_moved"]
          and row["divergences"] >= cfg["num_samples"],
          f"a diverging chain stopped or spoiled the batch: {row}")
    check(counts["phi_bwd"] == hmc_gradients(cfg),
          f"diverging batch: K1b launched {counts['phi_bwd']} times")


def bayes_phase(launches, workdir):
    """Phase 12: the Bayes layer on the kin8nm seed-0 split at the JAX
    campaign's width, 12a-12e."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_kin8nm, surrogate_floor
    t = time.perf_counter()
    Xt, yt, Xv, yv, meta = load_kin8nm(seed=0)
    floor = (surrogate_floor(meta["name"], Xv, yv)["NMSE"]
             if meta["source"] == "synthetic-surrogate" else None)
    m = SCFGP(**BAYES_MODEL, seed=SEED, device="cuda")
    m.set_data(Xt, yt)
    bayes_gradient_phase(launches, m)
    bayes_fleet_phase(launches, workdir)
    bayes_tempered_phase(launches, (Xt, yt, Xv, yv), floor)
    bayes_cut_arms_phase(launches, (Xt, yt, Xv, yv), floor)
    bayes_diverging_phase(launches, m)
    say("bayes", seconds=time.perf_counter() - t)


def stream_blocks(n):
    return -(-n // STREAM_BAYES_BLOCK)


def chain_errors(ld, g, ld_ref, g_ref, d, sparsity):
    """Each chain's value relative to its reference, and each block of the
    gradient (a b c, l_F, r_F) relative to its largest reference entry over
    the chains."""
    ds = 3 + d * sparsity
    parts = (("abc", slice(0, 3)), ("l_F", slice(3, ds)),
             ("r_F", slice(ds, g.shape[1])))
    return (float(((ld - ld_ref).abs() / ld_ref.abs()).max()),
            {name: float((g[:, s] - g_ref[:, s]).abs().max()
                         / g_ref[:, s].abs().max()) for name, s in parts})


def check_plain(what, ld, g, e_plain):
    """A batched value and gradient: finite, and its kernel path within
    COST_TOL and GRAD_TOL of the plain map (``chain_errors``)."""
    check(bool(torch.isfinite(ld).all() and torch.isfinite(g).all()),
          f"{what}: a value is not finite")
    check(e_plain[0] <= COST_TOL and max(e_plain[1].values()) <= GRAD_TOL,
          f"{what}: kernel and plain differ: {e_plain}")


def streaming_bayes_gradient_phase(launches, m):
    """Phase 14a: the chain-batched streaming log posterior and gradient
    on model ``m``'s scaled data: at each chain count of
    STREAM_BAYES_CHAINS the same launches (4 K1f and 2 K1b a block) and the
    kernel path against the plain map (COST_TOL, GRAD_TOL); at the largest,
    each chain's value and each block of the gradient against the dense
    log posterior (STREAM_*_TOL), with device and wall ms."""
    from scfgp_tpu_torch.bayes import batched_value_and_grad, make_logposterior
    theta = random_chains(m, max(STREAM_BAYES_CHAINS), SEED)
    C, P = theta.shape
    vg = batched_value_and_grad(make_logposterior(
        m.X, m.y, m.D, m.S, m.M, streaming_block=STREAM_BAYES_BLOCK))
    blocks = stream_blocks(m.N)
    counts, e_plain = {}, {}
    for c in STREAM_BAYES_CHAINS:
        vg(theta[:c])
        torch.cuda.synchronize()
        launches.start()
        ld, g = vg(theta[:c])
        torch.cuda.synchronize()
        counts[c] = launches.read(f"streaming_bayes_gradient_c{c}",
                                  none=BAYES_NONE)
        with plain_feature_map():
            ld_p, g_p = vg(theta[:c])
        e_plain[c] = chain_errors(ld, g, ld_p, g_p, m.D, m.S)
        check_plain(f"streaming bayes gradient of {c} chains", ld, g,
                    e_plain[c])
    dense = batched_value_and_grad(make_logposterior(m.X, m.y, m.D, m.S,
                                                     m.M))
    ld_d, g_d = dense(theta)
    e_dense = chain_errors(ld, g, ld_d, g_d, m.D, m.S)
    dev_ms, wall_ms, busy, top = device_busy(lambda: vg(theta), steps=5)
    d_dev_ms, d_wall_ms, d_busy, _ = device_busy(lambda: dense(theta),
                                                 steps=5)
    say("streaming_bayes_gradient", chains=C, dim=P, rows=m.N,
        block=STREAM_BAYES_BLOCK, blocks=blocks,
        vs_dense=dict(ld_rel_err=e_dense[0], grad_rel_err=e_dense[1]),
        vs_plain={str(c): dict(ld_rel_err=e[0], grad_rel_err=e[1])
                  for c, e in e_plain.items()},
        device_ms=dev_ms, wall_ms=wall_ms, busy=busy,
        dense_device_ms=d_dev_ms, dense_wall_ms=d_wall_ms, dense_busy=d_busy,
        top_kernels_ms=top, launches={str(c): n for c, n in counts.items()})
    for c, n in counts.items():
        check(n["phi_fwd"] == 4 * blocks and n["phi_bwd"] == 2 * blocks,
              f"a streaming gradient of {c} chains over {blocks} blocks "
              f"launched {n}")
    check(e_dense[0] <= STREAM_COST_TOL
          and max(e_dense[1].values()) <= STREAM_GRAD_TOL,
          f"streaming bayes gradient: streaming and dense differ: {e_dense}")


def streaming_fit_bayes_phase(launches, data):
    """Phase 14b: ``fit_bayes`` over the streaming objective (STREAM_FIT),
    its streaming mixture against the dense mixture of the same draws,
    below the MAP arm's NMSE; ``recalibrate=True`` must raise."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.utils.metrics import regression_metrics
    import warnings
    Xt, yt, Xv, yv = data
    m = SCFGP(**BAYES_MODEL, seed=SEED, device="cuda")
    launches.start()
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(Xt, yt, **STREAM_FIT)
    wall = time.perf_counter() - t
    mu, sd = m.predict_bayes(Xv)
    torch.cuda.synchronize()
    counts = launches.read("streaming_fit_bayes", none=BAYES_NONE)
    met = regression_metrics(mu, sd, np.reshape(yv, (-1, 1)))
    m._bayes_streaming_block = 0
    mu_d, sd_d = m.predict_bayes(Xv)
    m._bayes_streaming_block = STREAM_BAYES_BLOCK
    e_mu = float(np.abs(mu - mu_d).max() / np.abs(mu_d).max())
    e_sd = float(np.abs((sd - sd_d) / sd_d).max())
    try:
        m.predict_bayes(Xv, recalibrate=True)
        refused = False
    except ValueError:
        refused = True
    grads = hmc_gradients(STREAM_FIT)
    res = m.bayes_result
    say("streaming_fit_bayes", **{k: v for k, v in STREAM_FIT.items()},
        NMSE=met["NMSE"], MNLP=met["MNLP"], wall_s=wall,
        sampler_wall_s=m.bayes_diagnostics_wall,
        accept=float(res.accept_rate), divergences=int(res.divergences),
        mix_rel_err=dict(mu=e_mu, std=e_sd), tol=STREAM_MIX_TOL,
        recalibrate_refused=refused, batched_gradients=grads,
        gradients_per_s=grads / m.bayes_diagnostics_wall, launches=counts)
    check(counts["phi_bwd"] >= 2 * stream_blocks(m.N) * grads,
          f"streaming fit_bayes: {grads} streaming gradients launched K1b "
          f"{counts['phi_bwd']} times")
    check(np.isfinite([met["NMSE"], met["MNLP"]]).all()
          and met["NMSE"] < MAP_NMSE,
          f"streaming fit_bayes: NMSE {met['NMSE']} is not finite and "
          f"below the MAP arm's {MAP_NMSE}")
    check(e_mu <= STREAM_MIX_TOL and e_sd <= STREAM_MIX_TOL,
          f"streaming mixture against dense: {e_mu}, {e_sd}")
    check(refused, "predict_bayes(recalibrate=True) after a streaming fit "
          "did not raise")


def sgld_scale_phase(launches, workdir):
    """Phase 14c: experiments/sgld_scale.py at full width, one leg a path:
    draws and steps a second, non-finite proposals, and the ULA leg's peak
    memory over resident under ULA_PEAK_BOUND; then one gradient of each
    leg's log posterior at its shapes against the plain map."""
    from scfgp_tpu_torch.experiments import sgld_scale
    legs = []
    for leg in ("psgld-b4096", "psgld-b16384", "ula-streaming"):
        launches.start()
        out = sgld_scale.main((ULA_ARGS if leg == "ula-streaming" else [])
                              + ["--legs", leg, "--out", workdir])
        torch.cuda.synchronize()
        row = dict(out["legs"][0], launches=launches.read(
            "sgld_scale_" + leg, none=BAYES_NONE))
        say("sgld_scale", **{k: out[k] for k in ("n", "d", "s", "m", "dim",
                                                 "chains")}, **row)
        legs.append(row)
        check(row["logdensity_finite"] and row["nonfinite"] == 0,
              f"sgld_scale {leg}: non-finite values: {row}")
    ula = legs[-1]
    steps = ula["warmup"] + ula["samples"]
    blocks = -(-out["n"] // ula["streaming_block"])
    # The per-chain copy of one block of X that every block pass makes
    # (K1f and K1b refuse a stride-0 X), four a block a gradient.
    block = torch.rand((ula["streaming_block"], out["d"]), device="cuda")
    copy_ms = median_ms(lambda: block.expand(
        out["chains"], *block.shape).contiguous(), hide_host=True)
    say("streaming_block_copy", chains=out["chains"],
        shape=list(block.shape), bytes=out["chains"] * block.nbytes,
        ms=copy_ms, copies_per_gradient=4 * blocks,
        ms_per_gradient=4 * blocks * copy_ms)
    # One warm gradient of a few rows, then 2 K1b a block a step.
    check(ula["launches"]["phi_bwd"] == 1 + 2 * blocks * steps,
          f"ULA: {steps} streaming gradients launched {ula['launches']}")
    check(ula["peak_bytes_over_resident"] <= ULA_PEAK_BOUND,
          f"ULA: peak {ula['peak_bytes_over_resident']} over resident")
    del block
    sgld_scale_kernels_phase(out, ula["streaming_block"])


def sgld_scale_kernels_phase(cfg, streaming_block):
    """Phase 14c, the kernels at the legs' shapes: each leg's estimator
    (``make_minibatch_value_and_grad``) on SGLD_CHECK_ROWS rows of
    sgld_scale's data and its initial chains, one gradient through K1f and
    K1b against the plain map (``check_plain``)."""
    from scfgp_tpu_torch.bayes import make_minibatch_value_and_grad
    from scfgp_tpu_torch.experiments import sgld_scale
    D, S, M = cfg["d"], cfg["s"], cfg["m"]
    X, y, init = sgld_scale.problem(SGLD_CHECK_ROWS, D, S, M, cfg["chains"],
                                    SEED, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    estimators = [(f"psgld-b{b}", b, 0, torch.randint(
        SGLD_CHECK_ROWS, (b,), generator=gen, device="cuda"))
        for b in sgld_scale.BATCHES]
    estimators.append(("ula-streaming", 0, streaming_block, None))
    for leg, batch, block, rows in estimators:
        vg = make_minibatch_value_and_grad(X, y, D, S, M, batch,
                                           streaming_block=block)
        ld, g = vg(init, rows)
        with plain_feature_map():
            ld_p, g_p = vg(init, rows)
        e_plain = chain_errors(ld, g, ld_p, g_p, D, S)
        say("sgld_scale_kernels", leg=leg, chains=cfg["chains"],
            rows=SGLD_CHECK_ROWS if rows is None else batch, d=D,
            k=S + M, streaming_block=block, ld_rel_err=e_plain[0],
            grad_rel_err=e_plain[1], tol=dict(ld=COST_TOL, grad=GRAD_TOL))
        check_plain(f"sgld_scale {leg} at its shapes", ld, g, e_plain)
    del X, y
    torch.cuda.empty_cache()


def dynamic_nuts_phase(launches, m):
    """Phase 14d: the dynamic NUTS, the host-looped NUTS and the host-
    looped HMC over 8 random-init chains of model ``m``'s log posterior:
    accept rate, mean depth, divergences, and K1b launches (one a batched
    gradient) against the bound 2^d a transition (its start and 2^d - 1
    leaves, d the deepest chain's depth)."""
    from scfgp_tpu_torch.bayes import (hmc_sample_host_looped,
                                       make_logposterior, nuts_sample,
                                       nuts_sample_host_looped)
    theta = random_chains(m, 8, SEED + 2)
    lp = make_logposterior(m.X, m.y, m.D, m.S, m.M)
    for name, run in (
            ("dynamic_nuts", lambda g: nuts_sample(lp, theta, g,
                                                   **DYNAMIC_NUTS)),
            ("nuts_host_looped", lambda g: nuts_sample_host_looped(
                lp, theta, g, **HOST_NUTS)),
            ("hmc_host_looped", lambda g: hmc_sample_host_looped(
                lp, theta, g, **HOST_HMC))):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        launches.start()
        t = time.perf_counter()
        res = run(gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launches.read(name, none=BAYES_NONE)
        row = dict(chains=8, accept=float(res.accept_rate),
                   divergences=int(res.divergences), wall_s=wall,
                   launches=counts)
        if "nuts" in name:
            d_max = res.depths.max(dim=1).values.cpu()
            bound = int((2 ** d_max).sum())
            transitions = res.depths.shape[0]
            row.update(mean_depth=float(res.mean_depth),
                       transitions=int(res.depths.shape[0]),
                       depth_hist=torch.bincount(
                           res.depths.flatten().cpu(),
                           minlength=DYNAMIC_NUTS["max_depth"] + 1).tolist(),
                       gradients=res.gradients, bound_2_to_d=bound,
                       k1b_per_transition=counts["phi_bwd"] / transitions,
                       bound_per_transition=bound / transitions)
            check(counts["phi_bwd"] == res.gradients <= bound,
                  f"{name}: K1b {counts['phi_bwd']}, gradients "
                  f"{res.gradients}, bound {bound}")
        else:
            grads = hmc_gradients(HOST_HMC)
            row.update(gradients=grads)
            check(counts["phi_bwd"] == grads,
                  f"{name}: {grads} gradients launched K1b "
                  f"{counts['phi_bwd']} times")
        row["gradients_per_s"] = row["gradients"] / wall
        say(name, **row)
        check(bool(torch.isfinite(res.samples).all())
              and 0.0 < row["accept"] <= 1.0,
              f"{name}: draws not finite or accept {row['accept']}")


def bench_hmc_phase(launches, workdir):
    """Phase 14e: experiments/bench_hmc.py at BENCH_HMC_ARGS: samples/s and
    ESS/s of each leg."""
    from scfgp_tpu_torch.experiments import bench_hmc
    launches.start()
    out = bench_hmc.main(BENCH_HMC_ARGS + ["--out", workdir])
    counts = launches.read("bench_hmc", none=BAYES_NONE)
    say("bench_hmc", legs=out, launches=counts)
    for leg, r in out.items():
        check(math.isfinite(r["samples_per_s"]) and r["samples_per_s"] > 0,
              f"bench_hmc {leg}: {r}")


def campaign_phase(launches, workdir):
    """Phase 14f: experiments/bayes_predictive.py at CAMPAIGN_ARGS.  Each
    Bayes arm whose metrics are finite must have its recalibrated MNLP
    below its raw MNLP; an arm that diverges (the co2 fleet does in the JAX
    campaign) is counted, not failed."""
    from scfgp_tpu_torch.experiments import bayes_predictive
    launches.start()
    t = time.perf_counter()
    out = bayes_predictive.main(CAMPAIGN_ARGS + ["--out", workdir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launches.read("campaign_co2", none=BAYES_NONE)
    arms = out["co2"]["rows"][0]["arms"]
    map_mnlp = arms["map"]["MNLP"]
    gaps, nonfinite = {}, []
    for arm, r in arms.items():
        if "MNLP_recal" not in r:
            continue
        if not np.isfinite([r["MNLP"], r["MNLP_recal"]]).all():
            nonfinite.append(arm)
            continue
        gaps[arm] = r["MNLP_recal"] - map_mnlp
        check(r["MNLP_recal"] < r["MNLP"],
              f"campaign co2 {arm}: MNLP_recal {r['MNLP_recal']} is not "
              f"below MNLP {r['MNLP']}")
    say("campaign_co2", arms=arms, map_mnlp=map_mnlp,
        recal_minus_map_mnlp=gaps, nonfinite_arms=nonfinite, wall_s=wall,
        launches=counts)


def bayes_rest_phase(launches, workdir):
    """Phase 14: the streaming log posterior and fit_bayes, the ported
    sampler-scale, dynamic-NUTS, throughput and campaign drivers, 14a-14f,
    each in turn."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    t = time.perf_counter()
    Xt, yt, Xv, yv, _ = load_kin8nm(seed=0)
    m = SCFGP(**BAYES_MODEL, seed=SEED, device="cuda")
    m.set_data(Xt, yt)
    times = {}
    for name, fn, *args in (
            ("14a", streaming_bayes_gradient_phase, launches, m),
            ("14b", streaming_fit_bayes_phase, launches, (Xt, yt, Xv, yv)),
            ("14c", sgld_scale_phase, launches, workdir),
            ("14d", dynamic_nuts_phase, launches, m),
            ("14e", bench_hmc_phase, launches, workdir),
            ("14f", campaign_phase, launches, workdir)):
        t0 = time.perf_counter()
        fn(*args)
        times[name] = time.perf_counter() - t0
    say("bayes_rest", seconds=time.perf_counter() - t, parts_s=times)


# Phase 13a: the command line at the kin8nm protocol's width (sparsity -1,
# nfeats 269), the TrainConfig defaults otherwise; --ensemble and --bayes at
# the JAX CLI test's budget (tests/test_utils.py:184-193).
CLI_ARGS = ["--dataset", "kin8nm", "--sparsity", "-1", "--nfeats", "269",
            "--max-iter", "200", "--seed", str(SEED)]
CLI_BAYES = ["--bayes", "hmc", "--chains", "2", "--samples", "10",
             "--warmup", "20"]
# 13b: the exported batch and the request batches held against predict.
SERVE_BATCH = 256
# 13d: tests/test_baselines.py:20-33, the exact GP within 1.25x of the
# boston surrogate's floor on the seed-1 split, 300 adam steps.
EXACT_GP_PIN = 1.25


def cli_phase(launches, workdir):
    """13a: ``python -m scfgp_tpu_torch --config`` as a subprocess while
    ``run.main`` runs in-process (``cli_runs_phase``)."""
    from scfgp_tpu_torch.run import main as cli
    # The module entry runs beside the in-process runs: most of its time is
    # the new process's start on the card.
    cfg = os.path.join(workdir, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"dataset": "co2", "model": {"sparsity": 2, "nfeats": 4,
                                               "seed": SEED},
                   "train": {"max_iter": 20, "fused": True}}, f)
    t_module = time.perf_counter()
    module = subprocess.Popen(
        [sys.executable, "-m", "scfgp_tpu_torch", "--config", cfg], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cli_runs_phase(launches, workdir, cli)
        out, err = module.communicate(timeout=300)
    finally:
        module.kill()
        module.wait()
    check(module.returncode == 0, f"python -m scfgp_tpu_torch failed:\n"
          f"{out[-2000:]}{err[-4000:]}")
    line = json.loads(out.strip().splitlines()[-1])
    say("cli_module", seconds=time.perf_counter() - t_module, result=line)
    check(np.isfinite(line["metrics"]["NMSE"]), "python -m: NMSE not finite")


def cli_runs_phase(launches, workdir, cli):
    """13a in-process: --fused against the direct ``fit_fast``, then
    --ensemble and --bayes."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.config import TrainConfig
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    t = time.perf_counter()
    launches.start()
    res = cli([*CLI_ARGS, "--fused", "--out", os.path.join(workdir, "cli")])
    counts = launches.read("cli_fit_fast")
    Xt, yt, Xv, yv, _ = load_kin8nm(seed=SEED)
    kw = TrainConfig(max_iter=200).as_optimize_kwargs()
    for key in ("nbatches", "batchsize"):
        kw.pop(key)
    direct = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda")
    direct.fit_fast(Xt, yt, Xv, yv, **kw)
    metrics = {k: float(direct.evals[k][1][direct.min_obj_ind])
               for k in ("MAE", "NMSE", "RMSE", "MNLP", "SCORE")}
    say("cli_fit_fast", seconds=time.perf_counter() - t,
        metrics=res["metrics"], direct_metrics=metrics,
        bitwise=res["metrics"] == metrics,
        checkpoint=os.path.exists(res["checkpoint"]), launches=counts)
    check(res["metrics"] == metrics, "CLI: metrics differ from the direct "
          f"fit_fast: {res['metrics']} vs {metrics}")
    check(os.path.exists(res["checkpoint"]), "CLI: no checkpoint written")

    t = time.perf_counter()
    launches.start()
    ens = cli([*CLI_ARGS, "--ensemble", "4"])
    counts = launches.read("cli_ensemble")
    say("cli_ensemble", seconds=time.perf_counter() - t,
        metrics=ens["metrics"], launches=counts)
    t = time.perf_counter()
    launches.start()
    bay = cli([*CLI_ARGS, *CLI_BAYES])
    counts = launches.read("cli_bayes", none=BAYES_NONE)
    say("cli_bayes", seconds=time.perf_counter() - t,
        metrics=bay["metrics"], bayes=bay["bayes"], launches=counts)
    check(np.isfinite(list(ens["metrics"].values())
                      + list(bay["metrics"].values())).all()
          and bay["bayes"]["draws"] > 0, "CLI: ensemble or bayes failed")


def served_phase(launches):
    """13b: phase 4's served kin8nm model exported at SERVE_BATCH rows,
    reloaded, and held against ``predict`` at 1, 17 and 256 rows; the
    time of a K1f call through the registered operator and through its
    wrapper at the full split."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    from scfgp_tpu_torch.models.params import (derive_frequencies,
                                               feature_scale)
    from scfgp_tpu_torch.ops.phi import fourier_features_cuda
    from scfgp_tpu_torch.utils.serving import (ServedPredictor,
                                               export_predictor)
    _, _, Xv, _, _ = load_kin8nm(prop=0.8, seed=0)
    m = SCFGP(device="cuda").load(CKPT)
    t = time.perf_counter()
    blob = export_predictor(m, SERVE_BATCH)
    t_export = time.perf_counter() - t
    t = time.perf_counter()
    served = ServedPredictor(blob, device="cuda")
    t_load = time.perf_counter() - t
    rows, start = {}, 0
    for b in (1, 17, SERVE_BATCH):
        Xb = Xv[start:start + b]
        start += b
        launches.start()
        got = served(Xb)
        counts = launches.read(f"served_{b}", need=("phi_fwd",),
                               none=CHOL_KERNELS + ("phi_bwd", "gram_fwd",
                                                    "gram_bwd"))
        check(counts["phi_fwd"] == 1, f"served {b} rows: K1f launched "
              f"{counts['phi_fwd']} times")
        ref = m.predict(Xb)
        e_mu = float(np.abs(got[0] - ref[0]).max() / np.abs(ref[0]).max())
        e_sd = float(np.abs((got[1] - ref[1]) / ref[1]).max())
        rows[b] = dict(
            mu_rel_err=e_mu, std_rel_err=e_sd,
            bitwise=bool(np.array_equal(got[0], ref[0])
                         and np.array_equal(got[1], ref[1])),
            served_ms=median_ms(lambda: served(Xb), reps=7, inner=5),
            predict_ms=median_ms(lambda: m.predict(Xb), reps=7, inner=5))
        check(got[0].shape == ref[0].shape and e_mu <= PRED_TOL
              and e_sd <= PRED_TOL, f"served {b} rows differ from predict: "
              f"{e_mu}, {e_sd}")
    try:
        ServedPredictor(blob, device="cpu")
        refused = False
    except ValueError:
        refused = True
    # What the registered operator adds to a K1f call, at the served width.
    with torch.inference_mode():
        fr = derive_frequencies(m.params)
        args = (m._scale_X(Xv), fr.Fcat, fr.pcat, feature_scale(m.params))
        op_ms = median_ms(lambda: torch.ops.scfgp_tpu_torch.phi_fwd(*args))
        wrapper_ms = median_ms(lambda: fourier_features_cuda(*args))
    say("served", batch=SERVE_BATCH, blob_bytes=len(blob),
        export_s=t_export, load_s=t_load, rows=rows, tol=PRED_TOL,
        cpu_load_refused=refused, op_call_ms=op_ms,
        wrapper_call_ms=wrapper_ms)
    check(refused, "a CUDA blob loaded on the CPU did not raise")


def native_phase(launches):
    """13c: the native Box-Cox fitter built and loaded on this host; its
    lambdas on kin8nm's training inputs at or below the SciPy objective
    (tests/test_scaler.py:117-130); set_data's seconds with each fit."""
    from scipy.stats import skew

    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data import native
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    from scfgp_tpu_torch.data.scaler import Scaler, _fit_boxcox_lambdas
    so = native.build()
    check(native.get_lib() is not None, f"native library {so} did not load")
    Xt, yt, _, _, _ = load_kin8nm(prop=0.8, seed=0)
    u = (Xt - Xt.min(0)) / (Xt.max(0) - Xt.min(0))
    lam_n = native.fit_boxcox_lambdas_native(u)
    lam_s = _fit_boxcox_lambdas(u)

    def obj(col, lm):
        return float(skew((np.sign(col) * np.abs(col) ** lm - 1) / lm,
                          bias=False) ** 2)

    objs = [(obj(u[:, j], lam_n[j]), obj(u[:, j], lam_s[j]))
            for j in range(u.shape[1])]
    m = SCFGP(device="cuda").load(CKPT)

    def set_data(is_native):
        m.X_scaler = Scaler(m.X_scaler.algo, native=is_native)
        m.y_scaler = Scaler(m.y_scaler.algo, native=is_native)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.set_data(Xt, yt)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    launches.start()
    times = {True: [], False: []}
    for turn in range(4):  # native, scipy, scipy, native, ...
        for is_native in ((True, False) if turn % 2 == 0
                          else (False, True)):
            times[is_native].append(set_data(is_native))
    counts = launches.read("set_data_native", need=("phi_fwd",))
    say("native", library=so.name,
        openmp=so == native.library_path(native.CXX_FLAGS),
        lambdas=lam_n.tolist(),
        scipy_lambdas=lam_s.tolist(), objective_native_scipy=objs,
        set_data_native_s=times[True], set_data_scipy_s=times[False],
        set_data_native_median_s=statistics.median(times[True][1:]),
        set_data_scipy_median_s=statistics.median(times[False][1:]),
        launches=counts)
    check(all(o_n <= o_s + 1e-6 for o_n, o_s in objs),
          f"native lambdas above the SciPy objective: {objs}")


def exact_gp_phase():
    """13d: the exact GP on the boston surrogate's seed-1 split in float64
    on the card, within EXACT_GP_PIN of the floor."""
    from scfgp_tpu_torch.baselines import ExactGP
    from scfgp_tpu_torch.data.datasets import load_boston, surrogate_floor
    Xt, yt, Xv, yv, meta = load_boston(seed=1)
    floor = surrogate_floor("boston_housing", Xv, yv)["NMSE"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    gp = ExactGP(steps=300, device="cuda").fit(Xt, yt)
    mu, std = gp.predict(Xv)
    t_fit = time.perf_counter() - t
    nmse = float(np.mean((mu - yv) ** 2) / np.var(yv))
    say("exact_gp", source=meta["source"], rows=len(Xt), fit_s=t_fit,
        dtype=str(gp.params.log_ls.dtype), device=str(gp.params.log_ls.device),
        NMSE=nmse, floor_NMSE=floor, nmse_over_floor=nmse / floor,
        pin=EXACT_GP_PIN, final_nlml=float(gp.nlml_history[-1]))
    check(gp.params.log_ls.dtype == torch.float64
          and gp.params.log_ls.is_cuda, "exact GP: not float64 on the card")
    check(np.all(std > 0) and nmse < EXACT_GP_PIN * floor,
          f"exact GP: NMSE {nmse} not within {EXACT_GP_PIN} x {floor}")


def entry_phase(launches):
    """13e: the port's ``entry()`` forward objective on the card."""
    from scfgp_tpu_torch.graft_entry import entry
    fn, args = entry()
    launches.start()
    cost, alpha = fn(*args)
    torch.cuda.synchronize()
    counts = launches.read("entry", need=("phi_fwd",))
    say("entry", cost=float(cost), alpha_shape=list(alpha.shape),
        launches=counts)
    check(math.isfinite(float(cost)) and bool(torch.isfinite(alpha).all()),
          "entry(): cost or alpha not finite")


def cli_serving_phase(launches):
    """Phase 13: the command line, the served predictor, the native
    helpers, the exact GP and ``entry()``."""
    t = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    cli_phase(launches, workdir.name)
    workdir.cleanup()
    served_phase(launches)
    native_phase(launches)
    exact_gp_phase()
    entry_phase(launches)
    say("cli_serving", seconds=time.perf_counter() - t)


# Phase 15: the parallel layer.  15a a world of one rank over NCCL in this
# process; 15b PARALLEL_RANKS ranks spawned on the one card over gloo (NCCL
# refuses two ranks on one device), after phase 2 built the kernels, at
# kin8nm width (DP loss and gradient, fit_fast(mesh)), BASELINE.json's
# multi-host width (streaming, 5e5 rows a rank, both routes), boston
# (fit_fast_batch(mesh) of PARALLEL_BATCH trials) and the streaming width
# on a (1, 2) mesh (TP, S+M = 256, one block of rows); 15c the scaling
# driver at 1 and 2 ranks; 15d chain-parallel sampling in 15b's spawn.
# Budget: ~90 s, and 60 s for 15d.
PARALLEL_RANKS = 2
PARALLEL_BATCH = 3
TP_MESH = (1, 2)
SCALING_ARGS = ["--ranks", "1", "2"]
# 15d: chain-parallel sampling on 15b's PARALLEL_RANKS ranks, each holding
# CHAIN_SHARDED / PARALLEL_RANKS of the chains: the dry run's four
# chain-sharded parts at its tiny shapes (graft_entry.chain_parts), then
# four samplers at phase 12's width (S=20, M=50, D=8: dimension 1163; the
# 6553 rows of the seed-0 split) at cut budgets, each held against the
# same sampler run unsharded in this process on the same seeded draws,
# its log density taken in blocks of a rank's chains: (sampler, budget,
# seed).  Budget: CHAIN_BUDGET_S, checked on the references' wall time
# plus a rank's (``chain_report``).
CHAIN_SHARDED = 8
CHAIN_BUDGET_S = 60
CHAIN_RUNS = {
    "hmc": ("hmc", dict(num_warmup=10, num_samples=10,
                        num_integration_steps=8, init_step_size=0.003), 2),
    "hmc_fleet": ("hmc", dict(num_warmup=10, num_samples=10,
                              num_integration_steps=8, init_step_size=0.003,
                              shared_adaptation=False), 3),
    "nuts_fleet": ("nuts_static", dict(num_warmup=10, num_samples=10,
                                       depth=3, init_step_size=0.003,
                                       shared_adaptation=False), 4),
    "sgld": ("sgld", dict(num_warmup=10, num_samples=10, step_size=1e-5), 5),
}
CHAIN_SGLD_BATCH = 512


def parallel_world1_phase(launches, data):
    """15a: ``fit_fast(mesh=make_mesh())`` in a world of one rank over
    NCCL, in this process, against ``fit_fast()`` at the kin8nm protocol:
    params and every metric but the wall time bitwise, the same K1f and
    K1b launches.  Returns the plain model."""
    import torch.distributed as dist
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.parallel import launch, make_mesh
    Xt, yt, Xv, yv = data

    def fit(**extra):
        m = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda")
        m.fit_fast(Xt, yt, Xv, yv, **FIT_FAST_KW, **extra)
        return m

    launches.start()
    plain = fit()
    counts = launches.read("15a fit_fast")
    with launch.local_world("cuda"):
        backend = dist.get_backend()
        launches.start()
        meshed = fit(mesh=make_mesh())
        mesh_counts = launches.read("15a fit_fast(mesh), 1 rank")
    evals_equal = all(plain.evals[k][1] == meshed.evals[k][1]
                      for k in plain.evals if k != "TIME(s)")
    same = {k: counts[k] == mesh_counts[k] for k in ("phi_fwd", "phi_bwd")}
    say("parallel_world1", backend=backend,
        params_bitwise=params_equal(plain.params, meshed.params),
        post_bitwise=params_equal(plain.post, meshed.post),
        evals_bitwise=evals_equal, launches=counts,
        mesh_launches=mesh_counts, NMSE=plain.evals["NMSE"][1][-1],
        iterations=len(plain.evals["COST"][1]))
    check(backend == "nccl", f"15a: a world of one joined over {backend}")
    check(params_equal(plain.params, meshed.params) and evals_equal
          and params_equal(plain.post, meshed.post),
          "15a: fit_fast(mesh) in a world of one is not fit_fast bitwise")
    check(all(same.values()), f"15a: launches differ: {counts} against "
          f"{mesh_counts}")
    return plain


def digest(tensors):
    """A hash of the tensors' bytes: equal digests, bitwise equal tensors."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def vs_plain(got, ref):
    """A kernel path's ``((cost, aux), grads)`` against the plain path's on
    the same inputs: the largest relative error of the cost (of any trial)
    and ``grad_errors``."""
    (c, _), g = got
    (c0, _), g0 = ref
    return dict(cost_rel_err=float(((c - c0).abs() / c0.abs()).max()),
                grad_rel_err=grad_errors(g, g0))


def parallel_config(device="cuda"):
    """15b's shapes and budgets, as ``parallel_rank_checks`` takes them."""
    return dict(
        device=device, need_kernels=device == "cuda",
        dp=dict(model=KIN8NM_MODEL, rows=None),
        fit=dict(model=KIN8NM_MODEL, rows=None, kw=FIT_FAST_KW),
        stream=dict(N=STREAM["N"], D=STREAM["D"], S=STREAM["S"],
                    M=STREAM["M"], block=STREAM["block"]),
        tp=dict(mesh=TP_MESH, rows=STREAM["block"]),
        batch=dict(B=PARALLEL_BATCH, model=dict(sparsity=20, nfeats=30),
                   rows=None))


def parallel_rank_checks(cfg):
    """15b, one rank: each check against the single-rank port on the same
    inputs (rank 0 computes the references), with its own launch counts
    (a path's counts set to 0 just before it and read just after).  The DP
    loss, the TP strip and this rank's trial stack of fit_fast_batch are
    also taken on the plain feature map (``vs_plain``): K1f and K1b at the
    shapes this rank gives them."""
    import torch.distributed as dist
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_boston, load_kin8nm
    from scfgp_tpu_torch.experiments.boston_housing import OPT
    from scfgp_tpu_torch.models import model as model_mod
    from scfgp_tpu_torch.models.model import fit_fast_batch
    from scfgp_tpu_torch.models.objective import loss_and_grad
    from scfgp_tpu_torch.models.params import SCFGPParams, init_params
    from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
    from scfgp_tpu_torch.parallel import (make_mesh, make_mesh2d,
                                          shard_rows, tp_loss_and_grad)

    dev = torch.device(cfg["device"])
    rank, W = dist.get_rank(), dist.get_world_size()
    need = ("phi_fwd", "phi_bwd") if cfg["need_kernels"] else ()
    launches = kernel_launches()
    mesh = make_mesh()
    data = mesh.group("data")
    out = {"rank": rank, "world": W, "backend": dist.get_backend()}
    times = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def compare(got, ref):
        (c, _), g = got
        (c0, _), g0 = ref
        return dict(cost=float(c), cost_rel_err=abs(float(c) - float(c0))
                    / abs(float(c0)), grad_rel_err=grad_errors(g, g0))

    # (1) the DP loss and gradient at kin8nm width
    t = time.perf_counter()
    Xt, yt, Xv, yv, _ = load_kin8nm(prop=0.8, seed=0)
    rows = cfg["dp"]["rows"]
    Xt, yt = Xt[:rows], yt[:rows]
    m = SCFGP(**cfg["dp"]["model"], seed=SEED, device=dev)
    m.set_data(Xt, yt)
    ref = loss_and_grad(m.params, m.X, m.y) if rank == 0 else None
    Xs, ys, ws = shard_rows(mesh, m.X, m.y)
    launches.start()
    got = loss_and_grad(m.params, Xs, ys, ws, axis_name=data)
    sync()
    counts = launches.read("15b dp", need=need)
    out["dp"] = dict(rows=int(Xs.shape[0]), launches=counts,
                     digest=digest(got[1]))
    with plain_feature_map():
        plain = loss_and_grad(m.params, Xs, ys, ws, axis_name=data)
    out["dp"]["vs_plain"] = dict(vs_plain(got, plain), n=int(Xs.shape[0]),
                                 d=m.D, k=m.S + m.M)
    if rank == 0:
        out["dp"].update(compare(got, ref))
    times["dp"] = time.perf_counter() - t

    # (2) streaming at the multi-host width, both routes
    t = time.perf_counter()
    st = cfg["stream"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X = torch.rand((st["N"], st["D"]), generator=gen, device=dev)
    y = torch.randn((st["N"],), generator=gen, device=dev)
    p0 = SCFGPParams(*[v.to(dev) for v in init_params(
        torch.Generator().manual_seed(SEED), st["D"], st["S"], st["M"])])
    routes = ("kernel", "gemm")
    ref = ({r: loss_and_grad_streaming(p0, X, y, block_size=st["block"],
                                       stats_impl=r) for r in routes}
           if rank == 0 else None)
    Xs, ys, ws = shard_rows(mesh, X, y)
    Xs, ys, ws = Xs.clone(), ys.clone(), ws.clone()
    X_tp, y_tp = X[:cfg["tp"]["rows"]].clone(), y[:cfg["tp"]["rows"]].clone()
    del X, y
    out["stream"] = {}
    for r in routes:
        launches.start()
        got = loss_and_grad_streaming(p0, Xs, ys, ws, block_size=st["block"],
                                      stats_impl=r, axis_name=data)
        sync()
        k2 = ("gram_fwd", "gram_bwd") if cfg["need_kernels"] else ()
        counts = launches.read(
            f"15b streaming {r}", need=need + (k2 if r == "kernel" else ()),
            none=CHOL_KERNELS + (() if r == "kernel" else
                                 ("gram_fwd", "gram_bwd")))
        out["stream"][r] = dict(rows=int(Xs.shape[0]), launches=counts,
                                digest=digest(got[1]))
        if rank == 0:
            out["stream"][r].update(compare(got, ref[r]))
    del Xs, ys, ws, ref
    times["stream"] = time.perf_counter() - t

    # (3) TP on a (1, 2) mesh at the streaming width
    t = time.perf_counter()
    mesh2 = make_mesh2d(*cfg["tp"]["mesh"])
    ref = loss_and_grad(p0, X_tp, y_tp) if rank == 0 else None
    X2, y2, w2 = shard_rows(mesh2, X_tp, y_tp)
    launches.start()
    got = tp_loss_and_grad(mesh2, p0, X2, y2, w2)
    sync()
    out["tp"] = dict(mesh=list(cfg["tp"]["mesh"]), rows=int(X2.shape[0]),
                     launches=launches.read("15b tp", need=need),
                     digest=digest(got[1]))
    with plain_feature_map():
        plain = tp_loss_and_grad(mesh2, p0, X2, y2, w2)
    out["tp"]["vs_plain"] = dict(
        vs_plain(got, plain), n=int(X2.shape[0]), d=st["D"],
        k=(st["S"] + st["M"]) // mesh2.shape["feature"])
    if rank == 0:
        out["tp"].update(compare(got, ref))
    del X_tp, y_tp, X2, y2, w2
    times["tp"] = time.perf_counter() - t

    # (4) fit_fast(mesh=...) at the kin8nm protocol
    t = time.perf_counter()
    rows = cfg["fit"]["rows"]
    launches.start()
    fm = SCFGP(**cfg["fit"]["model"], seed=SEED, device=dev)
    fm.fit_fast(Xt[:rows], yt[:rows], Xv, yv, mesh=mesh, **cfg["fit"]["kw"])
    sync()
    out["fit_fast"] = dict(launches=launches.read("15b fit_fast(mesh)",
                                                  need=need),
                           digest=digest(fm.params),
                           post_digest=digest(fm.post),
                           NMSE=fm.evals["NMSE"][1][-1],
                           MNLP=fm.evals["MNLP"][1][-1],
                           iterations=len(fm.evals["COST"][1]))
    times["fit_fast"] = time.perf_counter() - t

    # (5) fit_fast_batch(mesh=...) against unsharded, every product past
    # Phi per trial, so that a trial's bits do not depend on its batch
    t = time.perf_counter()
    bc = cfg["batch"]
    splits = []
    for b in range(bc["B"]):
        Xb, yb, Xbv, ybv = load_boston(seed=b)[:4]
        splits.append((Xb[:bc["rows"]], yb[:bc["rows"]], Xbv, ybv))

    def batch(**extra):
        ms = [SCFGP(**bc["model"], seed=b, device=dev)
              for b in range(bc["B"])]
        with per_trial_products():
            fit_fast_batch(ms, splits, **OPT, **extra)
        return ms

    launches.start()
    sharded = batch(mesh=mesh)
    sync()
    counts = launches.read("15b fit_fast_batch(mesh)", need=need)
    out["batch"] = dict(B=bc["B"], launches=counts,
                        digests=[digest(b.params) for b in sharded])
    # this rank's trial stack (padded), its first step's loss and gradient
    trials = model_mod._trial_slice(mesh, bc["B"])
    ms = [SCFGP(**bc["model"], seed=b, device=dev) for b in trials]
    for mb, b in zip(ms, trials):
        mb.set_data(*splits[b][:2])
    q = SCFGPParams(*[torch.stack(t) for t in zip(*[mb.params for mb in ms])])
    Xb, yb = (torch.stack([t.clone() for t in ts])
              for ts in ([mb.X for mb in ms], [mb.y for mb in ms]))
    with per_trial_products():
        got = model_mod.loss_and_grad(q, Xb, yb)
    with per_trial_products(plain=True):
        plain = model_mod.loss_and_grad(q, Xb, yb)
    out["batch"]["vs_plain"] = dict(
        vs_plain(got, plain), trials=trials, n=int(Xb.shape[1]),
        d=ms[0].D, k=ms[0].S + ms[0].M)
    if rank == 0:
        plain = batch()
        out["batch"].update(
            bitwise=[params_equal(a.params, b.params)
                     and a.evals["COST"][1] == b.evals["COST"][1]
                     and all(a.evals[k][1] == b.evals[k][1]
                             for k in ("NMSE", "MNLP", "SCORE"))
                     for a, b in zip(sharded, plain)],
            iterations=[len(b.evals["COST"][1]) for b in sharded],
            NMSE=[b.evals["NMSE"][1][-1] for b in sharded])
    times["batch"] = time.perf_counter() - t
    out["seconds"] = times
    if "chains" in cfg:  # 15d's ranks, in this spawn
        out["chains"] = chain_rank_checks(cfg["chains"])
    return out


def parallel_ranks_phase(launches, plain_fit):
    """15b: ``parallel_rank_checks`` on PARALLEL_RANKS ranks sharing the
    card over gloo, each check held to its phase's bound, every rank's
    digests equal, every rank's launch counts recorded.  The same ranks
    then run 15d's (``chain_rank_checks``), whose references this process
    computes meanwhile (``chain_references``)."""
    from scfgp_tpu_torch.parallel import launch
    cfg = parallel_config()
    cfg["chains"], data, q0 = chain_setup()
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(launch.run, parallel_rank_checks, PARALLEL_RANKS,
                            cfg)
        ref = chain_references(launches, data, q0)
        res = spawn.result()
    seconds = time.perf_counter() - t
    r0 = res[0]
    for r in res:
        for path in ("dp", "tp", "fit_fast", "batch"):
            launches.by_path[f"15b {path} (rank {r['rank']})"] = \
                r[path]["launches"]
        for route, row in r["stream"].items():
            launches.by_path[f"15b streaming {route} (rank {r['rank']})"] = \
                row["launches"]
    same = {k: len({r[k]["digest"] for r in res}) == 1
            for k in ("dp", "tp", "fit_fast")}
    same["stream"] = all(len({r["stream"][k]["digest"] for r in res}) == 1
                         for k in r0["stream"])
    same["batch"] = len({tuple(r["batch"]["digests"]) for r in res}) == 1
    nmse, nmse_1 = r0["fit_fast"]["NMSE"], plain_fit.evals["NMSE"][1][-1]
    plain = {f"{k} (rank {r['rank']})": r[k]["vs_plain"] for r in res
             for k in ("dp", "tp", "batch")}
    say("parallel_ranks_vs_plain", tol=dict(cost=COST_TOL, grad=GRAD_TOL),
        paths=plain)
    say("parallel_ranks", ranks=PARALLEL_RANKS, backend=r0["backend"],
        staging="gloo copies CUDA tensors through host memory inside its "
                "collectives; the port stages nothing itself",
        seconds=seconds, rank_seconds=r0["seconds"], digests_equal=same,
        dp=r0["dp"], stream=r0["stream"], tp=r0["tp"],
        fit_fast=dict(r0["fit_fast"], single_rank_NMSE=nmse_1),
        batch=r0["batch"])
    check(r0["backend"] == "gloo", f"15b: ranks joined over {r0['backend']}")
    check(all(same.values()), f"15b: ranks disagree: {same}")
    for name, row in (("dp", r0["dp"]), ("tp", r0["tp"])):
        check(row["cost_rel_err"] <= COST_TOL
              and max(row["grad_rel_err"].values()) <= GRAD_TOL,
              f"15b: {name} differs from the single rank: {row}")
    for route, row in r0["stream"].items():
        check(row["cost_rel_err"] <= STREAM_COST_TOL
              and max(row["grad_rel_err"].values()) <= STREAM_GRAD_TOL,
              f"15b: streaming {route} differs from the single rank: {row}")
    for what, row in plain.items():
        check(row["cost_rel_err"] <= COST_TOL
              and max(row["grad_rel_err"].values()) <= GRAD_TOL,
              f"15b: {what}: kernel and plain differ: {row}")
    check(abs(nmse - nmse_1) <= FIT_NMSE_TOL * nmse_1,
          f"15b: fit_fast(mesh) NMSE {nmse} vs one rank's {nmse_1}")
    check(all(r0["batch"]["bitwise"]),
          f"15b: fit_fast_batch(mesh) differs from unsharded: "
          f"{r0['batch']['bitwise']}")
    chain_report(launches, [r["chains"] for r in res], *ref)


def parallel_scaling_phase(launches, workdir):
    """15c: experiments/synthetic_scaling.py at 1 and 2 ranks on the one
    card; steps/s only (two ranks share the card: no scaling result)."""
    from scfgp_tpu_torch.experiments import synthetic_scaling
    rep = synthetic_scaling.main(SCALING_ARGS + ["--out", workdir])
    say("parallel_scaling", points=rep["points"])
    for pt in rep["points"]:
        for rank, counts in enumerate(pt["launches"]):
            launches.record(f"15c scaling, {pt['ranks']} rank(s) "
                            f"(rank {rank})", counts)
    check(all(pt["costs_equal"] for pt in rep["points"]),
          f"15c: a point's ranks disagree: {rep['points']}")


def chain_gradients(name):
    """The batched gradients of a run of CHAIN_RUNS: L + 1 an HMC
    transition, 2^depth a static NUTS one, one an SGLD step."""
    kind, kw, _ = CHAIN_RUNS[name]
    steps = kw["num_warmup"] + kw["num_samples"] * kw.get("thin", 1)
    if kind == "hmc":
        return steps * (kw["num_integration_steps"] + 1)
    if kind == "nuts_static":
        return steps * (1 << kw["depth"])
    return steps


def in_blocks(fn, block):
    """``fn`` of (C, P) positions (and any further arguments) taken
    ``block`` chains a call and concatenated: a log density, or an SGLD
    estimator's (values, gradients), keeping its ``n`` and
    ``batch_size``."""
    def blocked(q, *rest):
        outs = [fn(q[i:i + block], *rest) for i in range(0, q.shape[0],
                                                         block)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)
    for attr in ("n", "batch_size"):
        if hasattr(fn, attr):
            setattr(blocked, attr, getattr(fn, attr))
    return blocked


def chain_sample(name, data, q, gen, axis_name=None, block=None):
    """The run ``name`` of CHAIN_RUNS from positions ``q`` and the draws of
    ``gen``: chains sharded over ``axis_name``'s ranks where it is given;
    the log density (or estimator) taken ``block`` chains a call where
    that is given."""
    from scfgp_tpu_torch.bayes import (hmc_sample, make_logposterior,
                                       make_minibatch_value_and_grad,
                                       nuts_sample_static, sgld_sample)
    kind, kw, _ = CHAIN_RUNS[name]
    X, y, (D, S, M) = data
    if kind == "sgld":
        target = make_minibatch_value_and_grad(X, y, D, S, M,
                                               CHAIN_SGLD_BATCH)
    else:
        target = make_logposterior(X, y, D, S, M)
    if block:
        target = in_blocks(target, block)
    fn = {"hmc": hmc_sample, "nuts_static": nuts_sample_static,
          "sgld": sgld_sample}[kind]
    return fn(target, q, gen, axis_name=axis_name, **kw)


CHAIN_FIELDS = ("samples", "logdensities", "final_positions", "step_size",
                "inv_mass", "precond", "accept_rate", "divergences",
                "nonfinite")


def chain_fields(res):
    return {f: getattr(res, f).detach().cpu().numpy() for f in CHAIN_FIELDS
            if getattr(res, f, None) is not None}


def chain_rank_checks(cfg):
    """15d, one rank: the dry run's chain-sharded parts at its tiny shapes
    (``graft_entry.chain_parts``), then each run of CHAIN_RUNS on this
    rank's block of the chains, its launch counts set to 0 just before and
    read just after, gathered over the ranks.  Returns the counts, wall
    seconds and, on rank 0, the gathered fields; on every rank their
    digests.  ``cfg["device"]`` "cpu" rehearses it (the plain versions)."""
    import torch.distributed as dist
    from scfgp_tpu_torch.graft_entry import chain_parts, tiny_problem
    from scfgp_tpu_torch.parallel import (gather_chains, make_mesh,
                                          shard_chains)

    rank, W = dist.get_rank(), dist.get_world_size()
    dev = cfg["device"]
    need = ("phi_fwd", "phi_bwd") if dev == "cuda" else ()

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    launches = kernel_launches()
    out = {"rank": rank, "backend": dist.get_backend(), "seconds": {}}
    mesh = make_mesh()
    t = time.perf_counter()
    launches.start()
    X, y, dims = tiny_problem(W)
    out["dryrun"] = chain_parts(mesh, X, y, *dims, dev)
    sync()
    out["dryrun_launches"] = launches.read("15d dry run's chain parts",
                                           need=need, none=BAYES_NONE)
    out["seconds"]["dryrun"] = time.perf_counter() - t
    X, y = (torch.as_tensor(a, device=dev) for a in cfg["data"][:2])
    data = (X, y, cfg["data"][2])
    q = shard_chains(mesh, cfg["q0"], device=dev)
    for name in CHAIN_RUNS:
        gen = torch.Generator(device=dev).manual_seed(CHAIN_RUNS[name][2])
        sync()
        launches.start()
        t = time.perf_counter()
        res = chain_sample(name, data, q, gen, mesh.group("data"))
        sync()
        wall = time.perf_counter() - t
        counts = launches.read(f"15d {name}", need=need, none=BAYES_NONE)
        fields = chain_fields(gather_chains(mesh, res))
        out[name] = dict(launches=counts, wall_s=wall,
                         chains=int(q.shape[0]),
                         digest=digest([torch.as_tensor(v) for v in
                                        fields.values()]))
        if rank == 0:
            out[name]["fields"] = fields
        out["seconds"][name] = wall
    t = time.perf_counter()
    out["vs_plain"] = chain_vs_plain(data, q)
    out["seconds"]["vs_plain"] = time.perf_counter() - t
    return out


def chain_vs_plain(data, q):
    """15d's kernels against the plain map at the shapes only 15d gives
    them: one batched value and gradient of a rank's chains ``q`` on all
    the rows, and one pSGLD minibatch estimate of them (CHAIN_SGLD_BATCH
    rows, the same draw on every rank), each with ``chain_errors`` and
    whether every value is finite.  Its launches come after the runs'
    counts were read, so they count in none."""
    from scfgp_tpu_torch.bayes import (batched_value_and_grad,
                                       make_logposterior,
                                       make_minibatch_value_and_grad)
    X, y, (D, S, M) = data
    gen = torch.Generator(device=X.device).manual_seed(SEED)
    rows = torch.randint(X.shape[0], (CHAIN_SGLD_BATCH,), generator=gen,
                         device=X.device)
    calls = {
        "logposterior": (batched_value_and_grad(
            make_logposterior(X, y, D, S, M)), ()),
        "minibatch": (make_minibatch_value_and_grad(
            X, y, D, S, M, CHAIN_SGLD_BATCH), (rows,))}
    out = {}
    for what, (fn, rest) in calls.items():
        ld, g = fn(q, *rest)
        with plain_feature_map():
            ld_p, g_p = fn(q, *rest)
        e = chain_errors(ld, g, ld_p, g_p, D, S)
        out[what] = dict(
            chains=int(q.shape[0]),
            rows=int(rest[0].numel() if rest else X.shape[0]),
            finite=bool(torch.isfinite(ld).all() and torch.isfinite(g).all()),
            ld_rel_err=e[0], grad_rel_err=e[1])
    return out


def moved(samples):
    """Per chain and sampling transition after the first, whether the
    chain moved: an accepted proposal (a rejected one keeps the position
    bitwise)."""
    return np.any(samples[1:] != samples[:-1], axis=-1)


# 15d holds each sharded run bitwise against its unsharded reference: each
# reduction over the chains is taken on the chains gathered from the ranks
# by the unsharded sampler's own operation, each rank draws the unsharded
# draws and keeps its slice, and the reference takes its log density in
# blocks of a rank's chains, so every chain meets the same operations on
# the same bits.  Against one batch of all 8 chains the float32 batched
# log density rounds otherwise (cuBLAS picks its sums by batch size), and
# the trajectories carry that apart to an accept decision that flips
# (PERF.md, the findings on chain-parallel sampling).
COUNT_FIELDS = ("divergences", "nonfinite")


def chain_rows(res, ref):
    """15d's comparison of the ranks' results ``res`` with the unsharded
    fields ``ref``: by run, each field's largest error relative to its
    largest entry, the counts' equality, the flipped accept decisions
    (transition, counted from 0 with the warmup; chain), bitwise equality,
    and the ranks' agreement."""
    rows = {}
    for name in CHAIN_RUNS:
        got, want = res[0][name]["fields"], ref[name]
        kind, kw, _ = CHAIN_RUNS[name]
        flips = []
        if kind != "sgld":
            flips = [(kw["num_warmup"] + 1 + int(i), int(c))
                     for i, c in np.argwhere(moved(got["samples"])
                                             != moved(want["samples"]))]
        rows[name] = dict(
            rel_err={f: float(np.max(np.abs(got[f].astype(np.float64)
                                            - want[f]))
                              / max(float(np.max(np.abs(want[f]))), 1e-30))
                     for f in want if f not in COUNT_FIELDS},
            counts_equal={f: int(got[f]) == int(want[f])
                          for f in COUNT_FIELDS if f in want},
            accept_flips=flips,
            bitwise={f: bool(np.array_equal(got[f], want[f]))
                     for f in want},
            digests_equal=len({r[name]["digest"] for r in res}) == 1)
    return rows


def chain_setup():
    """15d's inputs: the ranks' config, the data ``(X, y, (D, S, M))`` on
    the card (phase 12's model on the seed-0 kin8nm split) and the
    CHAIN_SHARDED initial positions."""
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    Xt, yt, _, _, _ = load_kin8nm(prop=0.8, seed=0)
    m = SCFGP(**BAYES_MODEL, seed=SEED, device="cuda")
    m.set_data(Xt, yt)
    data = (m.X, m.y, (m.D, m.S, m.M))
    q0 = random_chains(m, CHAIN_SHARDED, SEED + 3)
    cfg = dict(device="cuda",
               data=(m.X.cpu().numpy(), m.y.cpu().numpy(), data[2]),
               q0=q0.cpu().numpy())
    return cfg, data, q0


def chain_references(launches, data, q0):
    """15d's references: each run of CHAIN_RUNS unsharded in this process
    from the same seeded draws, its log density taken in blocks of a
    rank's chains (one K1f and one K1b a block's gradient).  Returns the
    fields and the wall seconds by run."""
    block = CHAIN_SHARDED // PARALLEL_RANKS
    ref, ref_wall = {}, {}
    for name in CHAIN_RUNS:
        gen = torch.Generator(device="cuda").manual_seed(CHAIN_RUNS[name][2])
        torch.cuda.synchronize()
        launches.start()
        t = time.perf_counter()
        ref[name] = chain_fields(chain_sample(name, data, q0, gen,
                                              block=block))
        torch.cuda.synchronize()
        ref_wall[name] = time.perf_counter() - t
        counts = launches.read(f"15d {name}, unsharded", none=BAYES_NONE)
        n = chain_gradients(name) * PARALLEL_RANKS
        check(counts["phi_fwd"] == n and counts["phi_bwd"] == n,
              f"15d {name} unsharded: {n} blocks' gradients, launches "
              f"{counts}")
    return ref, ref_wall


def chain_report(launches, res, ref, ref_wall):
    """15d's checks of the ranks' results ``res`` against the references:
    every field bitwise (each field's largest error relative to its
    largest entry printed), every accept decision equal (a flip is printed
    with its transition and chain), every rank's gathered fields the same;
    one K1f and one K1b launch a batched gradient on each rank, no K2 or
    Cholesky kernel."""
    rows = chain_rows(res, ref)
    for name, row in rows.items():
        grads = chain_gradients(name)
        for r in res:
            counts = r[name]["launches"]
            launches.record(f"15d {name} (rank {r['rank']})", counts,
                            none=BAYES_NONE)
            check(counts["phi_fwd"] == grads and counts["phi_bwd"] == grads,
                  f"15d {name} rank {r['rank']}: {grads} gradients of "
                  f"{r[name]['chains']} chains, launches {counts}")
        kw = CHAIN_RUNS[name][1]
        row.update(gradients=grads, wall_s=[r[name]["wall_s"] for r in res],
                   transitions_per_s=(kw["num_warmup"] + kw["num_samples"])
                   / max(r[name]["wall_s"] for r in res),
                   accept_rate=float(ref[name].get("accept_rate", np.nan)),
                   launches=[r[name]["launches"] for r in res])
    for r in res:
        launches.record(f"15d dry run's chain parts (rank {r['rank']})",
                        r["dryrun_launches"], none=BAYES_NONE)
    plain = {f"{what} (rank {r['rank']})": row for r in res
             for what, row in r["vs_plain"].items()}
    # The references run beside 15b's ranks and the ranks' 15d after
    # their 15b: the sum is the most 15d can add to the smoke.
    seconds = sum(ref_wall.values()) + max(sum(r["seconds"].values())
                                           for r in res)
    say("parallel_chains", ranks=PARALLEL_RANKS, chains=CHAIN_SHARDED,
        backend=res[0]["backend"], runs=rows, dryrun=res[0]["dryrun"],
        vs_plain=plain, tol=dict(cost=COST_TOL, grad=GRAD_TOL),
        rank_seconds=[r["seconds"] for r in res],
        reference_seconds=ref_wall, seconds=seconds,
        budget_s=CHAIN_BUDGET_S)
    for what, row in plain.items():
        check(row["finite"] and row["ld_rel_err"] <= COST_TOL
              and max(row["grad_rel_err"].values()) <= GRAD_TOL,
              f"15d {what}: not finite, or kernel and plain differ: {row}")
    check(seconds <= CHAIN_BUDGET_S,
          f"15d took {seconds:.1f} s of its {CHAIN_BUDGET_S} s")
    check(len({json.dumps(r["dryrun"], sort_keys=True) for r in res}) == 1,
          "15d: the ranks' dry runs differ")
    for name, row in rows.items():
        check(not row["accept_flips"], f"15d {name}: accept decisions "
              f"flipped at (transition, chain) {row['accept_flips']}")
        check(all(row["counts_equal"].values()) and row["digests_equal"],
              f"15d {name}: counts or ranks differ: {row}")
        check(all(row["bitwise"].values()), f"15d {name}: sharded and "
              f"unsharded differ: {row['bitwise']}, {row['rel_err']}")


def parallel_phase(launches, workdir):
    """Phase 15, 15a-15c in turn (15b's spawn runs 15d's ranks too)."""
    from scfgp_tpu_torch.data.datasets import load_kin8nm
    Xt, yt, Xv, yv, _ = load_kin8nm(prop=0.8, seed=0)
    t = time.perf_counter()
    times = {}
    t0 = time.perf_counter()
    plain = parallel_world1_phase(launches, (Xt, yt, Xv, yv))
    times["15a"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for name, fn, *args in (("15b", parallel_ranks_phase, launches, plain),
                            ("15c", parallel_scaling_phase, launches,
                             workdir)):
        t0 = time.perf_counter()
        fn(*args)
        times[name] = time.perf_counter() - t0
    say("parallel", seconds=time.perf_counter() - t, parts_s=times)


# Phase 16: the precision policy (ops/dispatch.py).  16a: the objective's
# two GEMMs at the kin8nm, bench and streaming-block shapes (N, K), 2-D and
# with a trial axis, forward and backward, under each setting.
PRECISION_SHAPES = [("kin8nm", 6553, 277), ("bench", 8192, 250),
                    ("block", STREAM["block"], STREAM["S"] + STREAM["M"])]
PRECISION_TRIALS = 4
PRECISION_SETTINGS = {"ieee": {}, "default": {"mm_precision": "default"},
                      "high": {"mm_precision": "high"},
                      "highest": {"mm_precision": "highest"},
                      "bf16": {"mm_dtype": torch.bfloat16}}
# An IEEE float32 product of inner dimension n is within gamma_n = n u32
# of each entry of |A| |B| (Higham, ch. 3).  TF32 keeps 10 bits of each
# operand's mantissa, rounded or dropped: within U_TF32 of it either way,
# which adds 2 U_TF32 a term.  The bf16 GEMM sums exact float32 products in
# float32 like the plain upcast version, so the two differ by at most
# 2 gamma_n |A16| |B16|.
U_TF32 = 2.0 ** -10
# 16b: a cut fit_bayes (kin8nm at the Bayes width) whose every GEMM is
# profiled; the streaming objective at phase 9's width.
PRECISION_BAYES = dict(sampler="hmc", chains=8, num_warmup=3, num_samples=3,
                       num_integration_steps=4)
PRECISION_STREAM_STEPS = 3
# 16b compares the streaming objective under TF32 with IEEE where the Gram
# dominates the jitter, as in a trained fit: phase 9's init with its
# frequencies l_F scaled by 0.1 (smoother, correlated features) and the
# noise a = -1 (sig2_n = e^-2).  At the init itself the D=256 features are
# nearly orthogonal, cond(A) ~ 1.5, and TF32's rounding barely reaches the
# cost.  Here (cond(A) 4.5e3) the card reads a cost error of 4.3e-6 and
# gradient errors up to 0.19, in b's: a sum over 1e6 rows that cancels to
# a small value (r_F 1.1e-2, the other leaves below 4e-4; PERF.md).  The
# tolerances are about 4.7x and 2.7x those readings, and TF32 must move
# the cost or a gradient leaf.
PRECISION_STREAM_FREQ_SCALE = 0.1
PRECISION_STREAM_NOISE_A = -1.0
PRECISION_STREAM_COST_TOL = 2e-5
PRECISION_STREAM_GRAD_TOL = 0.5
# Calls in each profile of 16a.
PRECISION_PROFILE_CALLS = 3
# 16c: the cut quality experiment.
PRECISION_QUALITY_ARGS = ["--trials", "1", "--co2-bases", "raw",
                          "--skip-speed"]


def gemm_kind(name):
    """The arithmetic a cuBLAS GEMM kernel's name marks: "tf32" or "bf16"
    for a tensor-core kernel of that input type, else None.  The xmma
    kernels spell their types out (``sm90_xmma_gemm_f32f32_tf32f32_f32_*``
    for TF32; the IEEE ones ``*_f32f32_f32f32_f32_*``); CUTLASS's float32
    tensor-op kernels name a bf16 input (``*_tensorop_s16816gemm_bf16_*``,
    ``*_tensorop_s1688gemm_bf16_*``) and otherwise run TF32's 16x8x8 MMA
    (``cutlass_80_tensorop_s1688gemm_*``; the IEEE ones are
    ``*_simt_sgemm_*``); the nvjet kernels give one letter a type after
    ``nvjet_``, input first, and cuBLAS on an H100 runs the bf16 GEMMs
    with float32 output as ``nvjet_tss_*``."""
    low = name.lower()
    if "bf16" in low or low.startswith("nvjet_t"):
        return "bf16"
    if "tf32" in low or ("tensorop" in low and "s1688" in low):
        return "tf32"
    return None


def precision_gemms_phase(dev):
    """16a: each setting's Gram ΦᵀΦ and Φ·L⁻ᵀ with their backward GEMMs
    (``models/objective.py::_gemm``): the kernels cuBLAS ran, the error of
    the forward products against float64 within each setting's bound, the
    process-wide TF32 switch after the call, and device ms beside IEEE's."""
    from scfgp_tpu_torch.models.objective import _gemm
    from scfgp_tpu_torch.utils.profiling import kernel_profile
    rows = []
    for name, n, k in PRECISION_SHAPES:
        for B in (None, PRECISION_TRIALS):
            lead = () if B is None else (B,)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            Phi = 0.1 * torch.randn(*lead, n, 2 * k, device=dev,
                                    generator=gen)
            Li = 0.05 * torch.randn(*lead, 2 * k, 2 * k, device=dev,
                                    generator=gen).tril()
            pairs = ((Phi.mT, Phi), (Phi, Li.mT))  # (a, b) of each GEMM
            ref = [a.double() @ b.double() for a, b in pairs]
            mag = [a.abs().double() @ b.abs().double() for a, b in pairs]
            plain16 = [a.bfloat16().float() @ b.bfloat16().float()
                       for a, b in pairs]
            mag16 = [a.bfloat16().abs().double() @ b.bfloat16().abs().double()
                     for a, b in pairs]
            inner = (n, 2 * k)
            row = {"shape": name, "n": n, "k": k, "trials": B}
            for setting, kw in PRECISION_SETTINGS.items():
                P = Phi.clone().requires_grad_()
                L = Li.clone().requires_grad_()

                def step():
                    out = (_gemm(P.mT, P, **kw), _gemm(P, L.mT, **kw))
                    torch.autograd.grad(out[0].sum() + (out[1] ** 2).sum(),
                                        (P, L))
                    return tuple(t.detach() for t in out)

                before = torch.backends.cuda.matmul.allow_tf32
                prof = kernel_profile(step, calls=PRECISION_PROFILE_CALLS)
                out, names = prof["out"], sorted(prof["kernels"])
                after = torch.backends.cuda.matmul.allow_tf32
                err = [float((o.double() - r).abs().max() / r.abs().max())
                       for o, r in zip(out, ref)]
                if setting == "bf16":  # against the plain upcast product
                    ratio = [float(((o - p).abs().double()
                                    / (2 * m_ * U32 * c)).max())
                             for o, p, m_, c in zip(out, plain16, mag16,
                                                    inner)]
                else:
                    u = 2 * U_TF32 if setting == "default" else 0.0
                    ratio = [float(((o.double() - r).abs()
                                    / ((u + c * U32) * m_)).max())
                             for o, r, m_, c in zip(out, ref, mag, inner)]
                kinds = sorted({gemm_kind(x) for x in names} - {None})
                row[setting] = dict(
                    err=err, bound_ratio=ratio, kinds=kinds,
                    gemm_kernels=[x for x in names if gemm_kind(x)
                                  or "gemm" in x.lower()
                                  or "nvjet" in x.lower()],
                    tf32_after=after, launch_lag_us=prof["launch_lag_us"],
                    ms=median_ms(step, reps=5, inner=3, hide_host=True))
                check(before is False and after is False,
                      f"16a {name} B={B} {setting}: the TF32 switch is "
                      f"{after} after the call")
                check(max(ratio) <= 1.0, f"16a {name} B={B} {setting}: "
                      f"error outside its bound: {ratio}")
                want = {"default": ["tf32"], "bf16": ["bf16"]}.get(setting,
                                                                   [])
                check(kinds == want, f"16a {name} B={B} {setting}: kernels "
                      f"of kinds {kinds}, not {want}: {names}")
            for setting in PRECISION_SETTINGS:
                row[setting]["vs_ieee_ms"] = (row[setting]["ms"]
                                              / row["ieee"]["ms"])
            check(all(t > i for t, i in zip(row["default"]["err"],
                                            row["ieee"]["err"])),
                  f"16a {name} B={B}: TF32's error does not exceed IEEE's "
                  f"({row['default']['err']} vs {row['ieee']['err']})")
            say("precision_gemms", **row)
            rows.append(row)
            del Phi, Li, pairs, ref, mag, plain16, mag16
    torch.cuda.empty_cache()
    return rows


def precision_training_phase(launches, dev, workdir):
    """16b: kin8nm ``fit_fast`` under "auto" (TF32) and under IEEE, one of
    them the constructor's default; two segments under TF32 and a resume
    from the first checkpoint, bitwise one run; ``fit_fast_batch`` of 3
    boston trials under "auto"; the streaming objective at phase 9's width
    under "default" against IEEE; a cut ``fit_bayes(hmc)`` under "auto",
    profiled whole, which must run no TF32 kernel (and one under an
    explicit "default", which must)."""
    import shutil
    import warnings
    from scfgp_tpu_torch import SCFGP
    from scfgp_tpu_torch.data.datasets import load_boston, load_kin8nm
    from scfgp_tpu_torch.experiments.boston_housing import OPT
    from scfgp_tpu_torch.models.model import fit_fast_batch
    from scfgp_tpu_torch.models.params import SCFGPParams, init_params
    from scfgp_tpu_torch.ops.dispatch import (DEFAULT_MM_PRECISION,
                                              resolve_mm_precision)
    from scfgp_tpu_torch.ops.streaming import loss_and_grad_streaming
    from scfgp_tpu_torch.utils.profiling import kernel_profile
    Xt, yt, Xv, yv, _ = load_kin8nm(prop=0.8, seed=0)
    const_mnlp = 0.5 * (1 + math.log(2 * math.pi * float(np.var(yv))))
    fits = {}
    for leg, precision in (("auto", "auto"), ("ieee", None)):
        launches.start()
        m = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda",
                  mm_precision=precision)
        t = time.perf_counter()
        m.fit_fast(Xt, yt, Xv, yv, **FIT_FAST_KW)
        torch.cuda.synchronize()
        fits[leg] = dict(setting=precision, resolved=m.mm_precision,
                         seconds=time.perf_counter() - t,
                         iterations=len(m.evals["COST"][1]),
                         NMSE=m.evals["NMSE"][1][-1],
                         MNLP=m.evals["MNLP"][1][-1],
                         launches=launches.read(f"16b fit_fast ({leg})"))
        check(math.isfinite(fits[leg]["NMSE"])
              and math.isfinite(fits[leg]["MNLP"]),
              f"16b fit_fast ({leg}): {fits[leg]}")
    # Phase 7's quality anchor holds IEEE; TF32 is reported (PERF.md: on
    # kin8nm it is not quality-neutral, so it is not the default).
    check(fits["ieee"]["MNLP"] < const_mnlp - 1.0,
          f"16b fit_fast (ieee): {fits['ieee']}")
    check(fits["auto"]["resolved"] == "default",
          f"16b: 'auto' resolved to {fits['auto']['resolved']}")
    say("precision_fit_fast", const_MNLP=const_mnlp,
        constructor_default=DEFAULT_MM_PRECISION,
        default_resolves_to=resolve_mm_precision(DEFAULT_MM_PRECISION),
        **fits)

    # Two segments under TF32, and a resume from the first checkpoint.
    kw = dict(FIT_FAST_KW, max_iter=2 * CHECKPOINT_EVERY)
    ckpt = os.path.join(workdir, "tf32.ckpt")

    def tf32_fit(**extra):
        m = SCFGP(**KIN8NM_MODEL, seed=SEED, device="cuda",
                  mm_precision="default")
        m.fit_fast(Xt, yt, Xv, yv, **kw, **extra)
        return m

    save = SCFGP.save

    def keep_first(self, path):
        save(self, path)
        if not os.path.exists(path + ".first"):
            shutil.copy(path, path + ".first")

    launches.start()
    one = tf32_fit()
    SCFGP.save = keep_first
    try:
        seg = tf32_fit(checkpoint_path=ckpt,
                       checkpoint_every=CHECKPOINT_EVERY)
    finally:
        SCFGP.save = save
    resumed = SCFGP(device="cuda", mm_precision="default").load(
        ckpt + ".first")
    resumed_at = int(resumed._fused_train_state["state"].it)
    resumed.set_data(Xt, yt)
    resumed.optimize_fused(Xv, yv, resume=True, recalibrate=True)
    counts = launches.read("16b fit_fast TF32 segments")
    same = {name: params_equal(one.params, m.params)
            and one.evals["COST"][1] == m.evals["COST"][1]
            for name, m in (("segments", seg), ("resumed", resumed))}
    say("precision_resume", iterations=len(one.evals["COST"][1]),
        resumed_at=resumed_at, bitwise=same, launches=counts)
    check(0 < resumed_at < len(one.evals["COST"][1]) and all(same.values()),
          f"16b: a TF32 run in segments or resumed differs: {same}, "
          f"resumed at {resumed_at}")

    # fit_fast_batch under "auto".
    data = [load_boston(seed=b)[:4] for b in range(PARALLEL_BATCH)]
    ms = [SCFGP(sparsity=20, nfeats=30, seed=b, device="cuda",
                mm_precision="auto") for b in range(PARALLEL_BATCH)]
    launches.start()
    fit_fast_batch(ms, data, **OPT)
    counts = launches.read("16b fit_fast_batch (auto)")
    iters = max(len(m.evals["COST"][1]) for m in ms)
    say("precision_fit_fast_batch", resolved=[m.mm_precision for m in ms],
        NMSE=[m.evals["NMSE"][1][-1] for m in ms], iterations=iters,
        launches=counts)
    check(all(m.mm_precision == "default" for m in ms)
          and all(math.isfinite(m.evals["NMSE"][1][-1]) for m in ms)
          and counts["phi_bwd"] == iters,
          "16b fit_fast_batch under auto: not TF32, not finite, or K1b "
          "not once a step")

    # The streaming objective at phase 9's width, made on the card, where
    # the Gram dominates the jitter.
    cfg = STREAM
    gen = torch.Generator(device=dev).manual_seed(SEED)
    X = torch.rand(cfg["N"], cfg["D"], device=dev, generator=gen)
    y = torch.sin(X[:, :8].sum(dim=1)) + 0.1 * torch.randn(
        cfg["N"], device=dev, generator=gen)
    init = init_params(torch.Generator().manual_seed(SEED), cfg["D"],
                       cfg["S"], cfg["M"])
    p0 = SCFGPParams(*[t.to(dev) for t in init._replace(
        l_F=init.l_F * PRECISION_STREAM_FREQ_SCALE,
        a=torch.tensor(PRECISION_STREAM_NOISE_A))])
    stream = {}
    for leg, precision in (("ieee", None), ("default", "default")):
        def grad():
            return loss_and_grad_streaming(p0, X, y, block_size=cfg["block"],
                                           mm_precision=precision)
        launches.start()
        prof = kernel_profile(grad, warmup=0)
        counts = launches.read(f"16b streaming ({leg})",
                               none=CHOL_KERNELS + ("gram_fwd", "gram_bwd"))
        (cost, aux), g = prof["out"]
        times = [timed(grad)[1] * 1e3 for _ in range(PRECISION_STREAM_STEPS)]
        stream[leg] = dict(cost=float(cost), grads=g, step_ms=times,
                           kinds=sorted({gemm_kind(x) for x in prof["kernels"]}
                                        - {None}), launches=counts,
                           launch_lag_us=prof["launch_lag_us"])
        if precision is None:
            L = aux.post.L.double()
            cond = float(torch.linalg.cond(L @ L.mT))
    e_cost = abs(stream["default"]["cost"] - stream["ieee"]["cost"]) / abs(
        stream["ieee"]["cost"])
    e_grad = grad_errors(stream["default"].pop("grads"),
                         stream["ieee"].pop("grads"))
    say("precision_streaming", n=cfg["N"], d=cfg["D"], s=cfg["S"],
        m=cfg["M"], block=cfg["block"],
        freq_scale=PRECISION_STREAM_FREQ_SCALE,
        noise_a=PRECISION_STREAM_NOISE_A, cond_A=cond, cost_rel_err=e_cost,
        grad_rel_err=e_grad, cost_tol=PRECISION_STREAM_COST_TOL,
        grad_tol=PRECISION_STREAM_GRAD_TOL, **stream)
    check(stream["ieee"]["kinds"] == [] and stream["default"]["kinds"]
          == ["tf32"], f"16b streaming: kernels of kinds "
          f"{stream['ieee']['kinds']}, {stream['default']['kinds']}")
    check(e_cost > 0 or max(e_grad.values()) > 0,
          "16b streaming: TF32 moved neither the cost nor a gradient leaf")
    check(math.isfinite(e_cost) and e_cost <= PRECISION_STREAM_COST_TOL
          and max(e_grad.values()) <= PRECISION_STREAM_GRAD_TOL,
          f"16b streaming TF32 against IEEE: {e_cost}, {e_grad}")
    del X, y
    torch.cuda.empty_cache()

    # fit_bayes: under "auto" the samplers run no TF32 GEMM.
    bayes = {}
    for leg, precision in (("auto", "auto"), ("explicit", "default")):
        m = SCFGP(**BAYES_MODEL, seed=SEED, device="cuda",
                  mm_precision=precision)
        launches.start()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # R-hat of a cut run
            prof = kernel_profile(
                lambda: m.fit_bayes(Xt, yt, **PRECISION_BAYES), warmup=0)
        kinds = sorted({gemm_kind(x) for x in prof["kernels"]} - {None})
        bayes[leg] = dict(resolved=m.mm_precision, kinds=kinds,
                          launches=launches.read(f"16b fit_bayes ({leg})"))
    say("precision_fit_bayes", **bayes)
    check(bayes["auto"]["kinds"] == [] and bayes["explicit"]["kinds"]
          == ["tf32"], f"16b fit_bayes: kernels of kinds {bayes}")


def precision_quality_phase(launches, workdir):
    """16c: experiments/precision_quality.py cut to one trial a class and
    the co2 raw-basis legs; every fit finite, the co2 composite under IEEE
    within CO2_PIN of its floor."""
    from scfgp_tpu_torch.experiments import precision_quality
    launches.start()
    rec = precision_quality.main(PRECISION_QUALITY_ARGS + ["--out", workdir])
    counts = launches.read("16c precision_quality (cut)")
    say("precision_quality", launches=counts,
        **{k: rec[k] for k in ("quality", "co2_composite")})
    check(all(math.isfinite(leg[k]["mean"]) for q in rec["quality"].values()
              for leg in (q["highest"], q["default"]) for k in ("NMSE",
                                                                "MNLP")),
          "16c: a fit is not finite")
    over = rec["co2_composite"]["raw_highest"].get("nmse_over_floor")
    check(over is None or over <= CO2_PIN,
          f"16c: co2 composite under IEEE at {over} of its floor")


def precision_child(workdir):
    """Phase 16 in a process of its own (``--precision-phase WORKDIR``):
    16a and 16b read the kernels' names from torch.profiler, which late in
    this script's own process recorded no kernel on an H100, even in a
    profile padded by ``kernel_profile``, though in a fresh process it
    does (PERF.md).  The kernels are already built (phase 2); each path's
    launch counts go to ``WORKDIR/launches.json`` for the parent to
    hold."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    launches = kernel_launches()
    precision_phase(launches, torch.device("cuda"), workdir)
    with open(os.path.join(workdir, "launches.json"), "w") as f:
        json.dump(launches.by_path, f)
    return 0


def precision_phase_apart(launches, workdir):
    """Phase 16 through ``precision_child``, its JSON lines in this
    script's output; every path's counts held here as the others'."""
    sys.stdout.flush()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--precision-phase", workdir], cwd=ROOT,
                         timeout=900)
    check(res.returncode == 0, f"phase 16 failed (exit {res.returncode})")
    with open(os.path.join(workdir, "launches.json")) as f:
        for path, counts in json.load(f).items():
            launches.record(path, counts)


def precision_phase(launches, dev, workdir):
    """Phase 16, 16a-16c in turn."""
    t = time.perf_counter()
    times = {}
    for name, fn, *args in (
            ("16a", precision_gemms_phase, dev),
            ("16b", precision_training_phase, launches, dev, workdir),
            ("16c", precision_quality_phase, launches, workdir)):
        t0 = time.perf_counter()
        fn(*args)
        times[name] = time.perf_counter() - t0
    say("precision", seconds=time.perf_counter() - t, parts_s=times)


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
    from scfgp_tpu_torch.ops.cholesky import cholesky_inverse_kernel
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

    def counted(phase):
        n = fourier_features_cuda.launches
        check(n > counted.last, f"K1f was not launched in phase {phase}")
        counted.last = n
        return n

    launches = kernel_launches()

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
    with torch.inference_mode():  # in the model's resolved GEMM arithmetic
        cost_ref, aux_ref = loss_from_phi(m.params, ref_phi(m.params, m.X),
                                          m.y, mm_dtype=m.mm_dtype,
                                          mm_precision=m.mm_precision)
    e_post = check_post(m.post, aux_ref.post, "set_data")
    e_cost = abs(float(m.cost) - float(cost_ref)) / abs(float(cost_ref))
    check(e_cost <= COST_TOL, f"set_data cost differs: {e_cost}")
    (mu, sd), t_pred = timed(lambda: m.predict(Xv, yv))
    e_pred = check_pred((mu, sd), ref_predict(m, m.params, aux_ref.post, Xv),
                        "after set_data")
    say("set_data", rows=m.N, seconds=t_set, predict_s=t_pred,
        mm_precision=m.mm_precision, cost=float(m.cost),
        post_rel_err=e_post, cost_rel_err=e_cost,
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

    # 12. the Bayes layer ---------------------------------------------------
    bayes_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_bayes_")
    bayes_phase(launches, bayes_dir.name)
    bayes_dir.cleanup()

    # 13. the command line, the served predictor and the helpers ---------
    cli_serving_phase(launches)

    # 14. the rest of the Bayes layer -------------------------------------
    rest_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_bayes_rest_")
    bayes_rest_phase(launches, rest_dir.name)
    rest_dir.cleanup()

    # 15. the parallel layer ---------------------------------------------
    par_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_")
    parallel_phase(launches, par_dir.name)
    par_dir.cleanup()

    # 16. the precision policy, in a process of its own ------------------
    prec_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_precision_")
    precision_phase_apart(launches, prec_dir.name)
    prec_dir.cleanup()

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
    if sys.argv[1:2] == ["--precision-phase"]:
        sys.exit(precision_child(sys.argv[2]))
    sys.exit(main())
