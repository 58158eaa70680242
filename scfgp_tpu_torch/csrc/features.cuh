// The trig feature map of a block of rows, shared by K1f (phi_fwd.cu) and
// the chunked features of K2f (gram_fwd.cu):
//
//   out[r, j]     = s * cos(T[r, j])      j < K
//   out[r, K + j] = s * sin(T[r, j])      T = X @ Fcat + pcat
//
// with X (N, D), Fcat (D, K), pcat (K,), s read through a device pointer
// (s = 1 when the pointer is null), and out row-major with a row pitch of
// ld >= 2K floats (K1f: ld = 2K; K2f: 2K rounded up to a multiple of 4).
// Ragged N, D and K are masked; there is no padding of D or K, and columns
// [2K, ld) of out are not written.
//
// What bounds it on an H100: N * D * K FMAs for T, one precise sincosf per
// (row, feature), and N * 2K * 4 bytes of stores.  At the streaming block
// (16384 x 256 x 256) T is 2.15 GFLOP, 0.032 ms at 67 TFLOP/s, and the 33.5
// MB of stores 0.010 ms at 3.35 TB/s; at the served kin8nm model (6553 x 8
// x 277) T is tiny and the 14.5 MB of stores bound it (0.0044 ms), so a
// launch costs about as much as the work.  Two designs, chosen by D alone:
//
// Wide (D >= WIDE_D): feature_tile_kernel computes T by the 128 x 128
// register-blocked tile of sgemm_tile.cuh (X m-major through registers,
// Fcat k-major by cp.async), the mainloop of K1b's phi_t_kernel; its
// epilogue adds pcat, takes the sincosf of its 8 x 8 values and stores
// s cos and s sin four columns at a time (float4 where ld, K and out allow
// it).  Registers and shared memory (ptxas, sm_90a): see phi_fwd.cu.
//
// Narrow (D < WIDE_D): feature_kernel, compiled for D rounded up to a
// bucket of 8, 16, 32 or 64 (loops unrolled to the bucket, masked to D).
// A block takes a contiguous span of rows of one column tile (all K
// columns up to 512, 256 from D > 16) and stages the span's X rows in
// shared memory with 16-byte loads where D % 4 == 0; thread (row lane l,
// column j) keeps Fcat[:, j], pcat[j] and s in registers and maps rows
// l, l + lanes, ... of the span.  The lanes fill the block (lanes x K
// threads: 277 at kin8nm, 500 at K = 50), so at most one warp is ragged,
// with no barrier after the staging and no div or mod per element.  At
// least 8 rows a thread, else about two waves of full SMs.  Stores stay
// 4 bytes a thread: a warp's are runs of consecutive floats, and staging
// Phi in shared memory to write it as aligned 16-byte stores measured
// slower (0.0568 against 0.0433 ms at the Bayes shape), as did fewer or
// more waves.  What bounds it at D = 8 is the stores: with sincosf
// replaced by a copy it took 0.0091 ms at kin8nm, its bound 0.0044.
// Registers (ptxas, sm_90a; 2-D / batched instances): 40 / 40 at D <= 8
// with the 32-byte frame of sincosf's slow path, 58 / 62 at 16, 80 / 95
// at 32 (12 bytes of spills in the 2-D instance), 106 / 110 at 64; 16 KB
// of shared memory at most.  Device time on an NVIDIA H100 80GB HBM3 at
// 700.00 W (experiments/kernel_ab.py, PERF.md §6), against the first
// design in the same run: 0.0107 ms at kin8nm (0.0126), 0.0111 at bench
// (0.0125), 0.0155 for 50 boston trials (0.0188), 0.0431 for 32 Bayes
// chains (0.0635), 0.1437 for 96 tempering trials (0.1767).
//
// Both designs sum T in the order d = 0..D-1 with one fp32 FMA at a time
// from 0, then add pcat (narrow::project), so the two give the same bits,
// the same T as K1b's kernels, and the first narrow design's bits.
//
// Trials: one launch maps B independent problems of one shape (a batched
// sweep's trials).  blockIdx.z is the trial; trial z's operands lie at
// fixed strides from the first trial's (X n*d, Fcat d*k, pcat k, s 1, out
// n*ld floats), so each trial's blocks compute exactly what a launch on that
// trial alone computes, and give its bits.  A stride keeps 16-byte
// alignment wherever a row pitch does (n*d with d % 4 == 0, and so on), so
// the vector paths stay valid for every trial.  The offsets are compiled
// in only where a launch has more than one trial (BATCHED): moved pointers
// live in registers (see the registers above), and the 2-D launch keeps
// its code, registers and time.
//
// Precision: sincosf is the precise libdevice routine.  __sincosf and
// --use_fast_math are not used: |T| reaches tens and the trig projection
// must stay at full float32 precision (scfgp_tpu/models/objective.py:150-153).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sgemm_tile.cuh"

namespace features {
namespace {  // each library keeps its own copy

// D from which the wide design runs.
constexpr int WIDE_D = 64;

// ---- wide -------------------------------------------------------------

// Block (row tile, column tile) of out; X (n, d) m-major, F (d, k) k-major.
template <bool BATCHED>
__global__ void __launch_bounds__(sgemm::THREADS, 2)
feature_tile_kernel(sgemm::Operand X, sgemm::Operand F,
                    const float* __restrict__ pcat,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int n, int d, int k, int ld, bool vec) {
  __shared__ __align__(16) sgemm::Smem sm;
  if (BATCHED) {
    const size_t z = blockIdx.z;
    X.p += z * n * d;
    F.p += z * d * k;
    pcat += z * k;
    if (scale != nullptr) scale += z;
    out += z * n * ld;
  }
  const int tid = threadIdx.x;
  const int tx = sgemm::thread_x(tid);
  const int ty = sgemm::thread_y(tid);
  const int m0 = blockIdx.x * sgemm::BM;
  const int n0 = blockIdx.y * sgemm::BM;

  float acc[sgemm::MICRO][sgemm::MICRO];
  sgemm::product<false, true>(X, F, d, m0, n0, sm, acc);

  const float s = scale != nullptr ? *scale : 1.0f;
  // A thread's columns are two runs of four, j0 .. j0 + 3.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j0 = n0 + sgemm::col_of(4 * h, tx);
    if (j0 >= k) continue;
    float p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = j0 + q < k ? pcat[j0 + q] : 0.0f;
    const bool whole = vec && j0 + 3 < k;
#pragma unroll
    for (int a = 0; a < sgemm::MICRO; ++a) {
      const int r = m0 + sgemm::row_of(a, ty);
      if (r >= n) continue;
      float c[4], sn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sincosf(acc[a][4 * h + q] + p[q], &sn[q], &c[q]);
        c[q] = s * c[q];
        sn[q] = s * sn[q];
      }
      float* o = out + static_cast<size_t>(r) * ld + j0;
      if (whole) {
        *reinterpret_cast<float4*>(o) = make_float4(c[0], c[1], c[2], c[3]);
        *reinterpret_cast<float4*>(o + k) =
            make_float4(sn[0], sn[1], sn[2], sn[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j0 + q < k) {
            o[q] = c[q];
            o[k + q] = sn[q];
          }
        }
      }
    }
  }
}

// ---- narrow -----------------------------------------------------------

namespace narrow {

// D rounded up to the bucket a narrow kernel is compiled for; the loops
// over D are unrolled to the bucket and masked to D.
inline int bucket(int d) { return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : 64; }

// Threads a block may have: 512 while a column of Fcat takes at most 16
// registers, else 256.
template <int DB>
__host__ __device__ constexpr int max_threads() {
  return DB <= 16 ? 512 : 256;
}

// x[dd] = row[dd] for dd < d, 0 beyond, from a row of X staged in shared
// memory with D padded to the bucket (16-byte aligned).
template <int DB>
__device__ __forceinline__ void load_staged(const float* row, int d,
                                            float (&x)[DB]) {
#pragma unroll
  for (int dd = 0; dd < DB; dd += 4) {
    const float4 v = dd < d ? *reinterpret_cast<const float4*>(row + dd)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[dd] = v.x;
    x[dd + 1] = v.y;
    x[dd + 2] = v.z;
    x[dd + 3] = v.w;
  }
}

// f[dd] = Fcat[dd, col] for dd < d, 0 beyond.
template <int DB>
__device__ __forceinline__ void load_column(const float* __restrict__ Fcat,
                                            int d, int k, int col,
                                            float (&f)[DB]) {
#pragma unroll
  for (int dd = 0; dd < DB; ++dd)
    f[dd] = dd < d ? __ldg(Fcat + static_cast<size_t>(dd) * k + col) : 0.0f;
}

// X[r, :] Fcat[:, j]: one fp32 FMA at a time from 0, d = 0..D-1, the order
// of every design of K1f and K1b (pcat is added after).
template <int DB>
__device__ __forceinline__ float project(const float (&x)[DB],
                                         const float (&f)[DB], int d) {
  float t = 0.0f;
#pragma unroll
  for (int dd = 0; dd < DB; ++dd)
    if (dd < d) t = fmaf(x[dd], f[dd], t);
  return t;
}

// Bytes of X rows a block stages; waves of full SMs the grid aims at;
// rows a thread maps at least.
constexpr int STAGE_BYTES = 16384;
constexpr int WAVES = 2;
constexpr int MIN_PER_THREAD = 8;

// Block (row block, column tile, trial): the block's rows of X are one
// contiguous span, staged in shared memory by every thread with D padded
// to the bucket; thread (lane l, column j) keeps Fcat[:, j], pcat[j] and s
// in registers and maps rows l + i * lanes of the block, i < per_thread.
// The kc columns of a tile are consecutive threads, so a warp's stores of
// cos (and of sin) are runs of consecutive floats.
template <int DB, bool BATCHED>
__global__ void __launch_bounds__(max_threads<DB>())
feature_kernel(const float* __restrict__ X, const float* __restrict__ Fcat,
               const float* __restrict__ pcat,
               const float* __restrict__ scale, float* __restrict__ out,
               int n, int d, int k, int ld, int kc, int lanes,
               int per_thread, bool vec) {
  extern __shared__ __align__(16) float xs[];  // block rows x DB
  if (BATCHED) {
    const size_t z = blockIdx.z;
    X += z * n * d;
    Fcat += z * d * k;
    pcat += z * k;
    if (scale != nullptr) scale += z;
    out += z * n * ld;
  }
  const int l = threadIdx.x / kc;
  const int col = blockIdx.y * kc + (threadIdx.x - l * kc);
  const bool mine = l < lanes && col < k;
  float f[DB];
  load_column<DB>(Fcat, mine ? d : 0, k, col, f);
  const float p = mine ? pcat[col] : 0.0f;
  const float s = scale != nullptr ? *scale : 1.0f;

  const long long row0 =
      static_cast<long long>(blockIdx.x) * lanes * per_thread;
  const int rows = static_cast<int>(
      min(static_cast<long long>(lanes) * per_thread, n - row0));
  const float* src = X + row0 * d;
  if (vec) {
    for (int e = 4 * threadIdx.x; e < rows * d; e += 4 * blockDim.x) {
      const int r = e / d;
      *reinterpret_cast<float4*>(xs + r * DB + (e - r * d)) =
          __ldg(reinterpret_cast<const float4*>(src + e));
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const int r = e / d;
      xs[r * DB + (e - r * d)] = __ldg(src + e);
    }
  }
  __syncthreads();
  if (!mine) return;

  const int count = l < rows ? (rows - l + lanes - 1) / lanes : 0;
#pragma unroll 2
  for (int i = 0; i < count; ++i) {
    const int r = l + i * lanes;
    float x[DB];
    load_staged<DB>(xs + r * DB, d, x);
    float sn, cs;
    sincosf(project<DB>(x, f, d) + p, &sn, &cs);
    float* o = out + (row0 + r) * ld + col;
    o[0] = s * cs;
    o[k] = s * sn;
  }
}

// Column tiles of at most maxt columns, of equal width kc; lanes of rows
// fill a block; rows a thread so that the grid makes about WAVES waves of
// full SMs (2048 threads each on 132 SMs), at least MIN_PER_THREAD, within
// STAGE_BYTES of staged X rows.
struct Grid {
  int kc, ctiles, lanes, threads, per_thread, rblocks;
};

inline Grid grid_of(int n, int k, int trials, int maxt, int db) {
  Grid g;
  g.ctiles = (k + maxt - 1) / maxt;
  g.kc = (k + g.ctiles - 1) / g.ctiles;
  const int most = STAGE_BYTES / (4 * db);  // rows a block may stage
  g.lanes = maxt / g.kc < most ? maxt / g.kc : most;
  g.threads = g.lanes * g.kc;
  const int resident = 2048 / ((g.threads + 31) / 32 * 32);
  const long long target = 1LL * WAVES * 132 * (resident > 0 ? resident : 1);
  long long per = static_cast<long long>(n) * g.ctiles * trials /
                  (static_cast<long long>(g.lanes) * target);
  if (per < MIN_PER_THREAD) per = MIN_PER_THREAD;
  if (per > most / g.lanes) per = most / g.lanes;
  g.per_thread = static_cast<int>(per);
  const long long rows = static_cast<long long>(g.lanes) * g.per_thread;
  g.rblocks = static_cast<int>((n + rows - 1) / rows);
  return g;
}

template <int DB>
cudaError_t launch(const float* X, const float* Fcat, const float* pcat,
                   const float* scale, float* out, int n, int d, int k,
                   int ld, cudaStream_t stream, int trials) {
  const Grid g = grid_of(n, k, trials, max_threads<DB>(), DB);
  const bool vec =
      d % 4 == 0 && reinterpret_cast<std::uintptr_t>(X) % 16 == 0;
  const dim3 grid(g.rblocks, g.ctiles, trials);
  const size_t smem = sizeof(float) * DB * g.lanes * g.per_thread;
  (trials > 1 ? feature_kernel<DB, true> : feature_kernel<DB, false>)
      <<<grid, g.threads, smem, stream>>>(X, Fcat, pcat, scale, out, n, d, k,
                                          ld, g.kc, g.lanes, g.per_thread,
                                          vec);
  return cudaGetLastError();
}

}  // namespace narrow

// Launches the design D chooses for n rows of each of `trials` problems on
// `stream`, out's row pitch ld >= 2k; returns cudaGetLastError().
inline cudaError_t launch(const float* X, const float* Fcat, const float* pcat,
                          const float* scale, float* out, int n, int d, int k,
                          int ld, cudaStream_t stream, int trials = 1) {
  if (d >= WIDE_D) {
    const dim3 grid((n + sgemm::BM - 1) / sgemm::BM,
                    (k + sgemm::BM - 1) / sgemm::BM, trials);
    const bool vec = reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                     ld % 4 == 0 && k % 4 == 0;
    (trials > 1 ? feature_tile_kernel<true> : feature_tile_kernel<false>)
        <<<grid, sgemm::THREADS, 0, stream>>>(
        sgemm::operand(X, d, n), sgemm::operand(Fcat, k, k), pcat, scale, out,
        n, d, k, ld, vec);
  } else {
    switch (narrow::bucket(d)) {
      case 8:
        return narrow::launch<8>(X, Fcat, pcat, scale, out, n, d, k, ld,
                                 stream, trials);
      case 16:
        return narrow::launch<16>(X, Fcat, pcat, scale, out, n, d, k, ld,
                                  stream, trials);
      case 32:
        return narrow::launch<32>(X, Fcat, pcat, scale, out, n, d, k, ld,
                                  stream, trials);
      default:
        return narrow::launch<64>(X, Fcat, pcat, scale, out, n, d, k, ld,
                                  stream, trials);
    }
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace features
