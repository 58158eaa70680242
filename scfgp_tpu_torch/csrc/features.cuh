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
// Narrow (D < WIDE_D): feature_kernel, a block of 64 rows x 64 feature
// columns, stages the X rows and Fcat columns of one 32-deep D chunk in
// shared memory; threadIdx.x walks the feature columns, so every store of a
// warp is 32 consecutive floats, and each thread keeps 16 projections in
// registers.  At D = 8 the tile's 128-row side would hold 8 rows of depth,
// and a launch is mostly stores.
//
// Both sum T in the order d = 0..D-1 with one fp32 FMA at a time from 0,
// then add pcat, so the two designs give the same bits, and the same T as
// K1b's phi_t_kernel.
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
__global__ void __launch_bounds__(sgemm::THREADS, 2)
feature_tile_kernel(sgemm::Operand X, sgemm::Operand F,
                    const float* __restrict__ pcat,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int n, int d, int k, int ld, bool vec) {
  __shared__ __align__(16) sgemm::Smem sm;
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

constexpr int TILE_N = 64;
constexpr int TILE_K = 64;
constexpr int CHUNK_D = 32;
constexpr int THREADS_Y = 4;
constexpr int THREADS = TILE_K * THREADS_Y;
constexpr int ROWS_PER_THREAD = TILE_N / THREADS_Y;

__global__ void __launch_bounds__(THREADS)
feature_kernel(const float* __restrict__ X, const float* __restrict__ Fcat,
               const float* __restrict__ pcat,
               const float* __restrict__ scale, float* __restrict__ out,
               int n, int d, int k, int ld) {
  // +1 column: the staging writes walk a row of xs without bank conflicts.
  __shared__ float xs[TILE_N][CHUNK_D + 1];
  __shared__ float fs[CHUNK_D][TILE_K];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE_K + tx;
  const int row0 = blockIdx.x * TILE_N;
  const int col0 = blockIdx.y * TILE_K;
  const int col = col0 + tx;

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += CHUNK_D) {
    const int dc = min(CHUNK_D, d - d0);
    // Neighbouring threads read neighbouring elements of one X row ...
    for (int idx = tid; idx < TILE_N * CHUNK_D; idx += THREADS) {
      const int r = idx / CHUNK_D;
      const int j = idx % CHUNK_D;
      const int gr = row0 + r;
      xs[r][j] = (gr < n && j < dc) ? X[(size_t)gr * d + d0 + j] : 0.0f;
    }
    // ... and neighbouring columns of one Fcat row.
    for (int idx = tid; idx < CHUNK_D * TILE_K; idx += THREADS) {
      const int j = idx / TILE_K;
      const int c = idx % TILE_K;
      const int gc = col0 + c;
      fs[j][c] = (j < dc && gc < k) ? Fcat[(size_t)(d0 + j) * k + gc] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < dc; ++j) {
      const float f = fs[j][tx];
      // All 32 lanes of a warp share ty: the xs read is a broadcast.
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        acc[i] = fmaf(xs[ty + i * THREADS_Y][j], f, acc[i]);
    }
    __syncthreads();
  }

  if (col >= k) return;
  const float s = scale != nullptr ? *scale : 1.0f;
  const float p = pcat[col];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = row0 + ty + i * THREADS_Y;
    if (r < n) {
      float sn, cs;
      sincosf(acc[i] + p, &sn, &cs);
      out[(size_t)r * ld + col] = s * cs;
      out[(size_t)r * ld + k + col] = s * sn;
    }
  }
}

// Launches the design D chooses for n rows on `stream`, out's row pitch
// ld >= 2k; returns cudaGetLastError().
inline cudaError_t launch(const float* X, const float* Fcat, const float* pcat,
                          const float* scale, float* out, int n, int d, int k,
                          int ld, cudaStream_t stream) {
  if (d >= WIDE_D) {
    const dim3 grid((n + sgemm::BM - 1) / sgemm::BM,
                    (k + sgemm::BM - 1) / sgemm::BM);
    const bool vec = reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
                     ld % 4 == 0 && k % 4 == 0;
    feature_tile_kernel<<<grid, sgemm::THREADS, 0, stream>>>(
        sgemm::operand(X, d, n), sgemm::operand(Fcat, k, k), pcat, scale, out,
        n, d, k, ld, vec);
  } else {
    const dim3 block(TILE_K, THREADS_Y);
    const dim3 grid((n + TILE_N - 1) / TILE_N, (k + TILE_K - 1) / TILE_K);
    feature_kernel<<<grid, block, 0, stream>>>(X, Fcat, pcat, scale, out, n,
                                               d, k, ld);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace features
