// The trig feature map of a block of rows, shared by K1f (phi_fwd.cu) and
// the chunked features of K2f and K2b (gram_fwd.cu, gram_bwd.cu):
//
//   out[r, j]     = s * cos(T[r, j])      j < K
//   out[r, K + j] = s * sin(T[r, j])      T = X @ Fcat + pcat
//
// with X (N, D), Fcat (D, K), pcat (K,), s read through a device pointer
// (s = 1 when the pointer is null), and out one contiguous (N, 2K) float32
// array.  Ragged N, D and K are masked; there is no padding of D or K.
//
// Layout: a block owns TILE_N rows and TILE_K feature columns.  It stages
// the X rows and the Fcat columns of one D chunk in shared memory and loops
// D in chunks of CHUNK_D.  threadIdx.x walks the feature columns, so every
// global store of a warp is 32 consecutive floats; each thread keeps
// TILE_N / THREADS_Y projections in registers and accumulates them with
// fp32 FMAs in the order d = 0..D-1.
//
// Precision: sincosf is the precise libdevice routine.  __sincosf and
// --use_fast_math are not used: |T| reaches tens and the trig projection
// must stay at full float32 precision (scfgp_tpu/models/objective.py:150-153).

#pragma once

#include <cuda_runtime.h>

namespace features {
namespace {  // each library keeps its own copy

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
               int n, int d, int k) {
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
  const size_t ld = 2 * (size_t)k;
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

// Launches feature_kernel for n rows on `stream`; returns cudaGetLastError().
inline cudaError_t launch(const float* X, const float* Fcat, const float* pcat,
                          const float* scale, float* out, int n, int d, int k,
                          cudaStream_t stream) {
  const dim3 block(TILE_K, THREADS_Y);
  const dim3 grid((n + TILE_N - 1) / TILE_N, (k + TILE_K - 1) / TILE_K);
  feature_kernel<<<grid, block, 0, stream>>>(X, Fcat, pcat, scale, out, n, d,
                                             k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace features
