// K4 and K3: the blocked Cholesky factor L of a symmetric positive definite
// matrix A (n, n), alone (K4) or with its inverse L^-1 (K3), on Hopper.
//
// They replace the Pallas TPU kernels scfgp_tpu/ops/cholesky.py::
// _chol_step_kernel (K4, entry cholesky_pallas) and _chol_inv_step_kernel
// (K3, entry cholesky_inverse_pallas): a right-looking factorisation over a
// sequential grid of 128-wide block columns, with the whole padded matrix
// resident in one VMEM block.  None of that carries over.  The matrix stays
// in global memory, so n is not bounded by a block's memory; the sequential
// grid becomes a host loop of launches on one stream; n is not padded (the
// last block column is ragged); the diagonal block is factored and inverted
// by a column loop and a substitution in shared memory instead of the TPU's
// sub-blocked masked reductions and log-depth Neumann products; and the
// trailing update touches the lower triangle only instead of the whole
// matrix.  What carries over is what they compute: L with the pivot clamped
// as sqrt(max(d, 1e-30)) (cholesky.py:134), so a matrix that is not
// positive definite gives finite nonsense or inf, never an error or a hang;
// and for K3 the progressive block identity (cholesky.py:251-256)
//
//   inv([[T_k, 0], [R_k, L_kk]]) = [[W_k, 0], [-L_kk^-1 R_k W_k, L_kk^-1]]
//
// that emits one finished row block of L^-1 per block column.
//
// Per block column k (offset o, width w = min(64, n - o)), on the stream:
//
//   (a) diag_kernel, one block: L_kk = chol(A_kk) column by column in shared
//       memory, then L_kk^-1 by substitution, one thread per column of the
//       inverse, into a 64 x 64 scratch (and, for K3, L^-1's diagonal block);
//   (d) K3 only, inverse_row_kernel: L^-1[o:o+w, 0:o] = -L_kk^-1 (R_k W_k),
//       one block per 64 columns; the 64 x 64 tile of R_k W_k stays in
//       shared memory, so no scratch of 64 x n floats is needed;
//   (b) panel_kernel: P = C L_kk^-T for the rows below, one block per 64
//       rows, in place;
//   (c) trailing_kernel: A22 -= P P^T on the 64 x 64 tiles of the trailing
//       lower triangle, one block per tile, masked to the lower triangle.
//
// The products use the 64 x 64 FP32 tile of tile_mma.cuh.  Every output
// element is written by one block, sums run in a fixed order and there are
// no atomics, so both kernels are bitwise repeatable.  The strict upper
// triangles of L and L^-1 are written as exact zeros.  float32 only, fp32
// FMAs, no TF32.
//
// What bounds it on an H100: a Cholesky is latency-bound, not FLOP-bound.
// The n/64 diagonal factors are serial, each 64 dependent column steps of
// three __syncthreads, followed by a 64-step substitution; with the panel,
// the trailing update and (K3) the row block that is 3-4 launches a block
// column.  At n = 554 (the kin8nm posterior) that is 9 block columns and the
// flops (n^3/3 = 5.7e7) are negligible; at n = 4096 it is 64 block columns
// and ~1.1e10 FMAs of trailing update (K3 as much again in the row blocks),
// at the ~12 TFLOP/s of the simple tile.  A persistent kernel, wgmma tiles
// and a row block split along its depth are later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "tile_mma.cuh"

namespace {

using tile::KC;
using tile::MICRO;
using tile::THREADS;
using tile::TILE;

constexpr int COPY_THREADS = 256;
constexpr int COPY_BLOCKS = 8 * 132;  // enough to fill the H100's 132 SMs
constexpr float PIVOT_FLOOR = 1e-30f;  // cholesky.py:134

// L = tril(A): the working copy, zeros above the diagonal.
__global__ void __launch_bounds__(COPY_THREADS)
lower_copy_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  const size_t total = static_cast<size_t>(n) * n;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * COPY_THREADS +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * COPY_THREADS) {
    const size_t r = idx / n;
    const size_t c = idx % n;
    L[idx] = c <= r ? A[idx] : 0.0f;
  }
}

// (a) Factor the w x w diagonal block at (o, o) of L and invert it.  dinv
// receives L_kk^-1 as a TILE x TILE matrix, zero outside w x w and above the
// diagonal; li, when not null, receives it in its diagonal block too.
__global__ void __launch_bounds__(THREADS)
diag_kernel(float* __restrict__ L, float* __restrict__ li,
            float* __restrict__ dinv, int n, int o, int w) {
  __shared__ float S[TILE][TILE + 1];  // the block, then L_kk
  __shared__ float X[TILE][TILE + 1];  // L_kk^-1
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
    const int i = idx / TILE;
    const int c = idx % TILE;
    S[i][c] = (i < w && c <= i)
                  ? L[static_cast<size_t>(o + i) * n + o + c]
                  : 0.0f;
    X[i][c] = 0.0f;
  }
  __syncthreads();

  // Column j: pivot, scale the column below it, update the columns right of
  // it (lower triangle only).
  for (int j = 0; j < w; ++j) {
    const float d = sqrtf(fmaxf(S[j][j], PIVOT_FLOOR));
    __syncthreads();  // every thread has read S[j][j]
    for (int i = j + tid; i < w; i += THREADS)
      S[i][j] = i == j ? d : S[i][j] / d;
    __syncthreads();
    for (int i = j + 1 + ty; i < w; i += tile::TY)
      for (int c = j + 1 + tx; c <= i; c += tile::TX)
        S[i][c] = fmaf(-S[i][j], S[c][j], S[i][c]);
    __syncthreads();
  }

  // L_kk^-1 by forward substitution, thread c owning column c:
  // X[c][c] = 1 / L[c][c],
  // X[i][c] = -(sum_{m=c}^{i-1} L[i][m] X[m][c]) / L[i][i].
  if (tid < w) {
    const int c = tid;
    X[c][c] = 1.0f / S[c][c];
    for (int i = c + 1; i < w; ++i) {
      float s = 0.0f;
      for (int m = c; m < i; ++m) s = fmaf(S[i][m], X[m][c], s);
      X[i][c] = -s / S[i][i];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
    const int i = idx / TILE;
    const int c = idx % TILE;
    dinv[idx] = X[i][c];
    if (i < w && c < w) {
      const size_t at = static_cast<size_t>(o + i) * n + o + c;
      L[at] = c <= i ? S[i][c] : 0.0f;
      if (li != nullptr) li[at] = X[i][c];
    }
  }
}

// (b) P = C L_kk^-T on the rows below the diagonal block, in place in
// L[:, o:o+w]: block x owns the rows o + w + 64x ... + 63.
__global__ void __launch_bounds__(THREADS)
panel_kernel(float* __restrict__ L, const float* __restrict__ dinv, int n,
             int o, int w) {
  __shared__ __align__(16) tile::Stage As;
  __shared__ __align__(16) tile::Stage Bs;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  const int r0 = o + w + blockIdx.x * TILE;

  float acc[MICRO][MICRO];
  tile::zero(acc);
  for (int k0 = 0; k0 < w; k0 += KC) {
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int i = idx / KC;
      const int kk = idx % KC;
      const int m = k0 + kk;
      const int r = r0 + i;
      As[kk][i] = (r < n && m < w) ? L[static_cast<size_t>(r) * n + o + m]
                                   : 0.0f;
      Bs[kk][i] = m < w ? dinv[i * TILE + m] : 0.0f;  // (L_kk^-1)[i][m]
    }
    __syncthreads();
    tile::mma(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int r = r0 + ty * MICRO + a;
      const int j = tx * MICRO + b;
      if (r < n && j < w) L[static_cast<size_t>(r) * n + o + j] = acc[a][b];
    }
}

// (c) A22 -= P P^T on the trailing matrix (rows and columns from s = o + w):
// block x owns the tile (row tile tb, column tile ta), ta <= tb, of its
// lower triangle, and writes only the entries on or below the diagonal.
__global__ void __launch_bounds__(THREADS)
trailing_kernel(float* __restrict__ L, int n, int o, int w, int t) {
  __shared__ __align__(16) tile::Stage As;
  __shared__ __align__(16) tile::Stage Bs;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  int ta, tb;
  tile::upper_tile(blockIdx.x, t, &ta, &tb);
  const int s = o + w;
  const int r0 = s + tb * TILE;
  const int c0 = s + ta * TILE;

  float acc[MICRO][MICRO];
  tile::zero(acc);
  for (int k0 = 0; k0 < w; k0 += KC) {
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int i = idx / KC;
      const int kk = idx % KC;
      const int m = k0 + kk;
      const int r = r0 + i;
      const int c = c0 + i;
      As[kk][i] = (r < n && m < w) ? L[static_cast<size_t>(r) * n + o + m]
                                   : 0.0f;
      Bs[kk][i] = (c < n && m < w) ? L[static_cast<size_t>(c) * n + o + m]
                                   : 0.0f;
    }
    __syncthreads();
    tile::mma(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int r = r0 + ty * MICRO + a;
      const int c = c0 + tx * MICRO + b;
      if (r < n && c <= r) L[static_cast<size_t>(r) * n + c] -= acc[a][b];
    }
}

// (d) K3: L^-1[o:o+w, 0:o] = -L_kk^-1 (R W), R = L[o:o+w, 0:o] (finished),
// W = L^-1[0:o, 0:o] (finished): block x owns the columns c0 = 64x ... + 63.
// W is lower triangular, so the depth of R W for these columns starts at c0
// (the products skipped are exact zeros).  The tile of R W stays in shared
// memory for the second product.
__global__ void __launch_bounds__(THREADS)
inverse_row_kernel(const float* __restrict__ L, float* __restrict__ li,
                   const float* __restrict__ dinv, int n, int o, int w) {
  __shared__ __align__(16) tile::Stage As;
  __shared__ __align__(16) tile::Stage Bs;
  // R W; its row j is Gs[j / KC][j % KC].
  __shared__ __align__(16) tile::Stage Gs[TILE / KC];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  const int c0 = blockIdx.x * TILE;

  float acc[MICRO][MICRO];
  tile::zero(acc);
  for (int m0 = c0; m0 < o; m0 += KC) {
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int i = idx / KC;  // As: R[i][m0 + kk], read along the row
      const int kk = idx % KC;
      const int m = m0 + kk;
      As[kk][i] = (i < w && m < o) ? L[static_cast<size_t>(o + i) * n + m]
                                   : 0.0f;
      const int kb = idx / TILE;  // Bs: W[m0 + kb][c0 + j], read along the row
      const int j = idx % TILE;
      const int mb = m0 + kb;
      const int c = c0 + j;
      Bs[kb][j] = (mb < o && c < o) ? li[static_cast<size_t>(mb) * n + c]
                                    : 0.0f;
    }
    __syncthreads();
    tile::mma(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int j = ty * MICRO + a;
      Gs[j / KC][j % KC][tx * MICRO + b] = acc[a][b];
    }

  tile::zero(acc);
  for (int st = 0; st < TILE / KC; ++st) {
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int i = idx / KC;
      const int kk = idx % KC;
      As[kk][i] = dinv[i * TILE + st * KC + kk];  // (L_kk^-1)[i][j]
    }
    __syncthreads();  // also makes Gs visible on the first pass
    tile::mma(As, Gs[st], acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int i = ty * MICRO + a;
      const int c = c0 + tx * MICRO + b;
      if (i < w && c < o) li[static_cast<size_t>(o + i) * n + c] = -acc[a][b];
    }
}

int factor(const float* A, float* L, float* li, float* dinv, int n,
           cudaStream_t st) {
  if (n <= 0) return 0;
  const size_t total = static_cast<size_t>(n) * n;
  size_t blocks = (total + COPY_THREADS - 1) / COPY_THREADS;
  if (blocks > COPY_BLOCKS) blocks = COPY_BLOCKS;
  lower_copy_kernel<<<static_cast<unsigned>(blocks), COPY_THREADS, 0, st>>>(
      A, L, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (li != nullptr) {
    err = cudaMemsetAsync(li, 0, total * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(tile::TX, tile::TY);
  for (int o = 0; o < n; o += TILE) {
    const int w = min(TILE, n - o);
    diag_kernel<<<1, block, 0, st>>>(L, li, dinv, n, o, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (li != nullptr && o > 0) {
      inverse_row_kernel<<<(o + TILE - 1) / TILE, block, 0, st>>>(L, li, dinv,
                                                                  n, o, w);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int rest = n - o - w;
    if (rest > 0) {
      const int t = (rest + TILE - 1) / TILE;
      panel_kernel<<<t, block, 0, st>>>(L, dinv, n, o, w);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      trailing_kernel<<<tile::triangle(t), block, 0, st>>>(L, n, o, w, t);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace a call needs:
// the diagonal block's inverse, whatever n.
extern "C" size_t scfgp_chol_workspace(int n) {
  (void)n;
  return static_cast<size_t>(TILE) * TILE;
}

// Every pointer is a device pointer to contiguous float32 data: A (n, n),
// of which the lower triangle is read; L (n, n) receives the lower Cholesky
// factor, zeros above the diagonal; `work` scfgp_chol_workspace(n) floats.
// Launches every stage on `stream` (a cudaStream_t), does not synchronise,
// allocates nothing, and returns the first cudaGetLastError() code that is
// not 0 (0 on success).
extern "C" int scfgp_chol_f32(const float* A, float* L, float* work, int n,
                              void* stream) {
  return factor(A, L, nullptr, work, n, static_cast<cudaStream_t>(stream));
}

// As scfgp_chol_f32, and Li (n, n) receives L^-1, zeros above the diagonal.
extern "C" int scfgp_chol_inv_f32(const float* A, float* L, float* Li,
                                  float* work, int n, void* stream) {
  return factor(A, L, Li, work, n, static_cast<cudaStream_t>(stream));
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
