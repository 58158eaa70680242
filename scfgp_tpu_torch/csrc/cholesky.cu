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
// together, by one column loop over registers and shared memory, instead of
// by the TPU's sub-blocked masked reductions and log-depth Neumann products;
// and the trailing update touches the lower triangle only instead of the whole
// matrix.  What carries over is what they compute: L with the pivot clamped
// as sqrt(max(d, 1e-30)) (cholesky.py:134), so a matrix that is not
// positive definite gives every pivot in [1e-15, inf] and finite nonsense,
// inf or NaN below the diagonal, never an error or a hang;
// and for K3 the progressive block identity (cholesky.py:251-256)
//
//   inv([[T_k, 0], [R_k, L_kk]]) = [[W_k, 0], [-L_kk^-1 R_k W_k, L_kk^-1]]
//
// that emits one finished row block of L^-1 per block column.
//
// Per block column k (offset o, width w = min(64, n - o)), on the stream:
//
//   (a) diag_kernel, one block: L_kk = chol(A_kk) and L_kk^-1 by one loop of
//       w column steps, each ending in one __syncthreads, into a 64 x 64
//       scratch (and, for K3, L^-1's diagonal block);
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
// The n/64 diagonal blocks are serial, each 64 dependent column steps on one
// SM.  A step is a barrier, a shared read of r_j, ~16 predicated FMAs a
// thread on registers and the owner's rsqrt of the next pivot; the factor's
// and the inverse's updates of a row i together touch its i + 1 entries, so
// all 256 threads stay busy.  Measured on an H100 SXM (700 W): ~18.5 us a
// block, of which ~5 us are the 64 barriers and most of the rest goes to
// issuing ~100 instructions a step on two warps a scheduler.  With the
// panel, the trailing update and (K3) the row block that is 3-4 launches a
// block column.  At n = 554 (the kin8nm posterior) that is 9 block columns
// and the flops (n^3/3 = 5.7e7) are negligible; at n = 4096 it is 64 block
// columns and ~1.1e10 FMAs of trailing update (K3 as much again in the row
// blocks), at the ~12 TFLOP/s of the simple tile.  Fewer launches a block
// column, wgmma tiles and a row block split along its depth are later work.

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

// (a) Factor the w x w diagonal block at (o, o) of L and invert it, in one
// column loop with one __syncthreads a column and no substitution after it.
// dinv receives L_kk^-1 as a TILE x TILE matrix, zero outside w x w and
// above the diagonal; li, when not null, receives it in its diagonal block
// too.
//
// Thread (ty, tx) keeps the entries (i, c) = (ty + 16a, tx + 16b) of a
// 64 x 64 working matrix in registers.  Entry (i, c) holds S[i][c], the
// block being factored, until column c is final, and from step c on R[i][c]
// of the right-looking forward substitution of L_kk R = I: at step j, row j
// of R is final and X[j] = R[j] / d_j, and every row i > j takes
// R[i][c] -= L[i][j] X[j][c] for c <= j.  Columns stay unscaled: the step
// reads L[i][j] as S[i][j] r_j, r_j = rsqrt(max(S[j][j], 1e-30)).  So step
// j reads only r_j, column j of S and row j of R from shared memory, all
// final, and writes there only what it makes final: column j + 1 of S, row
// j + 1 of R and r_{j+1}, the last from the owner of entry (j + 1, j + 1).
// One barrier ends the step.  At the end L[i][c] = S[i][c] r_c and
// X[i][c] = R[i][c] r_i below the diagonal; on it, L[i][i] = d_i =
// sqrt(max(S[i][i], 1e-30)) and X[i][i] = 1 / d_i, both correctly rounded.
//
// The steps run in four phases of 16 (q = j / 16), unrolled, so which of a
// thread's 16 entries a step touches is mostly known at compile time: rows
// a < q are finished, columns b < q are in R and b > q in S, and entries
// above the diagonal (b > a) never change.
__global__ void __launch_bounds__(THREADS)
diag_kernel(float* __restrict__ L, float* __restrict__ li,
            float* __restrict__ dinv, int n, int o, int w) {
  constexpr int B = tile::TX;    // a thread's rows (columns) are B apart
  constexpr int PER = TILE / B;  // rows and columns a thread keeps
  static_assert(tile::TY == B && PER * B == TILE, "a square grid of threads");
  __shared__ float S[TILE][TILE + 1];  // column j final from step j - 1 on
  __shared__ float R[TILE][TILE + 1];  // row j final from step j - 1 on
  __shared__ float r[TILE];            // r_j, from step j - 1 on
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  float m[PER][PER];
#pragma unroll
  for (int a = 0; a < PER; ++a)
#pragma unroll
    for (int b = 0; b < PER; ++b) {
      const int i = ty + B * a;
      const int c = tx + B * b;
      m[a][b] = (i < w && c <= i) ? L[static_cast<size_t>(o + i) * n + o + c]
                                  : 0.0f;
      S[i][c] = m[a][b];
      R[i][c] = i == c ? 1.0f : 0.0f;
    }
  if (tx == 0 && ty == 0) r[0] = rsqrtf(fmaxf(m[0][0], PIVOT_FLOOR));
  __syncthreads();

#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int qn = q + 1 < PER ? q + 1 : q;  // the next phase
    for (int jj = 0; jj < B; ++jj) {
      const int j = q * B + jj;
      if (j >= w) break;
      const float rj = r[j];
      float l[PER], x[PER];  // L[i][j] of my rows; X[j][c] or L[c][j]
#pragma unroll
      for (int a = q; a < PER; ++a) l[a] = S[ty + B * a][j] * rj;
#pragma unroll
      for (int b = 0; b < PER; ++b) {
        const int c = tx + B * b;
        const bool in_r = b < q || (b == q && tx <= jj);  // c <= j
        x[b] = (in_r ? R[j][c] : S[c][j]) * rj;
      }
#pragma unroll
      for (int a = q; a < PER; ++a) {
        const bool below = a > q || ty > jj;  // i > j
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          if (b == q && tx == jj && (a > q || ty >= jj))
            m[a][b] = (a == q && ty == jj) ? 1.0f : 0.0f;  // S ends, R begins
          if (below && (b < a || tx <= ty))
            m[a][b] = fmaf(-l[a], x[b], m[a][b]);
        }
      }

      // Publish column j + 1 of S below row j (my entries of column
      // tx == (j + 1) % B), row j + 1 of R up to column j (of row
      // ty == (j + 1) % B) and r_{j+1}.  j + 1 opens phase qn if last.
      const bool last = jj == B - 1;
      const int next = last ? 0 : jj + 1;
      if (j + 1 < w) {
        if (tx == next) {
#pragma unroll
          for (int a = q; a < PER; ++a)
            if (a > q || (!last && ty > jj))
              S[ty + B * a][j + 1] = last ? m[a][qn] : m[a][q];
        }
        if (ty == next) {
#pragma unroll
          for (int b = 0; b <= q; ++b)
            if (b < q || tx <= jj)
              R[j + 1][tx + B * b] = last ? m[qn][b] : m[q][b];
          if (tx == next)
            r[j + 1] = rsqrtf(fmaxf(last ? m[qn][qn] : m[q][q], PIVOT_FLOOR));
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < PER; ++a)
#pragma unroll
    for (int b = 0; b < PER; ++b) {
      const int i = ty + B * a;
      const int c = tx + B * b;
      float lic = 0.0f, xic = 0.0f;
      if (i < w && c < i) {
        lic = S[i][c] * r[c];
        xic = m[a][b] * r[i];
      } else if (i < w && c == i) {
        lic = sqrtf(fmaxf(S[i][i], PIVOT_FLOOR));
        xic = 1.0f / lic;
      }
      dinv[i * TILE + c] = xic;
      if (i < w && c < w) {
        const size_t at = static_cast<size_t>(o + i) * n + o + c;
        L[at] = lic;
        if (li != nullptr) li[at] = xic;
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
