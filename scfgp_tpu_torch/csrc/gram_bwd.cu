// K2 backward: the gradient of the Phi-free sufficient statistics on Hopper.
//
// From the cotangents cbar (2K, 2K) of phiTphi and pbar (2K,) of phiTy, with
// Abar = cbar + cbar^T, phi = [cos T | sin T] (unscaled), T = X Fcat + pcat:
//
//   G     = w * (s * phi Abar + y * pbar)        (N, 2K) = dL/dPhi, never stored
//   dT    = s * (G_sin * cos T - G_cos * sin T)  (N, K)
//   dFcat = X^T dT,  dpcat = sum over rows of dT,
//   ds    = sum of G_cos * cos T + G_sin * sin T
//
// X, y and w are data and get no gradient; the cotangents of yTy and n do
// not reach the params.  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/gram.py::_bwd_kernel (entry _bwd_call), which read Abar in
// its four quadrants (c Acc + sn Asc, c Acs + sn Ass: gram.py:107-110) and
// summed dFcat, dpcat and ds into resident outputs across a sequential grid.
// Here the quadrants are one product phi Abar, and the sums over rows take
// fixed orders without atomics, so the gradient is bitwise repeatable.
//
// Design: Abar is formed once (abar_kernel).  The rows are taken in chunks
// of at most CHUNK_BUDGET bytes of scratch (phi and dT of the chunk: 2688
// rows at K = 256), and for each chunk
//
//   1. features::feature_kernel writes the chunk's unscaled phi, each
//      cos/sin computed once;
//   2. g_kernel: block (row tile, feature tile) computes a 64-row x 64-column
//      tile of phi Abar whose columns are the cos and the sin column of 32
//      features j, interleaved, so that one thread holds G_cos and G_sin of
//      the same j; its epilogue forms G, then dT (stored for the chunk) and
//      the block's share of ds, added to the block's own ds slot;
//   3. dfcat_kernel: block (tile of dFcat, row group) sums X^T dT over the
//      chunk's 32-row steps group, group + G, ... into its own slot, with
//      dpcat for the tiles of the first D rows, as K1b (phi_bwd.cu) does;
//
// and then 4. bwd_reduce_kernel adds the slots in a fixed order, one thread
// per output.  Each slot entry is read, added to and written by one thread,
// chunk after chunk.
//
// What bounds it on an H100, per row: D * K FMAs for T and a sincosf per
// (row, feature); (2K)^2 FMAs for phi Abar; D * K FMAs for X^T dT.  At the
// streaming block of the N=1e6, D=256, S=56, M=200 configuration (K = 256):
// 65,536 + 262,144 + 65,536 = 393,216 FMAs a row, 6.4 G FMAs for a
// 16,384-row block, on the FP32 pipes (TF32 is off by the port's precision
// policy).  The plain PyTorch version does the same products as three
// cuBLAS SGEMMs, which a first, simple 64 x 64 tile (tile_mma.cuh) is not
// expected to beat; wgmma and TMA are later work.
//
// Precision: precise sincosf (features.cuh), fp32 FMAs and accumulation.

#include <cuda_runtime.h>

#include <cstddef>

#include "features.cuh"
#include "tile_mma.cuh"

namespace {

using tile::KC;
using tile::MICRO;
using tile::THREADS;
using tile::TILE;

constexpr size_t CHUNK_BUDGET = size_t(8) << 20;    // bytes of phi and dT
constexpr size_t PARTIAL_BUDGET = size_t(16) << 20;  // bytes of slots
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr int HALF = TILE / 2;  // features j in one tile of phi Abar
constexpr int REDUCE_THREADS = 256;

struct Plan {
  int k2;
  int chunk_rows;  // a multiple of TILE
  int jtiles;      // feature tiles of g_kernel
  int ds_slots;    // one per (row tile of a chunk, feature tile)
  int dtiles, ktiles;
  int groups;      // row groups of dfcat_kernel
  size_t width;    // floats in one group's slot: dFcat (d * k) and dpcat (k)
};

// Depends on the shapes alone, so the order of every sum does too.
Plan plan(int n, int d, int k) {
  Plan p;
  p.k2 = 2 * k;
  size_t rows = CHUNK_BUDGET / (static_cast<size_t>(3) * k * sizeof(float));
  rows = rows / TILE * TILE;
  const size_t all = (static_cast<size_t>(n) + TILE - 1) / TILE * TILE;
  if (rows > all) rows = all;
  if (rows < TILE) rows = TILE;
  p.chunk_rows = static_cast<int>(rows);
  p.jtiles = (k + HALF - 1) / HALF;
  p.ds_slots = static_cast<int>(rows / TILE) * p.jtiles;
  p.dtiles = (d + TILE - 1) / TILE;
  p.ktiles = (k + TILE - 1) / TILE;
  p.width = static_cast<size_t>(d) * k + k;
  const int tiles = p.dtiles * p.ktiles;
  size_t g = (TARGET_BLOCKS + tiles - 1) / tiles;
  const size_t by_memory = PARTIAL_BUDGET / (p.width * sizeof(float));
  if (g > by_memory) g = by_memory;
  if (g > rows / KC) g = rows / KC;
  p.groups = g < 1 ? 1 : static_cast<int>(g);
  return p;
}

__global__ void abar_kernel(const float* __restrict__ cbar,
                            float* __restrict__ abar, int k2) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= static_cast<size_t>(k2) * k2) return;
  const size_t i = idx / k2;
  const size_t j = idx % k2;
  abar[idx] = cbar[idx] + cbar[j * k2 + i];
}

// Sum of v over the block's threads by a fixed tree; valid in thread 0.
__device__ float block_sum(float v, float* red, int tid) {
  red[tid] = v;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  return red[0];
}

// One chunk: phi (rows, k2) unscaled, y and w offset to the chunk; writes
// dT (rows, k) and adds to the ds slots.
__global__ void __launch_bounds__(THREADS)
g_kernel(const float* __restrict__ phi, const float* __restrict__ abar,
         const float* __restrict__ y, const float* __restrict__ w,
         const float* __restrict__ pbar, const float* __restrict__ scale,
         float* __restrict__ dT, float* __restrict__ ds_part, int rows, int k,
         bool first) {
  __shared__ __align__(16) tile::Stage As;  // As[kk][i] = phi[r0 + i][k0 + kk]
  __shared__ __align__(16) tile::Stage Bs;  // Bs[kk][c] = Abar[k0 + kk][col c]
  __shared__ float red[THREADS];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  const int k2 = 2 * k;
  const int r0 = blockIdx.x * TILE;
  const int j0 = blockIdx.y * HALF;

  float acc[MICRO][MICRO];
  tile::zero(acc);
  for (int k0 = 0; k0 < k2; k0 += KC) {
    // Neighbouring threads read neighbouring features of one row.
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int kk = idx % KC;
      const int i = idx / KC;
      const int r = r0 + i;
      const int kc = k0 + kk;
      As[kk][i] = (r < rows && kc < k2)
                      ? phi[static_cast<size_t>(r) * k2 + kc] : 0.0f;
    }
    // Column c of the tile: the cos (c even) or sin (c odd) column of
    // feature j0 + c / 2.
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int kk = idx / TILE;
      const int c = idx % TILE;
      const int jj = j0 + c / 2;
      const int kc = k0 + kk;
      Bs[kk][c] = (kc < k2 && jj < k)
                      ? abar[static_cast<size_t>(kc) * k2 + (c & 1) * k + jj]
                      : 0.0f;
    }
    __syncthreads();
    tile::mma(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const float s = *scale;
  float ds_acc = 0.0f;
#pragma unroll
  for (int a = 0; a < MICRO; ++a) {
    const int r = r0 + ty * MICRO + a;
    if (r >= rows) continue;
    const float wr = w != nullptr ? w[r] : 1.0f;
    const float yr = y[r];
    const size_t at = static_cast<size_t>(r) * k2;
#pragma unroll
    for (int q = 0; q < MICRO / 2; ++q) {
      const int jj = j0 + tx * (MICRO / 2) + q;
      if (jj >= k) continue;
      const float g_cos = wr * (s * acc[a][2 * q] + yr * pbar[jj]);
      const float g_sin = wr * (s * acc[a][2 * q + 1] + yr * pbar[k + jj]);
      const float c = phi[at + jj];
      const float sn = phi[at + k + jj];
      dT[static_cast<size_t>(r) * k + jj] = s * (g_sin * c - g_cos * sn);
      ds_acc += g_cos * c + g_sin * sn;
    }
  }
  const float v = block_sum(ds_acc, red, tid);
  if (tid == 0) {
    float* slot = ds_part + blockIdx.x * gridDim.y + blockIdx.y;
    *slot = first ? v : *slot + v;
  }
}

// One chunk: X and dT offset to the chunk; block (tile, group) adds its
// rows' X^T dT (and, for the tiles of the first D rows, sum dT) to its
// slot.
__global__ void __launch_bounds__(THREADS)
dfcat_kernel(const float* __restrict__ X, const float* __restrict__ dT,
             float* __restrict__ part, size_t width, int rows, int d, int k,
             int ktiles, bool first) {
  __shared__ __align__(16) tile::Stage As;  // As[kk][i] = X[r0 + kk][d0 + i]
  __shared__ __align__(16) tile::Stage Bs;  // Bs[kk][c] = dT[r0 + kk][j0 + c]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  const int d0 = (blockIdx.x / ktiles) * TILE;
  const int j0 = (blockIdx.x % ktiles) * TILE;
  const bool sums = d0 == 0 && ty == 0;  // these threads also sum dpcat
  float* slot = part + blockIdx.y * width;

  float acc[MICRO][MICRO];
  tile::zero(acc);
  float dp[MICRO] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int steps = (rows + KC - 1) / KC;
  for (int st = blockIdx.y; st < steps; st += gridDim.y) {
    const int r0 = st * KC;
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int kk = idx / TILE;
      const int c = idx % TILE;
      const int r = r0 + kk;
      As[kk][c] = (r < rows && d0 + c < d)
                      ? X[static_cast<size_t>(r) * d + d0 + c] : 0.0f;
      Bs[kk][c] = (r < rows && j0 + c < k)
                      ? dT[static_cast<size_t>(r) * k + j0 + c] : 0.0f;
    }
    __syncthreads();
    tile::mma(As, Bs, acc, tx, ty);
    if (sums) {
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int b = 0; b < MICRO; ++b) dp[b] += Bs[kk][tx * MICRO + b];
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < MICRO; ++a) {
    const int i = d0 + ty * MICRO + a;
    if (i >= d) continue;
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int j = j0 + tx * MICRO + b;
      if (j >= k) continue;
      float* o = slot + static_cast<size_t>(i) * k + j;
      *o = first ? acc[a][b] : *o + acc[a][b];
    }
  }
  if (sums) {
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int j = j0 + tx * MICRO + b;
      if (j >= k) continue;
      float* o = slot + static_cast<size_t>(d) * k + j;
      *o = first ? dp[b] : *o + dp[b];
    }
  }
}

// out = [dFcat (d * k) | dpcat (k) | ds]: the groups' slots added in the
// order g = 0..groups-1, and the ds slots in index order.
__global__ void __launch_bounds__(REDUCE_THREADS)
bwd_reduce_kernel(const float* __restrict__ part,
                  const float* __restrict__ ds_part, float* __restrict__ out,
                  int groups, size_t width, int ds_slots) {
  const size_t j = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (j < width) {
    float v = 0.0f;
    for (int g = 0; g < groups; ++g) v += part[g * width + j];
    out[j] = v;
  } else if (j == width) {
    float v = 0.0f;
    for (int i = 0; i < ds_slots; ++i) v += ds_part[i];
    out[j] = v;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace the call
// needs for these shapes: Abar, one chunk of phi and dT, the ds slots and
// the groups' slots.
extern "C" size_t scfgp_gram_bwd_workspace(int n, int d, int k) {
  const Plan p = plan(n, d, k);
  return static_cast<size_t>(p.k2) * p.k2 +
         static_cast<size_t>(p.chunk_rows) * (p.k2 + k) + p.ds_slots +
         p.groups * p.width;
}

// Every pointer is a device pointer to contiguous float32 data: X (n, d),
// y (n,), w (n,) or null for weights of 1, Fcat (d, k), pcat (k,), scale
// (1,), cbar (2k, 2k), pbar (2k,), `work` scfgp_gram_bwd_workspace(n, d, k)
// floats, and `out` d*k + k + 1 floats that receive [dFcat | dpcat | ds].
// n >= 1, k >= 1.  Launches every stage on `stream` (a cudaStream_t), does
// not synchronise, allocates nothing, and returns the first
// cudaGetLastError() code that is not 0 (0 on success).
extern "C" int scfgp_gram_bwd_f32(const float* X, const float* y,
                                  const float* w, const float* Fcat,
                                  const float* pcat, const float* scale,
                                  const float* cbar, const float* pbar,
                                  float* work, float* out, int n, int d, int k,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n, d, k);
  float* abar = work;
  float* phi = abar + static_cast<size_t>(p.k2) * p.k2;
  float* dT = phi + static_cast<size_t>(p.chunk_rows) * p.k2;
  float* ds_part = dT + static_cast<size_t>(p.chunk_rows) * k;
  float* part = ds_part + p.ds_slots;

  const size_t square = static_cast<size_t>(p.k2) * p.k2;
  abar_kernel<<<static_cast<unsigned>((square + REDUCE_THREADS - 1) /
                                      REDUCE_THREADS),
                REDUCE_THREADS, 0, st>>>(cbar, abar, p.k2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 block(tile::TX, tile::TY);
  for (int row0 = 0; row0 < n; row0 += p.chunk_rows) {
    const int rows = min(p.chunk_rows, n - row0);
    const bool first = row0 == 0;
    err = features::launch(X + static_cast<size_t>(row0) * d, Fcat, pcat,
                           nullptr, phi, rows, d, k, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 g_grid((rows + TILE - 1) / TILE, p.jtiles);
    g_kernel<<<g_grid, block, 0, st>>>(
        phi, abar, y + row0, w != nullptr ? w + row0 : nullptr, pbar, scale,
        dT, ds_part, rows, k, first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 f_grid(p.dtiles * p.ktiles, p.groups);
    dfcat_kernel<<<f_grid, block, 0, st>>>(
        X + static_cast<size_t>(row0) * d, dT, part, p.width, rows, d, k,
        p.ktiles, first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(
      (p.width + 1 + REDUCE_THREADS - 1) / REDUCE_THREADS);
  bwd_reduce_kernel<<<blocks, REDUCE_THREADS, 0, st>>>(
      part, ds_part, out, p.groups, p.width, p.ds_slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
