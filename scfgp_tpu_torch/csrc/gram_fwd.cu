// K2 forward: the Phi-free weighted sufficient statistics on Hopper.
//
//   phiTphi = Phi^T diag(w) Phi    (2K, 2K), exactly symmetric
//   phiTy   = Phi^T (w * y)        (2K,)
//   yTy     = sum(w * y^2),   n = sum(w)
//
// with Phi = s * [cos T | sin T], T = X Fcat + pcat, X (N, D), y and w (N,)
// (w null: every weight 1).  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/gram.py::_fwd_kernel (entry sufficient_stats_pallas), which
// kept three Kp x Kp quadrant accumulators resident in VMEM across a
// sequential grid of row tiles and never wrote Phi to HBM.  Neither carries
// over: the accumulators (768 KB at K = 256) do not fit one SM, and CUDA
// blocks run in parallel and in no order.  What carries over is what it
// computes and that Phi is never held for all N rows.  The 128-lane padding
// of D and K and the rounding of N up to 512 rows are gone.
//
// Design: the rows are taken in chunks of at most CHUNK_BUDGET bytes of
// features (4096 rows at 2K = 512), and for each chunk
//
//   1. features::feature_kernel writes the chunk's Phi, each cos/sin
//      computed once, into a scratch of one chunk (L2-sized, never N-sized);
//   2. gram_tile_kernel: block (tile, group) owns one 64 x 64 tile of the
//      upper triangle of the Gram (by symmetry only T(T+1)/2 of the T^2
//      tiles, T = ceil(2K / 64)) and one of G row groups; it walks the
//      chunk's 32-row steps group, group + G, ... in order and adds
//      Phi[:, I]^T (w Phi[:, J]) to its own slot of a workspace.  The
//      diagonal tiles also sum phiTy for their columns, tile 0 yTy and n.
//
// and then 3. gram_reduce_kernel adds the G slots in the order g = 0..G-1,
// one thread per output, reading entry (i, j) and (j, i) from the same
// upper-triangle slot, so phiTphi comes out exactly symmetric.  Each slot
// entry is read, added to and written by one thread, chunk after chunk, so
// the result is bitwise repeatable; there are no atomics.
//
// What bounds it on an H100, per row: the projection T, D * K FMAs, and
// one sincosf per (row, feature), once; and the upper-triangle Gram,
// T(T+1)/2 * 64 * 64 FMAs.  At the streaming block of the N=1e6, D=256,
// S=56, M=200 configuration (K = 256, 2K = 512, T = 8): 65,536 + 147,456 =
// 212,992 FMAs a row, 3.5 G FMAs for a 16,384-row block, all on the FP32
// pipes (67 TFLOP/s peak; TF32 is off by the port's precision policy).  A
// design in which each tile recomputes T for its own columns instead would
// take 36 tiles x 128 columns x 256 = 1.2 M FMAs a row for the projection
// alone.  The features of a chunk are written once and read back from L2
// by each tile (4096 x 512 x 4 B = 8 MB).  The 64 x 64 tile with 4 x 4
// outputs a thread (tile_mma.cuh) is the simple first version; wgmma and
// TMA are later work.
//
// Precision: precise sincosf (features.cuh), fp32 FMAs, fp32 accumulation
// throughout: the Gram feeds a Cholesky (scfgp_tpu/models/objective.py).

#include <cuda_runtime.h>

#include <cstddef>

#include "features.cuh"
#include "tile_mma.cuh"

namespace {

using tile::KC;
using tile::MICRO;
using tile::THREADS;
using tile::TILE;

constexpr size_t CHUNK_BUDGET = size_t(8) << 20;    // bytes of chunk features
constexpr size_t PARTIAL_BUDGET = size_t(16) << 20;  // bytes of slots
// Enough blocks for two waves on the H100's 132 SMs.
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr int REDUCE_THREADS = 256;

struct Plan {
  int k2;          // 2K, the Gram's side
  int t;           // tiles per side
  int tiles;       // upper-triangle tiles
  int chunk_rows;  // rows per chunk, a multiple of KC
  int groups;      // row groups G
  size_t width;    // floats in one group's slot
};

// Depends on the shapes alone, so the order of every sum does too.
Plan plan(int n, int k) {
  Plan p;
  p.k2 = 2 * k;
  p.t = (p.k2 + TILE - 1) / TILE;
  p.tiles = tile::triangle(p.t);
  p.width = static_cast<size_t>(p.tiles) * TILE * TILE + p.k2 + 2;
  size_t rows = CHUNK_BUDGET / (static_cast<size_t>(p.k2) * sizeof(float));
  rows = rows / KC * KC;
  const size_t all = (static_cast<size_t>(n) + KC - 1) / KC * KC;
  if (rows > all) rows = all;
  if (rows < KC) rows = KC;
  p.chunk_rows = static_cast<int>(rows);
  size_t g = (TARGET_BLOCKS + p.tiles - 1) / p.tiles;
  const size_t by_memory = PARTIAL_BUDGET / (p.width * sizeof(float));
  if (g > by_memory) g = by_memory;
  if (g > rows / KC) g = rows / KC;
  p.groups = g < 1 ? 1 : static_cast<int>(g);
  return p;
}

// One chunk: rows of `phi` (rows, k2), y and w offset to the chunk.
__global__ void __launch_bounds__(THREADS)
gram_tile_kernel(const float* __restrict__ phi, const float* __restrict__ y,
                 const float* __restrict__ w, float* __restrict__ part,
                 size_t width, int rows, int k2, int t, bool first) {
  __shared__ __align__(16) tile::Stage As;
  __shared__ __align__(16) tile::Stage Bs;
  __shared__ float ys[KC];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * tile::TX + tx;
  int ti, tj;
  tile::upper_tile(blockIdx.x, t, &ti, &tj);
  const bool diag = ti == tj;
  const int ci = ti * TILE;
  const int cj = tj * TILE;
  float* slot = part + blockIdx.y * width;

  float acc[MICRO][MICRO];
  tile::zero(acc);
  float py[MICRO] = {0.0f, 0.0f, 0.0f, 0.0f};  // phiTy, diagonal tiles
  float yy = 0.0f, nn = 0.0f;                  // yTy and n, tile 0

  const int steps = (rows + KC - 1) / KC;
  for (int st = blockIdx.y; st < steps; st += gridDim.y) {
    const int r0 = st * KC;
    for (int idx = tid; idx < KC * TILE; idx += THREADS) {
      const int kk = idx / TILE;
      const int c = idx % TILE;
      const int r = r0 + kk;
      const bool ok = r < rows;
      const float wr = ok ? (w != nullptr ? w[r] : 1.0f) : 0.0f;
      const size_t at = static_cast<size_t>(r) * k2;
      As[kk][c] = (ok && ci + c < k2) ? phi[at + ci + c] : 0.0f;
      Bs[kk][c] = (ok && cj + c < k2) ? wr * phi[at + cj + c] : 0.0f;
    }
    if (diag && tid < KC) ys[tid] = r0 + tid < rows ? y[r0 + tid] : 0.0f;
    __syncthreads();
    tile::mma(As, Bs, acc, tx, ty);
    if (diag && ty == 0) {
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int b = 0; b < MICRO; ++b)
          py[b] = fmaf(Bs[kk][tx * MICRO + b], ys[kk], py[b]);
    }
    if (blockIdx.x == 0 && tid == 0) {
      for (int r = r0; r < min(r0 + KC, rows); ++r) {
        const float wr = w != nullptr ? w[r] : 1.0f;
        yy = fmaf(wr * y[r], y[r], yy);
        nn += wr;
      }
    }
    __syncthreads();
  }

  float* out = slot + static_cast<size_t>(blockIdx.x) * TILE * TILE;
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      float* o = out + (ty * MICRO + a) * TILE + tx * MICRO + b;
      *o = first ? acc[a][b] : *o + acc[a][b];
    }
  float* tail = slot + static_cast<size_t>(tile::triangle(t)) * TILE * TILE;
  if (diag && ty == 0) {
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int j = ci + tx * MICRO + b;
      if (j < k2) tail[j] = first ? py[b] : tail[j] + py[b];
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    tail[k2] = first ? yy : tail[k2] + yy;
    tail[k2 + 1] = first ? nn : tail[k2 + 1] + nn;
  }
}

// out = [phiTphi (k2 * k2) | phiTy (k2) | yTy | n], each the sum of the
// groups' slots in the order g = 0..groups-1.
__global__ void __launch_bounds__(REDUCE_THREADS)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int groups, size_t width, int k2, int t) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const size_t gram = static_cast<size_t>(k2) * k2;
  size_t off;
  if (idx < gram) {
    const int i = static_cast<int>(idx / k2);
    const int j = static_cast<int>(idx % k2);
    const int lo = min(i, j);
    const int hi = max(i, j);
    off = static_cast<size_t>(tile::upper_index(lo / TILE, hi / TILE, t)) *
              TILE * TILE +
          (lo % TILE) * TILE + hi % TILE;
  } else if (idx < gram + k2 + 2) {
    off = static_cast<size_t>(tile::triangle(t)) * TILE * TILE + (idx - gram);
  } else {
    return;
  }
  float v = 0.0f;
  for (int g = 0; g < groups; ++g) v += part[g * width + off];
  out[idx] = v;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace the call
// needs for these shapes: one chunk of features and the groups' slots.
extern "C" size_t scfgp_gram_fwd_workspace(int n, int d, int k) {
  (void)d;
  const Plan p = plan(n, k);
  return static_cast<size_t>(p.chunk_rows) * p.k2 + p.groups * p.width;
}

// Every pointer is a device pointer to contiguous float32 data: X (n, d),
// y (n,), w (n,) or null for weights of 1, Fcat (d, k), pcat (k,), scale
// (1,), `work` scfgp_gram_fwd_workspace(n, d, k) floats, and `out`
// (2k)^2 + 2k + 2 floats that receive [phiTphi | phiTy | yTy | n].  n >= 1,
// k >= 1.  Launches every stage on `stream` (a cudaStream_t), does not
// synchronise, allocates nothing, and returns the first cudaGetLastError()
// code that is not 0 (0 on success).
extern "C" int scfgp_gram_fwd_f32(const float* X, const float* y,
                                  const float* w, const float* Fcat,
                                  const float* pcat, const float* scale,
                                  float* work, float* out, int n, int d, int k,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n, k);
  float* phi = work;
  float* part = work + static_cast<size_t>(p.chunk_rows) * p.k2;
  const dim3 block(tile::TX, tile::TY);
  const dim3 grid(p.tiles, p.groups);
  for (int row0 = 0; row0 < n; row0 += p.chunk_rows) {
    const int rows = min(p.chunk_rows, n - row0);
    cudaError_t err = features::launch(X + static_cast<size_t>(row0) * d,
                                       Fcat, pcat, scale, phi, rows, d, k, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_tile_kernel<<<grid, block, 0, st>>>(
        phi, y + row0, w != nullptr ? w + row0 : nullptr, part, p.width, rows,
        p.k2, p.t, row0 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t outputs = static_cast<size_t>(p.k2) * p.k2 + p.k2 + 2;
  const unsigned blocks =
      static_cast<unsigned>((outputs + REDUCE_THREADS - 1) / REDUCE_THREADS);
  gram_reduce_kernel<<<blocks, REDUCE_THREADS, 0, st>>>(part, out, p.groups,
                                                        p.width, p.k2, p.t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
