// K2 forward: the Phi-free weighted sufficient statistics on Hopper.
//
//   phiTphi = Phi^T diag(w) Phi    (2K, 2K), exactly symmetric
//   phiTy   = Phi^T (w * y)        (2K,)
//   yTy     = sum(w * y^2),   n = sum(w)
//
// with Phi = s * [cos T | sin T], T = X Fcat + pcat, X (N, D), y and w (N,)
// (w null: every weight 1).  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/gram.py::_fwd_kernel (entry _fwd_call, reached from
// sufficient_stats_pallas), which kept three Kp x Kp quadrant accumulators
// resident in VMEM across a sequential grid of row tiles and never wrote
// Phi to HBM.  Neither carries over: the accumulators (768 KB at K = 256)
// do not fit one SM, and CUDA blocks run in parallel and in no order.  What
// carries over is what it computes and that Phi is never held for all N
// rows.  The 128-lane padding of D and K and the rounding of N up to 512
// rows are gone.
//
// Design, every product on the 128 x 128 register-blocked tile of
// sgemm_tile.cuh.  The rows are taken in chunks (plan: as few as fit
// CHUNK_BUDGET bytes of Phi, and of w Phi with weights, of equal size; at
// the streaming block one chunk of 16384 rows, 32 MB), and for each chunk
//
//   1. features::launch writes the chunk's Phi row-major with a row pitch
//      ldp, 2K rounded up to a multiple of 4, so that both Gram operands
//      load by 16-byte cp.async whatever K (K1f's own kernel: for D >= 64
//      T by the tile with a sincosf epilogue, for D < 64 the narrow
//      design); with weights, weigh_kernel writes w Phi beside it;
//   2. vec_kernel: block (32 columns, 128-row tile) sums w y Phi, w y^2
//      and w over its rows in a fixed order into the row tile's slot,
//      while the chunk's Phi is still in L2 (after the Gram it took 26
//      instead of 19 us at the streaming block);
//   3. gram_kernel: block (upper tile, row group) takes the product
//      Phi[:, I]^T (w Phi)[:, J] over its group's contiguous rows, one of
//      the t(t+1)/2 upper 128 x 128 tiles of the Gram (t = ceil(2K / 128);
//      10 at 2K = 512), and adds it to its group's slot.  The Gram's depth
//      is the row, so Phi row-major is already k-major for both operands;
//
// and then 4. gram_reduce_kernel: one thread an upper-tile entry adds the
// groups' slots in the order g = 0..G-1 and writes entry (i, j) and (j, i),
// so phiTphi comes out exactly symmetric; the vector part adds the row
// tiles' slots in order.  Each slot entry is read, added to and written by
// one thread, chunk after chunk, and there are no atomics, so the result
// depends on the shapes alone and is bitwise repeatable.  The groups fill
// one wave of two blocks an SM on 132 SMs (26 groups at 2K = 512, 16.6 MB
// of slots), with at least 256 rows each and within SLOT_BUDGET.
//
// What bounds it on an H100 (chip_smoke.py::k2f_work): per row, D * K FMAs
// for T and a sincosf per (row, feature), and the upper triangle of the
// Gram, 2K (2K + 1) / 2 FMAs.  At the streaming block of the N=1e6, D=256,
// S=56, M=200 configuration (K = 256): 6.45 GFLOP for a 16,384-row block,
// 0.096 ms at 67 TFLOP/s on the FP32 pipes (TF32 is off by the port's
// precision policy).  The tiles of the diagonal compute their lower half
// too: 10 tiles of 128^2 are 5.4 GFLOP of the Gram where 4.3 are needed.
//
// Registers and shared memory (ptxas, sm_90a), no spills: gram_kernel 127
// and 16,896 bytes, feature_tile_kernel 119 and 16,896, vec_kernel 32 and
// 1,024, gram_reduce_kernel 32, weigh_kernel 16.  Device time on an NVIDIA
// H100 80GB HBM3 at 700.00 W (experiments/kernel_ab.py, PERF.md §6): 0.246
// ms at the streaming block (gram_kernel 135 us, ~40 TFLOP/s; the features
// 76, vec_kernel 19, the reduce 11), against 0.577 for the previous 64 x 64
// tile and 0.387 for the plain version; 0.118 ms at kin8nm (0.206), 0.208
// at (4096, 256, 500) (0.435).  Two waves of groups instead of one took
// 3-16% longer.
//
// Precision: precise sincosf (features.cuh), fp32 FMAs, fp32 accumulation
// throughout: the Gram feeds a Cholesky (scfgp_tpu/models/objective.py).

#include <cuda_runtime.h>

#include <cstddef>

#include "features.cuh"
#include "sgemm_tile.cuh"

namespace {

using sgemm::BM;

constexpr size_t CHUNK_BUDGET = size_t(32) << 20;  // bytes of Phi (w Phi)
constexpr size_t SLOT_BUDGET = size_t(48) << 20;   // bytes of group slots
// gram_kernel's blocks fill one wave, two an SM on the H100's 132 SMs, and
// a group holds at least GROUP_ROWS rows, so that writing its 64 KB slot
// stays a small share of its product.
constexpr int WAVE_BLOCKS = 2 * 132;
constexpr int GROUP_ROWS = 256;
constexpr int THREADS1 = 256;  // vec, weigh and reduce kernels
// vec_kernel: a block's columns, and the row lanes that split its rows.
constexpr int VEC_COLS = 32;
constexpr int VEC_LANES = THREADS1 / VEC_COLS;
constexpr size_t TILE_FLOATS = static_cast<size_t>(BM) * BM;

int tiles(int n) { return (n + BM - 1) / BM; }
int round4(int n) { return (n + 3) / 4 * 4; }

// The number of (ti <= tj) tiles of a t x t grid of tiles, and the tile
// (ti, tj) of the upper triangle that index `idx` names, row by row.
int triangle(int t) { return t * (t + 1) / 2; }

__device__ inline void upper_tile(int idx, int t, int* ti, int* tj) {
  int i = 0;
  while (idx >= t - i) {
    idx -= t - i;
    ++i;
  }
  *ti = i;
  *tj = i + idx;
}

struct Plan {
  int k2;          // 2K, the Gram's side
  int ldp;         // row pitch of the chunk's Phi, a multiple of 4
  int t;           // tiles per side
  int tiles;       // upper-triangle tiles
  int copies;      // Phi, and w Phi with weights
  int chunk_rows;  // a multiple of BM
  int groups;      // row groups G of gram_kernel
  size_t width;    // floats in one group's slot
};

// Depends on the shapes alone, so the order of every sum does too.
Plan plan(int n, int k, bool weighted) {
  Plan p;
  p.k2 = 2 * k;
  p.ldp = round4(p.k2);
  p.t = tiles(p.k2);
  p.tiles = triangle(p.t);
  p.copies = weighted ? 2 : 1;
  size_t most = CHUNK_BUDGET /
                (static_cast<size_t>(p.copies) * p.ldp * sizeof(float)) / BM *
                BM;
  if (most < static_cast<size_t>(BM)) most = BM;
  const size_t chunks = (static_cast<size_t>(n) + most - 1) / most;
  const size_t rows = (static_cast<size_t>(n) + chunks - 1) / chunks;
  p.chunk_rows = tiles(static_cast<int>(rows)) * BM;
  p.width = static_cast<size_t>(p.tiles) * TILE_FLOATS;
  size_t g = static_cast<size_t>(WAVE_BLOCKS) / p.tiles;
  const size_t by_memory = SLOT_BUDGET / (p.width * sizeof(float));
  if (g > by_memory) g = by_memory;
  if (g > static_cast<size_t>(p.chunk_rows / GROUP_ROWS))
    g = p.chunk_rows / GROUP_ROWS;
  p.groups = g < 1 ? 1 : static_cast<int>(g);
  return p;
}

// Floats of workspace: Phi (and w Phi) of a chunk, the group slots and the
// row tiles' slots of the vector part.
size_t floats(const Plan& p) {
  return static_cast<size_t>(p.copies) * p.chunk_rows * p.ldp +
         static_cast<size_t>(p.groups) * p.width +
         static_cast<size_t>(p.chunk_rows / BM) * (p.k2 + 2);
}

// wphi = w * phi, row by row, for one chunk (w offset to it).
__global__ void __launch_bounds__(THREADS1)
weigh_kernel(const float* __restrict__ phi, const float* __restrict__ w,
             float* __restrict__ wphi, int rows, int k2, int ldp) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * THREADS1 + threadIdx.x;
  if (idx >= static_cast<size_t>(rows) * k2) return;
  const size_t at = idx / k2 * ldp + idx % k2;
  wphi[at] = w[idx / k2] * phi[at];
}

// One chunk: block (tile of the upper triangle, row group) adds its group's
// rows of A^T B, A = Phi and B = w Phi (rows, ldp), to the tile's place in
// the group's slot of `part` (groups x width).
__global__ void __launch_bounds__(sgemm::THREADS, 2)
gram_kernel(sgemm::Operand A, sgemm::Operand B, float* __restrict__ part,
            size_t width, int rows, int t, bool first) {
  __shared__ __align__(16) sgemm::Smem sm;
  const int tid = threadIdx.x;
  const int tx = sgemm::thread_x(tid);
  const int ty = sgemm::thread_y(tid);
  int ti, tj;
  upper_tile(blockIdx.x, t, &ti, &tj);
  const int steps = (rows + sgemm::BK - 1) / sgemm::BK;
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.y) * steps /
                                  gridDim.y);
  const int s1 = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * steps / gridDim.y);
  const int r0 = s0 * sgemm::BK;
  const int depth = max(min(s1 * sgemm::BK, rows) - r0, 0);

  float acc[sgemm::MICRO][sgemm::MICRO];
  sgemm::product<true, true>(sgemm::at_depth(A, r0), sgemm::at_depth(B, r0),
                             depth, ti * BM, tj * BM, sm, acc);
  float* slot = part + blockIdx.y * width + blockIdx.x * TILE_FLOATS;
#pragma unroll
  for (int a = 0; a < sgemm::MICRO; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* o = reinterpret_cast<float4*>(
          slot + sgemm::row_of(a, ty) * BM + sgemm::col_of(4 * h, tx));
      float4 v = make_float4(acc[a][4 * h], acc[a][4 * h + 1],
                             acc[a][4 * h + 2], acc[a][4 * h + 3]);
      if (!first) {
        const float4 old = *o;
        v = make_float4(old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w);
      }
      *o = v;
    }
  }
}

// One chunk (y, w offset to it): block (column block, row tile) sums over
// the tile's rows w y Phi[:, j] for its VEC_COLS columns j < k2, w y^2
// (j = k2) and w (j = k2 + 1) into the row tile's slot of `vpart`.  Lane l
// of a column takes rows r0 + l, r0 + l + VEC_LANES, ... in order, and lane
// 0 adds the lanes' sums in the order l = 0..VEC_LANES-1.
__global__ void __launch_bounds__(THREADS1)
vec_kernel(const float* __restrict__ phi, int ldp, const float* __restrict__ y,
           const float* __restrict__ w, float* __restrict__ vpart, int rows,
           int k2, bool first) {
  __shared__ float red[VEC_LANES][VEC_COLS];
  const int c = threadIdx.x % VEC_COLS;
  const int lane = threadIdx.x / VEC_COLS;
  const int j = blockIdx.x * VEC_COLS + c;
  const int r0 = blockIdx.y * BM;
  const int r1 = min(r0 + BM, rows);
  float acc = 0.0f;
  if (j < k2 + 2) {
#pragma unroll 4
    for (int r = r0 + lane; r < r1; r += VEC_LANES) {
      const float wr = w != nullptr ? w[r] : 1.0f;
      if (j == k2 + 1) {
        acc += wr;
      } else {
        const float v = j < k2 ? phi[static_cast<size_t>(r) * ldp + j] : y[r];
        acc = fmaf(wr * y[r], v, acc);
      }
    }
  }
  red[lane][c] = acc;
  __syncthreads();
  if (lane == 0 && j < k2 + 2) {
    float v = red[0][c];
    for (int l = 1; l < VEC_LANES; ++l) v += red[l][c];
    float* o = vpart + static_cast<size_t>(blockIdx.y) * (k2 + 2) + j;
    *o = first ? v : *o + v;
  }
}

// out = [phiTphi (k2 * k2) | phiTy (k2) | yTy | n].  Thread idx < width
// owns one entry of the upper tiles: the sum of the groups' slots in the
// order g = 0..groups-1, written to (i, j) and (j, i) (in a diagonal tile
// the entries below its diagonal are not read).  The threads after them
// add the vector part's row-tile slots in order.
__global__ void __launch_bounds__(THREADS1)
gram_reduce_kernel(const float* __restrict__ part, int groups, size_t width,
                   const float* __restrict__ vpart, int vslots,
                   float* __restrict__ out, int k2, int t) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * THREADS1 + threadIdx.x;
  float v = 0.0f;
  if (idx < width) {
    int ti, tj;
    upper_tile(static_cast<int>(idx / TILE_FLOATS), t, &ti, &tj);
    const int e = static_cast<int>(idx % TILE_FLOATS);
    const int i = ti * BM + e / BM;
    const int j = tj * BM + e % BM;
    if (i >= k2 || j >= k2 || i > j) return;
    for (int g = 0; g < groups; ++g) v += part[g * width + idx];
    out[static_cast<size_t>(i) * k2 + j] = v;
    out[static_cast<size_t>(j) * k2 + i] = v;
  } else if (idx < width + k2 + 2) {
    const size_t j = idx - width;
    for (int s = 0; s < vslots; ++s)
      v += vpart[static_cast<size_t>(s) * (k2 + 2) + j];
    out[static_cast<size_t>(k2) * k2 + j] = v;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace the call
// needs for these shapes, with or without weights.
extern "C" size_t scfgp_gram_fwd_workspace(int n, int d, int k) {
  (void)d;
  const size_t plain = floats(plan(n, k, false));
  const size_t weighted = floats(plan(n, k, true));
  return plain > weighted ? plain : weighted;
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
  const Plan p = plan(n, k, w != nullptr);
  const size_t chunk = static_cast<size_t>(p.chunk_rows) * p.ldp;
  float* phi = work;
  float* wphi = w != nullptr ? phi + chunk : phi;
  float* part = phi + p.copies * chunk;
  float* vpart = part + static_cast<size_t>(p.groups) * p.width;
  const sgemm::Operand A = sgemm::operand(phi, p.ldp, p.k2);
  const sgemm::Operand B = sgemm::operand(wphi, p.ldp, p.k2);
  const int vblocks = (p.k2 + 2 + VEC_COLS - 1) / VEC_COLS;
  for (int row0 = 0; row0 < n; row0 += p.chunk_rows) {
    const int rows = min(p.chunk_rows, n - row0);
    const bool first = row0 == 0;
    cudaError_t err = features::launch(X + static_cast<size_t>(row0) * d,
                                       Fcat, pcat, scale, phi, rows, d, k,
                                       p.ldp, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (w != nullptr) {
      const size_t count = static_cast<size_t>(rows) * p.k2;
      weigh_kernel<<<static_cast<unsigned>((count + THREADS1 - 1) / THREADS1),
                     THREADS1, 0, st>>>(phi, w + row0, wphi, rows, p.k2,
                                        p.ldp);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    vec_kernel<<<dim3(vblocks, tiles(rows)), THREADS1, 0, st>>>(
        phi, p.ldp, y + row0, w != nullptr ? w + row0 : nullptr, vpart, rows,
        p.k2, first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_kernel<<<dim3(p.tiles, p.groups), sgemm::THREADS, 0, st>>>(
        A, B, part, p.width, rows, p.t, first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t outputs = p.width + p.k2 + 2;
  gram_reduce_kernel<<<static_cast<unsigned>((outputs + THREADS1 - 1) /
                                             THREADS1),
                       THREADS1, 0, st>>>(part, p.groups, p.width, vpart,
                                          tiles(min(n, p.chunk_rows)), out,
                                          p.k2, p.t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
