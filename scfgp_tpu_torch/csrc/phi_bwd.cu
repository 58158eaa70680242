// K1 backward: the gradient of the fused trig Fourier feature map on Hopper.
//
// Given the cotangent g (N, 2K) of Phi = s * [cos T | sin T], T = X Fcat +
// pcat, split as g_cos = g[:, :K] and g_sin = g[:, K:], it computes
//
//   dT    = s * (g_sin * cos T - g_cos * sin T)        (N, K)
//   dFcat = X^T dT                                     (D, K)
//   dpcat = sum over rows of dT                        (K,)
//   ds    = sum of g_cos * cos T + g_sin * sin T       ()
//
// recomputing T from X, Fcat and pcat, as the forward never stores it.  X is
// data and gets no gradient.  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/phi.py::_bwd_kernel (entry _phi_bwd_call), which summed its
// row tiles into resident outputs across a sequential grid (pl.when(i == 0)
// initialised them).  CUDA blocks run in parallel and in no order, so every
// sum over rows goes to slots of a workspace and a last stage adds them in
// a fixed order, with no float atomics: the gradient is bitwise the same
// from run to run, which the fused training loop's bitwise resume needs.
//
// What bounds it on an H100: two N*D*K FMA products (T, then X^T dT) and
// one precise sincosf per (row, feature) on the FP32 pipes, and reading g
// (N * 2K * 4 bytes).  At D = 256 (the streaming block, 16384 x 256 x 256)
// that is 4.3 GFLOP, 0.064 ms at 67 TFLOP/s; at D = 8 (kin8nm, 6553 x 8 x
// 277) the 14.5 MB of g, 0.0044 ms at 3.35 TB/s, and a launch costs about
// as much as the work.  Two designs, chosen by D alone:
//
// Wide (D >= WIDE_D), on the 128 x 128 register-blocked tile of
// sgemm_tile.cuh, over chunks of rows whose dT fits CHUNK_BUDGET:
//   1. phi_t_kernel: block (row tile, column tile) computes T by the tile
//      (X m-major through registers, Fcat k-major by cp.async); its
//      epilogue does the sincosf, reads g's cos and sin columns, writes dT
//      to the chunk's scratch and sums dpcat and ds of the block into the
//      block's slots (dfcat::block_sums);
//   2. dfcat::dfcat_kernel: X^T dT by the tile, split over row groups into
//      slots, the routine K2b (gram_bwd.cu) ends in too;
//   3. dfcat::bwd_reduce_kernel adds the slots in a fixed order.
// At the streaming block the chunk is the whole 16384 rows (16 MB of dT):
// 256 blocks in stage 1 and 4 tiles x 64 groups in stage 2, about two
// waves on 132 SMs each.
//
// Narrow (D < WIDE_D): at D = 8 the tile's 128-row side would hold 8 rows of
// X^T dT, 1/16 of its work.  phi_bwd_partial_kernel keeps dT in shared
// memory instead: block (group, 64-column tile) walks the row tiles group,
// group + G, ... in order, recomputes T with D FMAs a (row, column), and
// adds its X^T dT, dpcat and ds to its own slot; phi_bwd_reduce_kernel adds
// the G slots in order.  At D = 8 this is 2.66x faster than the plain
// version (PERF.md, PR 2); at D = 256 its X^T dT, one output a thread with
// two shared loads an FMA, ran at ~5.5 TFLOP/s.  The wide design at D = 8
// measured 0.0457 against 0.0470 ms at kin8nm but 0.0482 against 0.0380 at
// bench (N = 8192, K = 250).
//
// Registers and shared memory (ptxas, sm_90a), no spills: phi_t_kernel 121
// and 16,896 bytes, dfcat_kernel 128 and 16,896, phi_bwd_partial_kernel 64
// and 33,024.  Device time on an NVIDIA H100 80GB HBM3 at 700.00 W
// (experiments/kernel_ab.py, PERF.md PR 7): 0.161 ms at the streaming block
// (phi_t_kernel 83 us, dfcat_kernel 65, the reduce 9; the previous design
// 0.779), 0.118 ms at (4096, 256, 500) (0.333), and 0.0476 ms at kin8nm
// (narrow, unchanged).  Batched instances (chip_smoke.py phase 11a): 80
// registers in phi_bwd_partial_kernel, 125 in phi_t_kernel; 50 boston
// trials (455, 13, 70) 0.042 ms in one call against 0.81 for 50 calls.
//
// Precision: sincosf is the precise libdevice routine, no fast math, fp32
// accumulation throughout (scfgp_tpu/models/objective.py:150-153).
//
// Trials: one call takes B independent problems of one shape (a batched
// sweep's trials; the Pallas kernel gets them as a leading grid axis under
// jax.vmap).  Every stage's last grid axis is the trial, and each trial
// has its own share of the workspace (the workspace is B times one
// trial's), so every sum over rows runs in the order a call on that trial
// alone takes: trial b's gradient is bitwise the 2-D call's, with the same
// number of launches whatever B.  The offsets are compiled in only where a
// call has more than one trial (BATCHED: moved pointers live in registers,
// 64 -> 80 in phi_bwd_partial_kernel, and the reduce, whose serial loads
// bound it, took 13% longer at kin8nm with them, 18.6 -> 21.0 us, the
// whole 2-D call 5% longer), so the 2-D call keeps its code and its time.

#include <cuda_runtime.h>

#include <cstddef>

#include "dfcat.cuh"
#include "sgemm_tile.cuh"

namespace {

// D from which the wide design runs.
constexpr int WIDE_D = 64;
constexpr size_t CHUNK_BUDGET = size_t(16) << 20;  // bytes of dT, wide

// ---- wide -------------------------------------------------------------

struct Plan {
  int kpad;        // row pitch of dT, a multiple of 4
  int chunk_rows;  // a multiple of BM
  int rtiles;      // row tiles of a chunk: the dpcat slots
  int ctiles;      // column tiles
  int groups;      // row groups of dfcat_kernel
};

// Depends on the shapes alone, so the order of every sum does too.
Plan plan(int n, int d, int k) {
  Plan p;
  p.kpad = dfcat::round4(k);
  size_t rows = CHUNK_BUDGET / (static_cast<size_t>(p.kpad) * sizeof(float));
  rows = rows / sgemm::BM * sgemm::BM;
  const size_t all = static_cast<size_t>(dfcat::tiles(n)) * sgemm::BM;
  if (rows > all) rows = all;
  if (rows < sgemm::BM) rows = sgemm::BM;
  p.chunk_rows = static_cast<int>(rows);
  p.rtiles = p.chunk_rows / sgemm::BM;
  p.ctiles = dfcat::tiles(k);
  p.groups = dfcat::groups(p.chunk_rows, d, k);
  return p;
}

// Floats of the wide workspace: dT of a chunk, the group slots, the dpcat
// and the ds slots.
size_t wide_workspace(const Plan& p, int d, int k) {
  return static_cast<size_t>(p.chunk_rows) * p.kpad +
         static_cast<size_t>(p.groups) * d * k +
         static_cast<size_t>(p.rtiles) * k +
         static_cast<size_t>(p.rtiles) * p.ctiles;
}

// Floats between two trials' blocks of each operand and each workspace
// part.
struct Strides {
  size_t x, f, g, dT, dp, ds;
};

// One chunk: X and g offset to the chunk.  Writes dT (rows, kpad) and adds
// to the dpcat slots (rtiles x k) and the ds slots (rtiles x ctiles), of
// trial blockIdx.z.
template <bool BATCHED>
__global__ void __launch_bounds__(sgemm::THREADS, 2)
phi_t_kernel(sgemm::Operand X, sgemm::Operand F,
             const float* __restrict__ pcat, const float* __restrict__ scale,
             const float* __restrict__ g, float* __restrict__ dT,
             float* __restrict__ dp_part, float* __restrict__ ds_part,
             int rows, int d, int k, int kpad, bool first, Strides st) {
  __shared__ __align__(16) sgemm::Smem sm;
  if (BATCHED) {
    const size_t z = blockIdx.z;
    X.p += z * st.x;
    F.p += z * st.f;
    pcat += z * k;
    scale += z;
    g += z * st.g;
    dT += z * st.dT;
    dp_part += z * st.dp;
    ds_part += z * st.ds;
  }
  const int tid = threadIdx.x;
  const int tx = sgemm::thread_x(tid);
  const int ty = sgemm::thread_y(tid);
  const int m0 = blockIdx.x * sgemm::BM;
  const int n0 = blockIdx.y * sgemm::BM;

  float acc[sgemm::MICRO][sgemm::MICRO];
  sgemm::product<false, true>(X, F, d, m0, n0, sm, acc);

  const float s = *scale;
  const size_t ld = 2 * static_cast<size_t>(k);
  float pj[sgemm::MICRO];
  int col[sgemm::MICRO];
#pragma unroll
  for (int b = 0; b < sgemm::MICRO; ++b) {
    col[b] = sgemm::col_of(b, tx);
    pj[b] = n0 + col[b] < k ? pcat[n0 + col[b]] : 0.0f;
  }
  float dp[sgemm::MICRO];
#pragma unroll
  for (int b = 0; b < sgemm::MICRO; ++b) dp[b] = 0.0f;
  float ds = 0.0f;
#pragma unroll
  for (int a = 0; a < sgemm::MICRO; ++a) {
    const int r = m0 + sgemm::row_of(a, ty);
    if (r >= rows) continue;
    const float* gr = g + static_cast<size_t>(r) * ld;
#pragma unroll
    for (int b = 0; b < sgemm::MICRO; ++b) {
      const int j = n0 + col[b];
      float dt = 0.0f;
      if (j < k) {
        float sn, cs;
        sincosf(acc[a][b] + pj[b], &sn, &cs);
        const float g_cos = gr[j];
        const float g_sin = gr[k + j];
        dt = s * (g_sin * cs - g_cos * sn);
        ds += g_cos * cs + g_sin * sn;
        dp[b] += dt;
      }
      acc[a][b] = dt;
    }
    // Four columns at a time: j < k for the first of them means all four
    // lie inside the row pitch kpad (0 where j >= k).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = n0 + col[4 * h];
      if (j < k)
        *reinterpret_cast<float4*>(dT + static_cast<size_t>(r) * kpad + j) =
            make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                        acc[a][4 * h + 3]);
    }
  }
  dfcat::block_sums<sgemm::MICRO>(
      dp, col, sgemm::BM, ds, reinterpret_cast<float*>(&sm),
      dp_part + static_cast<size_t>(blockIdx.x) * k + n0, min(sgemm::BM, k - n0),
      ds_part + blockIdx.x * gridDim.y + blockIdx.y, first);
}

// The workspace holds each part for all trials, trial after trial: dT
// (trials x chunk_rows x kpad), the group slots, the dpcat slots, the ds
// slots.
int wide(const float* X, const float* Fcat, const float* pcat,
         const float* scale, const float* g, float* work, float* out,
         int trials, int n, int d, int k, cudaStream_t st) {
  const Plan p = plan(n, d, k);
  Strides s;
  s.x = static_cast<size_t>(n) * d;
  s.f = static_cast<size_t>(d) * k;
  s.g = static_cast<size_t>(n) * 2 * k;
  s.dT = static_cast<size_t>(p.chunk_rows) * p.kpad;
  s.dp = static_cast<size_t>(p.rtiles) * k;
  s.ds = static_cast<size_t>(p.rtiles) * p.ctiles;
  float* dT = work;
  float* part = dT + trials * s.dT;
  float* dp_part = part + trials * static_cast<size_t>(p.groups) * d * k;
  float* ds_part = dp_part + trials * s.dp;
  const sgemm::Operand F = sgemm::operand(Fcat, k, k);
  for (int row0 = 0; row0 < n; row0 += p.chunk_rows) {
    const int rows = min(p.chunk_rows, n - row0);
    const bool first = row0 == 0;
    const float* Xc = X + static_cast<size_t>(row0) * d;
    const dim3 grid(dfcat::tiles(rows), p.ctiles, trials);
    (trials > 1 ? phi_t_kernel<true> : phi_t_kernel<false>)
        <<<grid, sgemm::THREADS, 0, st>>>(
        sgemm::operand(Xc, d, rows), F, pcat, scale,
        g + static_cast<size_t>(row0) * 2 * k, dT, dp_part, ds_part, rows, d,
        k, p.kpad, first, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = dfcat::launch(Xc, dT, part, rows, d, k, p.kpad, p.groups, first, st,
                        trials, s.x, s.dT);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(dfcat::reduce(part, p.groups, dp_part, p.rtiles,
                                        ds_part, p.rtiles * p.ctiles, out, d,
                                        k, st, trials));
}

// ---- narrow -----------------------------------------------------------

namespace narrow {

constexpr int TILE_N = 64;
constexpr int TILE_K = 64;
constexpr int CHUNK_D = 32;
constexpr int THREADS_Y = 4;
constexpr int THREADS = TILE_K * THREADS_Y;
constexpr int ROWS_PER_THREAD = TILE_N / THREADS_Y;
constexpr int D_PER_THREAD = CHUNK_D / THREADS_Y;
constexpr int REDUCE_THREADS = 256;
// Enough blocks for two waves on the H100's 132 SMs.
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr size_t PARTIAL_BUDGET = size_t(8) << 20;  // bytes of workspace

int col_tiles(int k) { return (k + TILE_K - 1) / TILE_K; }

// Floats in one row group's slot: dFcat (D*K), dpcat (K), ds per column tile.
size_t slot_width(int d, int k) {
  return static_cast<size_t>(d) * k + k + col_tiles(k);
}

int row_groups(int n, int d, int k) {
  const int row_tiles = (n + TILE_N - 1) / TILE_N;
  size_t g = (TARGET_BLOCKS + col_tiles(k) - 1) / col_tiles(k);
  const size_t by_memory = PARTIAL_BUDGET / (slot_width(d, k) * sizeof(float));
  if (g > by_memory) g = by_memory;
  if (g > static_cast<size_t>(row_tiles)) g = row_tiles;
  return g < 1 ? 1 : static_cast<int>(g);
}

// Layout: threadIdx.x walks TILE_K feature columns and threadIdx.y strides
// the TILE_N rows of a tile; X rows and Fcat columns are staged in shared
// memory CHUNK_D at a time, so any D works.  dT of a tile goes to shared
// memory, and each thread then owns CHUNK_D / THREADS_Y entries (d, column)
// of the tile's X^T dT, summed over the 64 rows in order and added to its
// workspace slot (read-add-write by the one thread that owns it).  dpcat
// and ds are summed per thread across the tiles and then across the block
// in a fixed order.  blockIdx.z is the trial: its operands and its G slots
// lie at fixed strides from the first trial's.
template <bool BATCHED>
__global__ void __launch_bounds__(THREADS)
phi_bwd_partial_kernel(const float* __restrict__ X,
                       const float* __restrict__ Fcat,
                       const float* __restrict__ pcat,
                       const float* __restrict__ scale,
                       const float* __restrict__ g, float* __restrict__ part,
                       size_t width, int n, int d, int k) {
  __shared__ float xs[TILE_N][CHUNK_D + 1];
  __shared__ float fs[CHUNK_D][TILE_K];
  __shared__ float dts[TILE_N][TILE_K];

  if (BATCHED) {
    const size_t z = blockIdx.z;
    X += z * n * d;
    Fcat += z * d * k;
    pcat += z * k;
    scale += z;
    g += z * n * 2 * k;
    part += z * gridDim.x * width;
  }
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE_K + tx;
  const int col0 = blockIdx.y * TILE_K;
  const int col = col0 + tx;
  const int row_tiles = (n + TILE_N - 1) / TILE_N;
  const size_t ld = 2 * static_cast<size_t>(k);
  float* slot = part + blockIdx.x * width;
  const float s = *scale;
  const float p = col < k ? pcat[col] : 0.0f;

  float dp_acc = 0.0f;
  float ds_acc = 0.0f;
  bool first = true;
  for (int tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_N;

    // T for this tile's rows and columns, as phi_fwd.cu computes it.
    float t[ROWS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) t[i] = 0.0f;
    for (int d0 = 0; d0 < d; d0 += CHUNK_D) {
      const int dc = min(CHUNK_D, d - d0);
      for (int idx = tid; idx < TILE_N * CHUNK_D; idx += THREADS) {
        const int r = idx / CHUNK_D;
        const int j = idx % CHUNK_D;
        const int gr = row0 + r;
        xs[r][j] = (gr < n && j < dc) ? X[(size_t)gr * d + d0 + j] : 0.0f;
      }
      for (int idx = tid; idx < CHUNK_D * TILE_K; idx += THREADS) {
        const int j = idx / TILE_K;
        const int c = idx % TILE_K;
        const int gc = col0 + c;
        fs[j][c] = (j < dc && gc < k) ? Fcat[(size_t)(d0 + j) * k + gc] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < dc; ++j) {
        const float f = fs[j][tx];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i)
          t[i] = fmaf(xs[ty + i * THREADS_Y][j], f, t[i]);
      }
      __syncthreads();
    }

    // dT into shared memory (zero on the ragged edge), ds and dpcat sums.
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int r = row0 + ty + i * THREADS_Y;
      float dt = 0.0f;
      if (r < n && col < k) {
        float sn, cs;
        sincosf(t[i] + p, &sn, &cs);
        const float g_cos = g[(size_t)r * ld + col];
        const float g_sin = g[(size_t)r * ld + k + col];
        dt = s * (g_sin * cs - g_cos * sn);
        ds_acc += g_cos * cs + g_sin * sn;
        dp_acc += dt;
      }
      dts[ty + i * THREADS_Y][tx] = dt;
    }

    // X^T dT for this tile, one D chunk at a time, into the block's slot.
    for (int d0 = 0; d0 < d; d0 += CHUNK_D) {
      const int dc = min(CHUNK_D, d - d0);
      for (int idx = tid; idx < TILE_N * CHUNK_D; idx += THREADS) {
        const int r = idx / CHUNK_D;
        const int j = idx % CHUNK_D;
        const int gr = row0 + r;
        xs[r][j] = (gr < n && j < dc) ? X[(size_t)gr * d + d0 + j] : 0.0f;
      }
      __syncthreads();  // also orders the dts writes above before the reads
#pragma unroll
      for (int jj = 0; jj < D_PER_THREAD; ++jj) {
        const int j = ty + jj * THREADS_Y;  // one j per warp: xs broadcasts
        if (j < dc && col < k) {
          float acc = 0.0f;
          for (int r = 0; r < TILE_N; ++r)
            acc = fmaf(xs[r][j], dts[r][tx], acc);
          float* out = slot + (size_t)(d0 + j) * k + col;
          *out = first ? acc : *out + acc;
        }
      }
      __syncthreads();
    }
    first = false;
  }

  // Block sums in a fixed order: dpcat over the THREADS_Y threads of a
  // column, ds over all threads by a fixed tree.  (The barrier matters only
  // for D = 0, where no chunk loop ordered the dts writes.)
  __syncthreads();
  float* red = &dts[0][0];
  red[tid] = dp_acc;
  red[THREADS + tid] = ds_acc;
  __syncthreads();
  if (ty == 0 && col < k) {
    float v = red[tx];
    for (int y = 1; y < THREADS_Y; ++y) v += red[y * TILE_K + tx];
    slot[(size_t)d * k + col] = v;
  }
  float* red_s = red + THREADS;
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red_s[tid] += red_s[tid + stride];
    __syncthreads();
  }
  if (tid == 0) slot[(size_t)d * k + k + blockIdx.y] = red_s[0];
}

// out[j] = sum over row groups of part[group][j] for the dFcat and dpcat
// entries; the last output adds every group's per-column-tile ds as well.
// blockIdx.y is the trial.
template <bool BATCHED>
__global__ void __launch_bounds__(REDUCE_THREADS)
phi_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int groups, size_t width, size_t n_dk_k, int ktiles) {
  const size_t j = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (BATCHED) {
    const size_t z = blockIdx.y;
    part += z * groups * width;
    out += z * (n_dk_k + 1);
  }
  if (j < n_dk_k) {
    float v = 0.0f;
    for (int grp = 0; grp < groups; ++grp) v += part[grp * width + j];
    out[j] = v;
  } else if (j == n_dk_k) {
    float v = 0.0f;
    for (int grp = 0; grp < groups; ++grp)
      for (int y = 0; y < ktiles; ++y) v += part[grp * width + n_dk_k + y];
    out[j] = v;
  }
}

size_t workspace(int n, int d, int k) {
  return static_cast<size_t>(row_groups(n, d, k)) * slot_width(d, k);
}

int launch(const float* X, const float* Fcat, const float* pcat,
           const float* scale, const float* g, float* part, float* out,
           int trials, int n, int d, int k, cudaStream_t st) {
  const int groups = row_groups(n, d, k);
  const size_t width = slot_width(d, k);
  const dim3 block(TILE_K, THREADS_Y);
  const dim3 grid(groups, col_tiles(k), trials);
  (trials > 1 ? phi_bwd_partial_kernel<true> : phi_bwd_partial_kernel<false>)
      <<<grid, block, 0, st>>>(X, Fcat, pcat, scale, g, part, width, n, d, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_dk_k = static_cast<size_t>(d) * k + k;
  const dim3 reduce_blocks(static_cast<unsigned>(
                               (n_dk_k + 1 + REDUCE_THREADS - 1) /
                               REDUCE_THREADS),
                           trials);
  (trials > 1 ? phi_bwd_reduce_kernel<true> : phi_bwd_reduce_kernel<false>)
      <<<reduce_blocks, REDUCE_THREADS, 0, st>>>(
      part, out, groups, width, n_dk_k, col_tiles(k));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace narrow

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace the launch
// needs for `trials` problems of these shapes.
extern "C" size_t scfgp_phi_bwd_workspace(int trials, int n, int d, int k) {
  const size_t one = d < WIDE_D ? narrow::workspace(n, d, k)
                                : wide_workspace(plan(n, d, k), d, k);
  return static_cast<size_t>(trials) * one;
}

// Every pointer is a device pointer to contiguous float32 data holding
// `trials` problems one after another: X (trials, n, d), Fcat (trials, d,
// k), pcat (trials, k), scale (trials,), g (trials, n, 2k); `part` holds
// scfgp_phi_bwd_workspace(trials, n, d, k) floats, and `out` trials x
// (d*k + k + 1) floats that receive [dFcat (d, k) | dpcat (k) | ds] of each
// trial.  n >= 1, k >= 1, trials >= 1.  Launches every stage on `stream` (a
// cudaStream_t), does not synchronise, allocates nothing, and returns the
// first cudaGetLastError() code that is not 0 (0 on success).
extern "C" int scfgp_phi_bwd_f32(const float* X, const float* Fcat,
                                 const float* pcat, const float* scale,
                                 const float* g, float* part, float* out,
                                 int trials, int n, int d, int k,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < WIDE_D)
    return narrow::launch(X, Fcat, pcat, scale, g, part, out, trials, n, d, k,
                          st);
  return wide(X, Fcat, pcat, scale, g, part, out, trials, n, d, k, st);
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
