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
// Narrow (D < WIDE_D): at D = 8 the tile's 128-row side would hold 8 rows
// of X^T dT, 1/16 of its work (it measured 0.0482 against 0.0380 ms at
// bench).  The narrow design keeps the order of every sum of the first
// narrow design, so its gradient has that design's bits (and every float32
// trajectory of training, sweeps and samplers stays as it was): 64-row
// tiles, taken by row group g (G from the shapes alone) as g, g + G, ...;
// per column, the rows of class r % 4 summed in order into one dpcat and
// one ds; per (d, column) X^T dT one FMA chain over a tile's 64 rows, the
// group's tiles added in order, the G slots added in order from 0; ds
// through a fixed tree over 64-column tiles.  phi_bwd_partial_kernel,
// compiled for D rounded up to a bucket of 8, 16, 32 or 64: block (row
// groups, 64-column tile, trial), thread (group, column j, class q) with
// the four classes of a column in neighbouring lanes, Fcat[:, j] in
// registers.  A tile's g for its 16 rows is loaded while the tile's X rows
// stage in shared memory; T and dT of the 16 rows stay in registers, and
// each thread sums X^T dT for D / 4 entries d of its column over the 64
// rows, the other classes' dT by warp shuffles; dpcat and ds combine by
// shuffles and a tree in shared memory, and the block writes its groups'
// slots.  Columns are threads only where the tile has them (a 21-column
// last tile packs 3 groups a block), so no warp of 64 lanes sits idle at
// K = 50, 70 or 277.  phi_bwd_reduce_kernel adds each entry's G slots with
// 16 loads in flight a thread, and ds's slots staged in shared memory:
// 3.2 µs at kin8nm against 17.7 for the first design's serial loads.  What
// bounds it at D = 8 is latency and instruction throughput, not bytes:
// the partial kernel takes 14.5 µs at kin8nm for a 4.4 µs bound, with 53
// groups (the first design's G) of 1,108 threads each, and 2.4 µs pass
// between the two launches.
//
// Registers and shared memory (ptxas, sm_90a; 2-D / batched instances):
// phi_t_kernel 121 / 125 and 16,896 bytes, dfcat_kernel 128 and 16,896;
// phi_bwd_partial_kernel 64 / 64 at D <= 8 (8 bytes of spills batched),
// 64 / 64 at 16 (108 / 116 bytes of spills: four blocks an SM measured
// faster than two without them), 156 / 164 at 32, 216 / 224 at 64, and
// 18,432 bytes; phi_bwd_reduce_kernel 48 / 47 and 4,096.  Device time on
// an NVIDIA H100 80GB HBM3 at 700.00 W (experiments/kernel_ab.py, PERF.md
// §6), against the first narrow design in the same run: 0.0200 ms at
// kin8nm (0.0465), 0.0202 at bench (0.0380), 0.0307 for 50 boston trials
// (0.0414), 0.0780 for 32 Bayes chains (0.1708), 0.2122 for 96 tempering
// trials (0.4447); wide, unchanged, 0.159 ms at the streaming block
// (phi_t_kernel 79 us, dfcat_kernel 66, the reduce 9) and 0.118 at
// (4096, 256, 500).
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
// call has more than one trial (BATCHED: moved pointers live in
// registers), so the 2-D call keeps its code and its time.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dfcat.cuh"
#include "features.cuh"
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

using features::narrow::load_column;
using features::narrow::load_staged;
using features::narrow::project;

// The tiling of the first narrow design, which fixes the order of every
// sum over rows (so the gradient keeps its bits): 64-row tiles, taken by
// row group g as tiles g, g + G, ...; within a tile the rows of class
// r % 4 make one running sum of dpcat and of ds for each column, and each
// (d, column) of X^T dT one FMA chain over the tile's 64 rows; ds goes
// through a tree over 64-column tiles.
constexpr int TILE_N = 64;
constexpr int TILE_K = 64;
constexpr int CLASSES = 4;
constexpr int ROWS = TILE_N / CLASSES;  // rows of a tile a thread maps
constexpr int REDUCE_THREADS = 256;
constexpr int REDUCE_BATCH = 16;  // slots a reduce thread loads at once
constexpr int DS_STAGE = 1024;    // ds slots staged at once
// Row groups: enough for two waves of the first design's blocks on the
// H100's 132 SMs, within the workspace budget.
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

// Threads of a block (at most), blocks an SM holds at least for D <= 16
// (64 registers a thread; wider buckets would spill), floats of the X
// tiles a block stages, and rows of g a thread loads at once.
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;
constexpr int XS_FLOATS = 4096;
constexpr int G_BATCH = 8;

// Items (row group, column tile of ks valid columns) a block holds: 4
// threads a column, at most one item a warp, and each item's X tile (64
// rows x DB) within XS_FLOATS.
__host__ __device__ inline int items(int ks, int db) {
  int n = THREADS / (CLASSES * ks);
  if (n > THREADS / 32) n = THREADS / 32;
  if (n > XS_FLOATS / (TILE_N * db)) n = XS_FLOATS / (TILE_N * db);
  return n;
}

// Block (row groups g0 .. g0 + items - 1, column tile y, trial): thread
// (item, column j, class q), the four classes of a column in neighbouring
// lanes, keeps Fcat[:, j] in registers.  For each tile of its group the
// item's threads load g for their rows and stage the tile's X rows in
// shared memory; then each thread recomputes T and dT for the 16 rows of
// class q, keeping dT in registers, and sums X^T dT for entries d in
// [q DQ, (q + 1) DQ) of column j over the tile's 64 rows in order, the
// other classes' dT by warp shuffles.  dpcat and ds of a column combine
// across its four lanes by shuffles, ds across the tile's columns by a tree
// in shared memory, as the first design's block sums did.  blockIdx.z is
// the trial.
template <int DB, bool BATCHED>
__global__ void __launch_bounds__(THREADS, DB <= 16 ? MIN_BLOCKS : 1)
phi_bwd_partial_kernel(const float* __restrict__ X,
                       const float* __restrict__ Fcat,
                       const float* __restrict__ pcat,
                       const float* __restrict__ scale,
                       const float* __restrict__ g, float* __restrict__ part,
                       size_t width, int n, int d, int k, int groups,
                       bool vec) {
  constexpr int DQ = DB / CLASSES;
  constexpr unsigned ALL = 0xffffffffu;
  __shared__ __align__(16) float xs_all[XS_FLOATS];
  __shared__ float ds_cols[THREADS / 32][TILE_K];

  if (BATCHED) {
    const size_t z = blockIdx.z;
    X += z * n * d;
    Fcat += z * d * k;
    pcat += z * k;
    scale += z;
    g += z * n * 2 * k;
    part += z * groups * width;
  }
  const int y = blockIdx.y;
  const int ks = min(TILE_K, k - y * TILE_K);
  const int per_block = items(ks, DB);
  const int g0 = blockIdx.x * per_block;
  if (g0 >= groups) return;  // the whole block
  const int tid = threadIdx.x;
  const int item = tid / (CLASSES * ks);
  const int u = tid - item * CLASSES * ks;
  const int q = u % CLASSES;
  const int col = y * TILE_K + u / CLASSES;
  const int grp = g0 + item;
  const bool active = item < per_block && grp < groups;  // col < k then
  const int row_tiles = (n + TILE_N - 1) / TILE_N;
  const size_t ld = 2 * static_cast<size_t>(k);
  const int dq0 = q * DQ;
  float* xs = xs_all + (active ? item : 0) * TILE_N * DB;

  float f[DB];
  load_column<DB>(Fcat, active ? d : 0, k, col, f);
  const float p = active ? pcat[col] : 0.0f;
  const float s = *scale;

  float slot[DQ];
#pragma unroll
  for (int m = 0; m < DQ; ++m) slot[m] = 0.0f;
  float dp_acc = 0.0f;
  float ds_acc = 0.0f;
  // Every warp walks as many tiles as the block's first group has (the
  // most); a group with one fewer idles in its last step.
  const int steps = (row_tiles - g0 + groups - 1) / groups;
  for (int step = 0; step < steps; ++step) {
    const int tile = grp + step * groups;
    const bool has = active && tile < row_tiles;
    const int row0 = tile * TILE_N;

    // g of this thread's rows, row0 + 4 i + q, in flight while X stages.
    float gc[ROWS], gs[ROWS];
    auto load_g = [&](int i) {
      const int r = row0 + CLASSES * i + q;
      const bool in = has && r < n;
      gc[i] = in ? g[static_cast<size_t>(r) * ld + col] : 0.0f;
      gs[i] = in ? g[static_cast<size_t>(r) * ld + k + col] : 0.0f;
    };
#pragma unroll
    for (int i = 0; i < G_BATCH; ++i) load_g(i);
    if (step > 0) __syncthreads();  // the last tile's X is read
    if (has) {
      const int rows = min(TILE_N, n - row0);
      const float* src = X + static_cast<size_t>(row0) * d;
      if (vec) {
        for (int e = 4 * u; e < TILE_N * d; e += 4 * CLASSES * ks) {
          const int r = e / d;
          *reinterpret_cast<float4*>(xs + r * DB + (e - r * d)) =
              r < rows ? __ldg(reinterpret_cast<const float4*>(src + e))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (int e = u; e < TILE_N * d; e += CLASSES * ks) {
          const int r = e / d;
          xs[r * DB + (e - r * d)] = r < rows ? __ldg(src + e) : 0.0f;
        }
      }
    }
    __syncthreads();

    // dT for rows row0 + 4 i + q, as K1f computes T.
    float dtr[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i % G_BATCH == 0 && i > 0) {
#pragma unroll
        for (int j = i; j < i + G_BATCH; ++j) load_g(j);
      }
      const int r = CLASSES * i + q;
      float dt = 0.0f;
      if (has && row0 + r < n) {
        float x[DB];
        load_staged<DB>(xs + r * DB, d, x);
        float sn, cs;
        sincosf(project<DB>(x, f, d) + p, &sn, &cs);
        const float g_cos = gc[i];
        const float g_sin = gs[i];
        dt = s * (g_sin * cs - g_cos * sn);
        ds_acc += g_cos * cs + g_sin * sn;
        dp_acc += dt;
      }
      dtr[i] = dt;
    }

    // X^T dT of the tile: one FMA chain a (d, column) over rows 0..63, rows
    // past n adding 0 * 0 as the first design did.
    float acc[DQ];
#pragma unroll
    for (int m = 0; m < DQ; ++m) acc[m] = 0.0f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int c = 0; c < CLASSES; ++c) {
        const float dt = __shfl_sync(ALL, dtr[i], c, CLASSES);
        const float* xr = xs + (CLASSES * i + c) * DB + dq0;
#pragma unroll
        for (int m = 0; m < DQ; ++m)
          if (dq0 + m < d) acc[m] = fmaf(xr[m], dt, acc[m]);
      }
    }
    if (has) {
#pragma unroll
      for (int m = 0; m < DQ; ++m)
        slot[m] = step == 0 ? acc[m] : slot[m] + acc[m];
    }
  }

  float* out = part + static_cast<size_t>(grp) * width;
  if (active) {
#pragma unroll
    for (int m = 0; m < DQ; ++m)
      if (dq0 + m < d) out[static_cast<size_t>(dq0 + m) * k + col] = slot[m];
  }
  // dpcat over the four classes in order; ds by the first two levels of the
  // first design's tree over (class, column): (c0 + c2) + (c1 + c3).
  const float dp1 = __shfl_sync(ALL, dp_acc, 1, CLASSES);
  const float dp2 = __shfl_sync(ALL, dp_acc, 2, CLASSES);
  const float dp3 = __shfl_sync(ALL, dp_acc, 3, CLASSES);
  const float ds1 = __shfl_sync(ALL, ds_acc, 1, CLASSES);
  const float ds2 = __shfl_sync(ALL, ds_acc, 2, CLASSES);
  const float ds3 = __shfl_sync(ALL, ds_acc, 3, CLASSES);
  for (int e = tid; e < per_block * TILE_K; e += blockDim.x)
    ds_cols[e / TILE_K][e % TILE_K] = 0.0f;
  __syncthreads();
  if (active && q == 0) {
    out[static_cast<size_t>(d) * k + col] = ((dp_acc + dp1) + dp2) + dp3;
    ds_cols[item][col - y * TILE_K] = (ds_acc + ds2) + (ds1 + ds3);
  }
  __syncthreads();
  // Then the tree over the tile's 64 columns (zeros past k), a warp an item.
  const int lane = tid % 32;
  for (int w = tid / 32; w < per_block; w += blockDim.x / 32) {
    float v = ds_cols[w][lane] + ds_cols[w][lane + 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(ALL, v, off);
    if (lane == 0 && g0 + w < groups)
      part[static_cast<size_t>(g0 + w) * width + static_cast<size_t>(d) * k +
           k + y] = v;
  }
}

// out[j] = sum over row groups g = 0..G-1, in order from 0, of slot g's
// entry j for the dFcat and dpcat entries, a thread an entry with
// REDUCE_BATCH loads in flight; the last block adds every group's ds per
// column tile, in order, staged in shared memory and added by one thread.
// blockIdx.y is the trial.
template <bool BATCHED>
__global__ void __launch_bounds__(REDUCE_THREADS)
phi_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int groups, size_t width, size_t n_dk_k, int ktiles) {
  __shared__ float staged[DS_STAGE];
  if (BATCHED) {
    const size_t z = blockIdx.y;
    part += z * groups * width;
    out += z * (n_dk_k + 1);
  }
  if (blockIdx.x + 1 < gridDim.x) {
    const size_t j = static_cast<size_t>(blockIdx.x) * REDUCE_THREADS +
                     threadIdx.x;
    if (j >= n_dk_k) return;
    float v = 0.0f;
    for (int g0 = 0; g0 < groups; g0 += REDUCE_BATCH) {
      float b[REDUCE_BATCH];
#pragma unroll
      for (int m = 0; m < REDUCE_BATCH; ++m)
        b[m] = g0 + m < groups ? part[(g0 + m) * width + j] : 0.0f;
#pragma unroll
      for (int m = 0; m < REDUCE_BATCH; ++m)
        if (g0 + m < groups) v += b[m];
    }
    out[j] = v;
    return;
  }
  const int total = groups * ktiles;
  float v = 0.0f;
  for (int base = 0; base < total; base += DS_STAGE) {
    const int count = min(DS_STAGE, total - base);
    for (int e = threadIdx.x; e < count; e += REDUCE_THREADS) {
      const int slot = (base + e) / ktiles;
      staged[e] = part[slot * width + n_dk_k + (base + e - slot * ktiles)];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int e = 0; e < count; ++e) v += staged[e];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[n_dk_k] = v;
}

size_t workspace(int n, int d, int k) {
  return static_cast<size_t>(row_groups(n, d, k)) * slot_width(d, k);
}

template <int DB>
int launch(const float* X, const float* Fcat, const float* pcat,
           const float* scale, const float* g, float* part, float* out,
           int trials, int n, int d, int k, cudaStream_t st) {
  const int groups = row_groups(n, d, k);
  const int ktiles = col_tiles(k);
  const size_t width = slot_width(d, k);
  // The widest column tile and the last one fix the block and the grid.
  int threads = 32, blocks = 1;
  for (const int ks : {k < TILE_K ? k : TILE_K, k - (ktiles - 1) * TILE_K}) {
    const int per_block = items(ks, DB);
    const int used = (per_block * CLASSES * ks + 31) / 32 * 32;
    threads = used > threads ? used : threads;
    const int need = (groups + per_block - 1) / per_block;
    blocks = need > blocks ? need : blocks;
  }
  const bool vec =
      d % 4 == 0 && reinterpret_cast<std::uintptr_t>(X) % 16 == 0;
  const dim3 grid(blocks, ktiles, trials);
  (trials > 1 ? phi_bwd_partial_kernel<DB, true>
              : phi_bwd_partial_kernel<DB, false>)<<<grid, threads, 0, st>>>(
      X, Fcat, pcat, scale, g, part, width, n, d, k, groups, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_dk_k = static_cast<size_t>(d) * k + k;
  const dim3 reduce_blocks(
      static_cast<unsigned>((n_dk_k + REDUCE_THREADS - 1) / REDUCE_THREADS +
                            1),
      trials);
  (trials > 1 ? phi_bwd_reduce_kernel<true> : phi_bwd_reduce_kernel<false>)
      <<<reduce_blocks, REDUCE_THREADS, 0, st>>>(part, out, groups, width,
                                                 n_dk_k, ktiles);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* X, const float* Fcat, const float* pcat,
           const float* scale, const float* g, float* part, float* out,
           int trials, int n, int d, int k, cudaStream_t st) {
  switch (features::narrow::bucket(d)) {
    case 8:
      return launch<8>(X, Fcat, pcat, scale, g, part, out, trials, n, d, k,
                       st);
    case 16:
      return launch<16>(X, Fcat, pcat, scale, g, part, out, trials, n, d, k,
                        st);
    case 32:
      return launch<32>(X, Fcat, pcat, scale, g, part, out, trials, n, d, k,
                        st);
    default:
      return launch<64>(X, Fcat, pcat, scale, g, part, out, trials, n, d, k,
                        st);
  }
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
