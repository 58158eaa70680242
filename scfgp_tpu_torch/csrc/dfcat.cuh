// The reduction that both backward kernels end in, K1b (phi_bwd.cu) and
// K2b (gram_bwd.cu), on the tile of sgemm_tile.cuh:
//
//   dFcat = X^T dT  (D, K),   dpcat = sum over rows of dT  (K,),   ds
//
// over a chunk of rows whose dT (rows, K, row pitch kpad) the caller's
// epilogue wrote, with dpcat and ds already summed per block of that
// epilogue (block_sums).  dfcat_kernel splits the chunk's rows into G
// contiguous groups of whole BK-row stages; block (tile, group) adds its
// group's X^T dT tile to the group's slot.  bwd_reduce_kernel then adds the
// slots in a fixed order, one thread an output.  Each slot entry is read,
// added to and written by one thread, chunk after chunk, and there are no
// atomics, so the gradient is bitwise repeatable.
//
// Trials (K1b's batched sweeps): the last grid axis is the trial; trial z's
// X, dT, slots and outputs lie at fixed strides from the first trial's, so
// each trial sums in the order a launch on it alone does.  Both kernels
// compile the offsets in only for a launch of several trials (BATCHED);
// K2b launches one trial, and its code is unchanged.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "sgemm_tile.cuh"

namespace dfcat {
namespace {  // each library keeps its own copy

constexpr int REDUCE_THREADS = 256;
// dfcat_kernel's groups: enough blocks for two waves on the H100's 132
// SMs, within the slots' budget.
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr size_t SLOT_BUDGET = size_t(16) << 20;  // bytes of group slots

__host__ __device__ inline int tiles(int n) {
  return (n + sgemm::BM - 1) / sgemm::BM;
}
inline int round4(int n) { return (n + 3) / 4 * 4; }

// Row groups of dfcat_kernel for chunks of `rows` rows (shapes alone).
inline int groups(int rows, int d, int k) {
  const size_t t = static_cast<size_t>(tiles(d)) * tiles(k);
  size_t g = t > 0 ? (TARGET_BLOCKS + t - 1) / t : 1;
  const size_t width = static_cast<size_t>(d) * k;
  const size_t by_memory = width > 0 ? SLOT_BUDGET / (width * sizeof(float))
                                     : g;
  const size_t steps = (static_cast<size_t>(rows) + sgemm::BK - 1) /
                       sgemm::BK;
  if (g > by_memory) g = by_memory;
  if (g > steps) g = steps;
  return g < 1 ? 1 : static_cast<int>(g);
}

// Adds a block's column sums of dT and its ds to their slots.  Thread
// (ty, tx) passes v[q], the sum of dT over its rows in tile column col[q]
// (< width <= 128), and its share of ds.  The sums over ty and over the
// threads run in fixed orders.  `red` holds 16 * width + 256 floats of
// shared memory that no thread is still reading.  dp_slot[c] for
// c < valid, and *ds_slot, receive the sums (added to them unless first).
template <int NV>
__device__ void block_sums(const float (&v)[NV], const int (&col)[NV],
                           int width, float ds, float* red, float* dp_slot,
                           int valid, float* ds_slot, bool first) {
  const int tid = threadIdx.x;
  const int ty = sgemm::thread_y(tid);
#pragma unroll
  for (int q = 0; q < NV; ++q) red[ty * width + col[q]] = v[q];
  float* red_s = red + 16 * width;
  red_s[tid] = ds;
  __syncthreads();
  if (tid < valid) {
    float s = red[tid];
    for (int y = 1; y < 16; ++y) s += red[y * width + tid];
    dp_slot[tid] = first ? s : dp_slot[tid] + s;
  }
  for (int stride = sgemm::THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (tid < stride) red_s[tid] += red_s[tid + stride];
  }
  if (tid == 0) *ds_slot = first ? red_s[0] : *ds_slot + red_s[0];
}

// One chunk: block (tile, group, trial) adds its group's rows of X^T dT,
// the (tile / tiles(k), tile % tiles(k)) tile of dFcat, to slot `group` of
// the trial's `part` (groups x d x k).  X is the chunk's (rows, d), dT
// (rows, kpad); the trial's lie x_stride and dt_stride floats further.
template <bool BATCHED>
__global__ void __launch_bounds__(sgemm::THREADS, 2)
dfcat_kernel(sgemm::Operand X, sgemm::Operand dT, float* __restrict__ part,
             int rows, int d, int k, bool first, size_t x_stride,
             size_t dt_stride) {
  __shared__ __align__(16) sgemm::Smem sm;
  if (BATCHED) {
    const size_t z = blockIdx.z;
    X.p += z * x_stride;
    dT.p += z * dt_stride;
    part += z * gridDim.y * static_cast<size_t>(d) * k;
  }
  const int tid = threadIdx.x;
  const int tx = sgemm::thread_x(tid);
  const int ty = sgemm::thread_y(tid);
  const int kt = tiles(k);
  const int m0 = (blockIdx.x / kt) * sgemm::BM;
  const int n0 = (blockIdx.x % kt) * sgemm::BM;
  const int steps = (rows + sgemm::BK - 1) / sgemm::BK;
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.y) * steps /
                                  gridDim.y);
  const int s1 = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * steps / gridDim.y);
  const int r0 = s0 * sgemm::BK;
  const int depth = min(s1 * sgemm::BK, rows) - r0;

  float acc[sgemm::MICRO][sgemm::MICRO];
  sgemm::product<true, true>(sgemm::at_depth(X, r0), sgemm::at_depth(dT, r0),
                             depth, m0, n0, sm, acc);
  float* slot = part + static_cast<size_t>(blockIdx.y) * d * k;
#pragma unroll
  for (int a = 0; a < sgemm::MICRO; ++a) {
    const int i = m0 + sgemm::row_of(a, ty);
    if (i >= d) continue;
#pragma unroll
    for (int b = 0; b < sgemm::MICRO; ++b) {
      const int j = n0 + sgemm::col_of(b, tx);
      if (j >= k) continue;
      float* o = slot + static_cast<size_t>(i) * k + j;
      *o = first ? acc[a][b] : *o + acc[a][b];
    }
  }
}

// Launches dfcat_kernel for one chunk of each of `trials` problems; X and
// dT start at the first trial's chunk, the others x_stride and dt_stride
// floats apart.  Returns cudaGetLastError().
inline cudaError_t launch(const float* X, const float* dT, float* part,
                          int rows, int d, int k, int kpad, int g, bool first,
                          cudaStream_t st, int trials = 1, size_t x_stride = 0,
                          size_t dt_stride = 0) {
  if (d == 0) return cudaSuccess;
  const dim3 grid(tiles(d) * tiles(k), g, trials);
  (trials > 1 ? dfcat_kernel<true> : dfcat_kernel<false>)
      <<<grid, sgemm::THREADS, 0, st>>>(
      sgemm::operand(X, d, d), sgemm::operand(dT, kpad, k), part, rows, d, k,
      first, x_stride, dt_stride);
  return cudaGetLastError();
}

// out = [dFcat (d * k) | dpcat (k) | ds]: the groups' slots of `part`
// (groups x d * k) added in the order g = 0..groups-1, the row tiles' dpcat
// slots (dp_slots x k) in index order, and the ds slots in index order.
// blockIdx.y is the trial: its slots and outputs follow the first trial's.
template <bool BATCHED>
__global__ void __launch_bounds__(REDUCE_THREADS)
bwd_reduce_kernel(const float* __restrict__ part, int groups,
                  const float* __restrict__ dp_part, int dp_slots,
                  const float* __restrict__ ds_part, int ds_slots,
                  float* __restrict__ out, int d, int k) {
  const size_t j = static_cast<size_t>(blockIdx.x) * REDUCE_THREADS +
                   threadIdx.x;
  const size_t dk = static_cast<size_t>(d) * k;
  if (BATCHED) {
    const size_t z = blockIdx.y;
    part += z * groups * dk;
    dp_part += z * dp_slots * static_cast<size_t>(k);
    ds_part += z * ds_slots;
    out += z * (dk + k + 1);
  }
  float v = 0.0f;
  if (j < dk) {
    for (int g = 0; g < groups; ++g) v += part[g * dk + j];
  } else if (j < dk + k) {
    for (int t = 0; t < dp_slots; ++t) v += dp_part[t * static_cast<size_t>(k)
                                                    + (j - dk)];
  } else if (j == dk + k) {
    for (int t = 0; t < ds_slots; ++t) v += ds_part[t];
  } else {
    return;
  }
  out[j] = v;
}

inline cudaError_t reduce(const float* part, int groups, const float* dp_part,
                          int dp_slots, const float* ds_part, int ds_slots,
                          float* out, int d, int k, cudaStream_t st,
                          int trials = 1) {
  const size_t outputs = static_cast<size_t>(d) * k + k + 1;
  const dim3 blocks(static_cast<unsigned>(
                        (outputs + REDUCE_THREADS - 1) / REDUCE_THREADS),
                    trials);
  (trials > 1 ? bwd_reduce_kernel<true> : bwd_reduce_kernel<false>)
      <<<blocks, REDUCE_THREADS, 0, st>>>(
      part, groups, dp_part, dp_slots, ds_part, ds_slots, out, d, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dfcat
