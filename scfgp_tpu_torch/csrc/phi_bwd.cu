// K1 backward: the gradient of the fused trig Fourier feature map on Hopper.
//
// Given the cotangent g (N, 2K) of Phi = s * [cos T | sin T], T = X Fcat +
// pcat, split as g_cos = g[:, :K] and g_sin = g[:, K:], it computes
//
//   dT    = s * (g_sin * cos T - g_cos * sin T)        (N, K), never stored
//   dFcat = X^T dT                                     (D, K)
//   dpcat = sum over rows of dT                        (K,)
//   ds    = sum of g_cos * cos T + g_sin * sin T       ()
//
// recomputing T from X, Fcat and pcat, as the forward never stores it.  X is
// data and gets no gradient.  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/phi.py::_bwd_kernel (entry _phi_bwd_call), which summed its
// row tiles into resident outputs across a sequential grid (pl.when(i == 0)
// initialised them).  CUDA blocks run in parallel and in no order, so the
// sums take two deterministic stages instead, and no float atomics: the
// gradient is bitwise the same from run to run, which the fused training
// loop's bitwise resume relies on.
//
//   stage 1 (phi_bwd_partial_kernel): block (group, column tile) walks the
//     row tiles group, group + G, group + 2G, ... in that order and sums its
//     share into its own slot of a workspace the wrapper allocates:
//     dFcat and dpcat for its columns and one ds per column tile.  G, the
//     number of row groups, depends on the shapes alone and is capped so the
//     workspace stays under PARTIAL_BUDGET (one slot per 64-row tile would
//     take ~33 MB at D=256, K=500).
//   stage 2 (phi_bwd_reduce_kernel): one thread per output adds the G slots
//     in the order g = 0 .. G-1.
//
// What bounds it on an H100: reading g, N * 2K * 4 bytes (14.5 MB at the
// kin8nm model, N=6553, 2K=554: ~4.3 us at 3.35 TB/s), plus one precise
// sincosf per (row, feature) and two N*K*D FMA passes (T, then X^T dT: 14.5 M
// FMAs each at kin8nm).  At training sizes a launch costs about as much as
// the work, so the design keeps dT in registers and shared memory, reads g
// once, coalesced along the feature axis, and reads s through a pointer so
// that no host synchronisation precedes the launch.  At D=256 the X^T dT
// contraction is a 0.5 G FMA product done here on the FP32 pipes from shared
// memory; cuBLAS's SGEMM in the plain version may beat it there.
//
// Layout: as in phi_fwd.cu, threadIdx.x walks TILE_K feature columns and
// threadIdx.y strides the TILE_N rows of a tile; X rows and Fcat columns are
// staged in shared memory CHUNK_D at a time, so any D works.  dT of a tile
// goes to shared memory, and each thread then owns CHUNK_D / THREADS_Y
// entries (d, column) of the tile's X^T dT, summed over the 64 rows in order
// and added to its workspace slot (read-add-write by the one thread that
// owns it).  dpcat and ds are summed per thread across the tiles and then
// across the block in a fixed order.
//
// Precision: sincosf is the precise libdevice routine, no fast math, fp32
// accumulation throughout (scfgp_tpu/models/objective.py:150-153).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

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
__global__ void __launch_bounds__(REDUCE_THREADS)
phi_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int groups, size_t width, size_t n_dk_k, int ktiles) {
  const size_t j = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
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

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace the launch
// needs for these shapes.
extern "C" size_t scfgp_phi_bwd_workspace(int n, int d, int k) {
  return static_cast<size_t>(row_groups(n, d, k)) * slot_width(d, k);
}

// Every pointer is a device pointer to contiguous float32 data: g is
// (n, 2k), `part` holds scfgp_phi_bwd_workspace(n, d, k) floats, and `out`
// d*k + k + 1 floats that receive [dFcat (d, k) | dpcat (k) | ds].  Launches
// both stages on `stream` (a cudaStream_t), does not synchronise, allocates
// nothing, and returns the cudaGetLastError() code (0 on success).
extern "C" int scfgp_phi_bwd_f32(const float* X, const float* Fcat,
                                 const float* pcat, const float* scale,
                                 const float* g, float* part, float* out,
                                 int n, int d, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = row_groups(n, d, k);
  const size_t width = slot_width(d, k);
  const dim3 block(TILE_K, THREADS_Y);
  const dim3 grid(groups, col_tiles(k));
  phi_bwd_partial_kernel<<<grid, block, 0, st>>>(X, Fcat, pcat, scale, g,
                                                  part, width, n, d, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_dk_k = static_cast<size_t>(d) * k + k;
  const unsigned reduce_blocks = static_cast<unsigned>(
      (n_dk_k + 1 + REDUCE_THREADS - 1) / REDUCE_THREADS);
  phi_bwd_reduce_kernel<<<reduce_blocks, REDUCE_THREADS, 0, st>>>(
      part, out, groups, width, n_dk_k, col_tiles(k));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
