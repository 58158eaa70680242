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
// Design, every product on the 128 x 128 register-blocked tile of
// sgemm_tile.cuh.  abar_kernel forms Abar once with its columns
// interleaved, column 2j the cos and 2j + 1 the sin column of feature j.
// The rows are taken in chunks (plan: as few as fit CHUNK_BUDGET bytes of
// phi^T and dT, of equal size; at the streaming block one chunk of 16384
// rows, 48 MB), and for each chunk
//
//   1. phi_kernel: T by the tile (X m-major through registers, Fcat
//      k-major); the epilogue's precise sincosf writes the chunk's unscaled
//      phi transposed, phi^T (2K, rows), k-major for the next product;
//   2. g_kernel: the tile of phi Abar over the interleaved columns, so that
//      one thread holds G_cos and G_sin of the same feature; its epilogue
//      forms G, then dT (stored for the chunk), and sums dpcat and ds of
//      the block into the block's slots (dfcat::block_sums);
//   3. dfcat::dfcat_kernel: X^T dT, split over row groups into slots, the
//      routine K1b (phi_bwd.cu) ends in too;
//
// and then 4. dfcat::bwd_reduce_kernel adds the slots in a fixed order.
// Each slot entry is read, added to and written by one thread, chunk after
// chunk.  At the streaming block the chunk gives 256 tiles of T, 512 of
// phi Abar and 4 tiles x 64 groups of X^T dT, each two waves or more on 132
// SMs; two chunks of 8192 rows took 14% longer (PERF.md, PR 7).
//
// What bounds it on an H100, per row: D * K FMAs for T and a sincosf per
// (row, feature); (2K)^2 FMAs for phi Abar; D * K FMAs for X^T dT.  At the
// streaming block of the N=1e6, D=256, S=56, M=200 configuration (K = 256):
// 65,536 + 262,144 + 65,536 = 393,216 FMAs a row, 12.9 GFLOP for a
// 16,384-row block, 0.192 ms at 67 TFLOP/s on the FP32 pipes (TF32 is off
// by the port's precision policy).  Registers and shared memory (ptxas,
// sm_90a), no spills: phi_kernel 123 and 16,896 bytes, g_kernel 117 and
// 16,896, dfcat_kernel 128 and 16,896.  Device time on an NVIDIA H100 80GB
// HBM3 at 700.00 W (experiments/kernel_ab.py, PERF.md PR 7): 0.389 ms at
// the streaming block (g_kernel 224 us, ~38 TFLOP/s; phi_kernel 75;
// dfcat_kernel 65; the reduce 15), against 1.082 for the previous 64 x 64
// tile and 0.651 for the plain version's cuBLAS products; 0.176 ms at
// kin8nm (0.310).
//
// Precision: precise sincosf, fp32 FMAs and accumulation.

#include <cuda_runtime.h>

#include <cstddef>

#include "dfcat.cuh"
#include "sgemm_tile.cuh"

namespace {

constexpr size_t CHUNK_BUDGET = size_t(48) << 20;  // bytes of phi^T and dT
constexpr int REDUCE_THREADS = 256;

struct Plan {
  int k2;
  int ld2;         // row pitch of the interleaved Abar, a multiple of 4
  int kpad;        // row pitch of dT
  int chunk_rows;  // a multiple of BM, also the row pitch of phi^T
  int rtiles;      // row tiles of a chunk: the dpcat slots
  int gtiles;      // column tiles of phi Abar
  int groups;      // row groups of dfcat_kernel
};

// Depends on the shapes alone, so the order of every sum does too.
Plan plan(int n, int d, int k) {
  Plan p;
  p.k2 = 2 * k;
  p.ld2 = dfcat::round4(p.k2);
  p.kpad = dfcat::round4(k);
  const size_t per_row = (static_cast<size_t>(p.k2) + p.kpad) * sizeof(float);
  size_t most = CHUNK_BUDGET / per_row / sgemm::BM * sgemm::BM;
  if (most < static_cast<size_t>(sgemm::BM)) most = sgemm::BM;
  const size_t chunks = (static_cast<size_t>(n) + most - 1) / most;
  const size_t rows = (static_cast<size_t>(n) + chunks - 1) / chunks;
  p.chunk_rows = dfcat::tiles(static_cast<int>(rows)) * sgemm::BM;
  p.rtiles = p.chunk_rows / sgemm::BM;
  p.gtiles = dfcat::tiles(p.k2);
  p.groups = dfcat::groups(p.chunk_rows, d, k);
  return p;
}

// Abar with interleaved columns: abar[c][2j + h] = Abar[c][h K + j].
__global__ void abar_kernel(const float* __restrict__ cbar,
                            float* __restrict__ abar, int k, int ld2) {
  const int k2 = 2 * k;
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= static_cast<size_t>(k2) * k2) return;
  const size_t c = idx / k2;
  const int col = static_cast<int>(idx % k2);
  const size_t src = (col & 1) * static_cast<size_t>(k) + (col >> 1);
  abar[c * ld2 + col] = cbar[c * k2 + src] + cbar[src * k2 + c];
}

// One chunk: phiT[j][r] = cos T[r][j], phiT[K + j][r] = sin T[r][j] for the
// chunk's rows r (row pitch ldp), X offset to the chunk.
__global__ void __launch_bounds__(sgemm::THREADS, 2)
phi_kernel(sgemm::Operand X, sgemm::Operand F,
           const float* __restrict__ pcat, float* __restrict__ phiT, int d,
           int k, int ldp) {
  __shared__ __align__(16) sgemm::Smem sm;
  const int tid = threadIdx.x;
  const int tx = sgemm::thread_x(tid);
  const int ty = sgemm::thread_y(tid);
  const int m0 = blockIdx.x * sgemm::BM;
  const int n0 = blockIdx.y * sgemm::BM;

  float acc[sgemm::MICRO][sgemm::MICRO];
  sgemm::product<false, true>(X, F, d, m0, n0, sm, acc);

  // Rows past the chunk's end hold T = pcat: finite, and never read.
#pragma unroll
  for (int b = 0; b < sgemm::MICRO; ++b) {
    const int j = n0 + sgemm::col_of(b, tx);
    if (j >= k) continue;
    const float p = pcat[j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c[4], sn[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sincosf(acc[4 * h + a][b] + p, &sn[a], &c[a]);
      const size_t r = m0 + 64 * h + ty * 4;
      *reinterpret_cast<float4*>(phiT + static_cast<size_t>(j) * ldp + r) =
          make_float4(c[0], c[1], c[2], c[3]);
      *reinterpret_cast<float4*>(phiT + static_cast<size_t>(k + j) * ldp +
                                 r) = make_float4(sn[0], sn[1], sn[2], sn[3]);
    }
  }
}

// One chunk: G and dT from phi^T (row pitch ldp) and the interleaved Abar;
// y and w offset to the chunk.  Writes dT (rows, kpad) and adds to the
// dpcat slots (rtiles x k) and the ds slots (rtiles x gtiles).
__global__ void __launch_bounds__(sgemm::THREADS, 2)
g_kernel(sgemm::Operand P, sgemm::Operand Ab, const float* __restrict__ phiT,
         const float* __restrict__ y, const float* __restrict__ w,
         const float* __restrict__ pbar, const float* __restrict__ scale,
         float* __restrict__ dT, float* __restrict__ dp_part,
         float* __restrict__ ds_part, int rows, int k, int ldp, int kpad,
         bool first) {
  __shared__ __align__(16) sgemm::Smem sm;
  const int tid = threadIdx.x;
  const int tx = sgemm::thread_x(tid);
  const int ty = sgemm::thread_y(tid);
  const int m0 = blockIdx.x * sgemm::BM;
  const int n0 = blockIdx.y * sgemm::BM;
  const int f0 = n0 / 2;  // the tile's first feature

  float acc[sgemm::MICRO][sgemm::MICRO];
  sgemm::product<true, true>(P, Ab, 2 * k, m0, n0, sm, acc);

  // Accumulator columns 2q and 2q + 1 are G_cos and G_sin of feature
  // f0 + jl[q].
  const float s = *scale;
  int jl[4];
  float pc[4], ps[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    jl[q] = (q < 2 ? 0 : 32) + tx * 2 + (q & 1);
    const int j = f0 + jl[q];
    pc[q] = j < k ? pbar[j] : 0.0f;
    ps[q] = j < k ? pbar[k + j] : 0.0f;
  }
  float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ds = 0.0f;
#pragma unroll
  for (int a = 0; a < sgemm::MICRO; ++a) {
    const int r = m0 + sgemm::row_of(a, ty);
    if (r >= rows) continue;
    const float wr = w != nullptr ? w[r] : 1.0f;
    const float yr = y[r];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = f0 + jl[q];
      if (j >= k) continue;
      const float g_cos = wr * (s * acc[a][2 * q] + yr * pc[q]);
      const float g_sin = wr * (s * acc[a][2 * q + 1] + yr * ps[q]);
      const float c = phiT[static_cast<size_t>(j) * ldp + r];
      const float sn = phiT[static_cast<size_t>(k + j) * ldp + r];
      const float dt = s * (g_sin * c - g_cos * sn);
      dT[static_cast<size_t>(r) * kpad + j] = dt;
      ds += g_cos * c + g_sin * sn;
      dp[q] += dt;
    }
  }
  dfcat::block_sums<4>(dp, jl, sgemm::BM / 2, ds,
                       reinterpret_cast<float*>(&sm),
                       dp_part + static_cast<size_t>(blockIdx.x) * k + f0,
                       min(sgemm::BM / 2, k - f0),
                       ds_part + blockIdx.x * gridDim.y + blockIdx.y, first);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Floats of workspace the call
// needs for these shapes: Abar, one chunk of phi^T and dT, the group slots,
// the dpcat and the ds slots.
extern "C" size_t scfgp_gram_bwd_workspace(int n, int d, int k) {
  const Plan p = plan(n, d, k);
  return static_cast<size_t>(p.k2) * p.ld2 +
         static_cast<size_t>(p.chunk_rows) * (p.k2 + p.kpad) +
         static_cast<size_t>(p.groups) * d * k +
         static_cast<size_t>(p.rtiles) * k +
         static_cast<size_t>(p.rtiles) * p.gtiles;
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
  float* phiT = abar + static_cast<size_t>(p.k2) * p.ld2;
  float* dT = phiT + static_cast<size_t>(p.k2) * p.chunk_rows;
  float* part = dT + static_cast<size_t>(p.chunk_rows) * p.kpad;
  float* dp_part = part + static_cast<size_t>(p.groups) * d * k;
  float* ds_part = dp_part + static_cast<size_t>(p.rtiles) * k;

  const size_t square = static_cast<size_t>(p.k2) * p.k2;
  abar_kernel<<<static_cast<unsigned>((square + REDUCE_THREADS - 1) /
                                      REDUCE_THREADS),
                REDUCE_THREADS, 0, st>>>(cbar, abar, k, p.ld2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const sgemm::Operand F = sgemm::operand(Fcat, k, k);
  const sgemm::Operand Ab = sgemm::operand(abar, p.ld2, p.k2);
  for (int row0 = 0; row0 < n; row0 += p.chunk_rows) {
    const int rows = min(p.chunk_rows, n - row0);
    const bool first = row0 == 0;
    const float* Xc = X + static_cast<size_t>(row0) * d;
    const int rt = dfcat::tiles(rows);
    phi_kernel<<<dim3(rt, dfcat::tiles(k)), sgemm::THREADS, 0, st>>>(
        sgemm::operand(Xc, d, rows), F, pcat, phiT, d, k, p.chunk_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    g_kernel<<<dim3(rt, p.gtiles), sgemm::THREADS, 0, st>>>(
        sgemm::operand(phiT, p.chunk_rows, rows), Ab, phiT, y + row0,
        w != nullptr ? w + row0 : nullptr, pbar, scale, dT, dp_part, ds_part,
        rows, k, p.chunk_rows, p.kpad, first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = dfcat::launch(Xc, dT, part, rows, d, k, p.kpad, p.groups, first, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(dfcat::reduce(part, p.groups, dp_part, p.rtiles,
                                        ds_part, p.rtiles * p.gtiles, out, d,
                                        k, st));
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
