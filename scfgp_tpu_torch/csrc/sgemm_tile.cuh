// A register-blocked 128 x 128 float32 product tile for Hopper's FP32
// pipes, shared by the backward kernels K1b (phi_bwd.cu) and K2b
// (gram_bwd.cu):
//
//   acc[a][b] = sum over kk < depth of A(kk, m0 + row(a)) * B(kk, n0 + col(b))
//
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) holds 8 x 8
// accumulators in registers, rows ty*4 + {0..3} and 64 + ty*4 + {0..3} of
// the tile, columns tx*4 + {0..3} and 64 + tx*4 + {0..3} (row_of, col_of),
// and hands them to the caller's epilogue.
//
// The depth is staged BK = 8 deep in a ring of two shared-memory stages,
// both operands k-major (a[kk][m], b[kk][n]), so that per kk a thread reads
// its 8 A and 8 B values as 4 float4s (LDS.128) for 64 FMAs.  While one
// stage computes, the next one loads: an operand that lies k-major in
// device memory (element (kk, m) at p[kk*ld + m]) by cp.async straight
// into its stage, 16 bytes a copy when p is 16-byte aligned and ld % 4 == 0
// (4 bytes a copy otherwise); an operand that lies m-major (p[m*ld + kk],
// X in T = X Fcat) through registers, loaded a stage ahead and stored
// transposed after this stage's FMAs.  One barrier a stage.  Ragged M, N
// and depth are masked (cp.async's zero fill, or a 0 in the register), with
// no padding in device memory.
//
// The depth is summed in a fixed order, kk = 0, 1, ..., with one fmaf at a
// time per output: no TF32 (off by the port's precision policy) and no
// atomics, so a result depends on the shapes and values alone and is
// bitwise repeatable, which the fused training loop's bitwise resume needs.
//
// The tile takes 16,896 bytes of static shared memory and is built for two
// blocks an SM (__launch_bounds__(THREADS, 2): at most 128 registers); its
// kernels use 117-128 registers and spill nothing (ptxas, sm_90a).  What
// bounds it: 64 FMAs a thread per 4 shared loads, so the FP32 pipes (67
// TFLOP/s on an H100 SXM at 700 W), not shared memory.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: ~38 TFLOP/s in K2b's phi Abar, 26-33 in
// K1b's T and X^T dT at the streaming block (PERF.md, PR 7).  A warp laid
// over 4 x 8 threads instead of 2 x 16 (half the shared-memory wavefronts)
// measured no faster.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace sgemm {

constexpr int BM = 128;   // tile rows and columns
constexpr int BK = 8;     // depth of a stage
constexpr int THREADS = 256;
constexpr int MICRO = 8;  // a thread's rows and columns
// Row pitch of a stage: 16-byte aligned rows for the float4 reads, and
// the transposed stores of an m-major operand fall in 32 different banks.
constexpr int LD = BM + 4;

struct Smem {
  float a[2][BK][LD];
  float b[2][BK][LD];
};

// One operand.  k-major: element (kk, m) at p[kk * ld + m]; m-major:
// p[m * ld + kk].  m < extent is valid; vec: 16-byte accesses allowed.
struct Operand {
  const float* p;
  int ld;
  int extent;
  bool vec;
};

inline Operand operand(const float* p, int ld, int extent) {
  const bool vec = reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
                   ld % 4 == 0;
  return Operand{p, ld, extent, vec};
}

// A k-major operand offset by `kk` along its depth; 16-byte alignment is
// kept, since vec implies ld % 4 == 0.
__device__ inline Operand at_depth(Operand o, int kk) {
  o.p += static_cast<size_t>(kk) * o.ld;
  return o;
}

// Thread tid's tile coordinates (ty, tx).
__device__ __forceinline__ int thread_x(int tid) { return tid & 15; }
__device__ __forceinline__ int thread_y(int tid) { return tid >> 4; }

__device__ __forceinline__ int row_of(int a, int ty) {
  return (a < 4 ? 0 : 60) + ty * 4 + a;
}
__device__ __forceinline__ int col_of(int b, int tx) {
  return (b < 4 ? 0 : 60) + tx * 4 + b;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts loading depth rows k0 .. k0 + BK - 1, tile columns m0 .. m0 + BM - 1
// of `o` into stage `dst`: k-major by cp.async, m-major into `reg`.
template <bool KMAJOR>
__device__ __forceinline__ void fetch(const Operand& o, int depth, int k0,
                                      int m0, float (*dst)[LD], float reg[4],
                                      int tid) {
  if (KMAJOR) {
    if (o.vec) {
      const int kk = tid >> 5;
      const int m = (tid & 31) << 2;
      const int gk = k0 + kk;
      const int gm = m0 + m;
      const int n = gk < depth ? min(max(o.extent - gm, 0), 4) : 0;
      const float* src = n > 0 ? o.p + static_cast<size_t>(gk) * o.ld + gm
                               : o.p;
      cp_async16(&dst[kk][m], src, 4 * n);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * THREADS;
        const int kk = idx >> 7;
        const int m = idx & (BM - 1);
        const int gk = k0 + kk;
        const int gm = m0 + m;
        const bool ok = gk < depth && gm < o.extent;
        cp_async4(&dst[kk][m],
                  ok ? o.p + static_cast<size_t>(gk) * o.ld + gm : o.p,
                  ok ? 4 : 0);
      }
    }
  } else {
    const int gm = m0 + (tid >> 1);
    const int gk = k0 + ((tid & 1) << 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) reg[i] = 0.0f;
    if (gm < o.extent) {
      const float* row = o.p + static_cast<size_t>(gm) * o.ld;
      if (o.vec && gk + 3 < depth) {
        const float4 v = *reinterpret_cast<const float4*>(row + gk);
        reg[0] = v.x;
        reg[1] = v.y;
        reg[2] = v.z;
        reg[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gk + i < depth) reg[i] = row[gk + i];
      }
    }
  }
}

// Stores what fetch put in registers (m-major operands) into the stage.
template <bool KMAJOR>
__device__ __forceinline__ void put(float (*dst)[LD], const float reg[4],
                                    int tid) {
  if (!KMAJOR) {
    const int m = tid >> 1;
    const int kq = (tid & 1) << 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[kq + i][m] = reg[i];
  }
}

// acc = the tile (m0, n0) of A^T B over `depth`, A (depth x M) and
// B (depth x N) as above.  Every thread of the block must call it; it ends
// with a barrier, so the caller may reuse `sm` at once.
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void product(const Operand& A, const Operand& B,
                                        int depth, int m0, int n0, Smem& sm,
                                        float acc[MICRO][MICRO]) {
  const int tid = threadIdx.x;
  const int tx = thread_x(tid);
  const int ty = thread_y(tid);
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) acc[a][b] = 0.0f;

  const int nk = (depth + BK - 1) / BK;
  float ra[4], rb[4];
  if (nk > 0) {
    fetch<A_KMAJOR>(A, depth, 0, m0, sm.a[0], ra, tid);
    fetch<B_KMAJOR>(B, depth, 0, n0, sm.b[0], rb, tid);
    cp_async_commit();
    put<A_KMAJOR>(sm.a[0], ra, tid);
    put<B_KMAJOR>(sm.b[0], rb, tid);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // stage cur is full; stage cur ^ 1 is free
    const bool more = kt + 1 < nk;
    if (more) {
      fetch<A_KMAJOR>(A, depth, (kt + 1) * BK, m0, sm.a[cur ^ 1], ra, tid);
      fetch<B_KMAJOR>(B, depth, (kt + 1) * BK, n0, sm.b[cur ^ 1], rb, tid);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.a[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.a[cur][kk][64 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sm.b[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.b[cur][kk][64 + tx * 4]);
      const float av[MICRO] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
      const float bv[MICRO] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < MICRO; ++a)
#pragma unroll
        for (int b = 0; b < MICRO; ++b)
          acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (more) {
      put<A_KMAJOR>(sm.a[cur ^ 1], ra, tid);
      put<B_KMAJOR>(sm.b[cur ^ 1], rb, tid);
    }
  }
  __syncthreads();
}

}  // namespace sgemm
