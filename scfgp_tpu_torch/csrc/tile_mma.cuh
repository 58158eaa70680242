// A 64 x 64 output tile of a float32 matrix product on the FP32 pipes,
// used by K4 and K3 (cholesky.cu).
//
// A block of 16 x 16 threads owns the tile; thread (tx, ty) owns the 4 x 4
// outputs (ty*4 + a, tx*4 + b).  The reduction is staged KC deep in shared
// memory, both operands k-major: As[kk][i] and Bs[kk][j], so that
//
//   acc[a][b] += sum over kk of As[kk][ty*4 + a] * Bs[kk][tx*4 + b]
//
// reads one float4 of each operand per kk (the As read is a broadcast
// within a warp, the Bs read 16 neighbouring float4s) for 16 FMAs.  The sum
// over kk runs in order, one fp32 FMA at a time, so a tile's result depends
// on the staged values alone.  This is the simple first version: no
// tensor cores (TF32 is off by the port's precision policy), no TMA, no
// double buffering.

#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int TILE = 64;
constexpr int KC = 32;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int MICRO = 4;
// Row padding of the staged operands: rows stay 16-byte aligned for the
// float4 reads.
constexpr int LD = TILE + 4;

using Stage = float[KC][LD];

__device__ __forceinline__ void zero(float acc[MICRO][MICRO]) {
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) acc[a][b] = 0.0f;
}

__device__ __forceinline__ void mma(const Stage& As, const Stage& Bs,
                                    float acc[MICRO][MICRO], int tx, int ty) {
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * MICRO]);
    const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * MICRO]);
    const float av[MICRO] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[MICRO] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int a = 0; a < MICRO; ++a)
#pragma unroll
      for (int b = 0; b < MICRO; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// The number of (ti <= tj) tiles of a t x t grid of tiles, and the tile
// (ti, tj) of the upper triangle that index `idx` names, row by row.
__host__ __device__ inline int triangle(int t) { return t * (t + 1) / 2; }

__device__ inline void upper_tile(int idx, int t, int* ti, int* tj) {
  int i = 0;
  while (idx >= t - i) {
    idx -= t - i;
    ++i;
  }
  *ti = i;
  *tj = i + idx;
}

__host__ __device__ inline int upper_index(int ti, int tj, int t) {
  return ti * t - ti * (ti - 1) / 2 + (tj - ti);
}

}  // namespace tile
