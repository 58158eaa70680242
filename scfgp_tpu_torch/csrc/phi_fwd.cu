// K1 forward: the fused low-rank trig Fourier feature map on Hopper.
//
//   Phi[r, j]     = s * cos(T[r, j])      j < K
//   Phi[r, K + j] = s * sin(T[r, j])      T = X @ Fcat + pcat
//
// with X (N, D), Fcat (D, K), pcat (K,), s a device scalar, and Phi one
// contiguous (N, 2K) float32 array.  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/phi.py::_fwd_kernel (entry _phi_fwd_call, reached from
// fourier_features_pallas) and computes what that kernel computes, not its
// blocks: the 128-lane padding of D and K and the separate cos/sin outputs
// existed only for Mosaic's tiling and are gone; ragged N, D and K are
// masked here instead.
//
// What bounds it on an H100 (chip_smoke.py::k1f_work): at the streaming
// block (N = 16384, D = 256, K = 256) the 2.15 GFLOP of T, 0.032 ms at 67
// TFLOP/s; at the served kin8nm model (N = 6553, D = 8, 2K = 554) the 14.5
// MB of stores, 0.0044 ms at 3.35 TB/s, about as long as a launch.  One
// launch does the whole map (the plain PyTorch version launches a GEMM, a
// bias add, cos, sin, a concatenation and a scale), never writes T to
// device memory, and reads s through a pointer so that no host
// synchronisation precedes it.
//
// Two designs, chosen by D alone (features.cuh, which K2f shares): for
// D >= 64 T by the 128 x 128 register-blocked tile of sgemm_tile.cuh with a
// sincosf epilogue (feature_tile_kernel, 256 blocks at the streaming
// block); for D < 64 a thread a (row lane, column) with its Fcat column in
// registers over X rows staged in shared memory, D a compile-time bucket
// (feature_kernel).  Both give the same bits, and the narrow one the bits
// of the first narrow design it replaced.
//
// Registers and shared memory (ptxas, sm_90a; 2-D / batched instances):
// feature_tile_kernel 119 / 126 and 16,896 bytes, no spills;
// feature_kernel 40 / 40 at D <= 8, 58 / 62 at 16, 80 / 95 at 32 (12 bytes
// of spills in the 2-D instance), 106 / 110 at 64, and at most 16 KB of
// staged X rows (each instance with sincosf's 32-byte stack frame where
// ptxas keeps it).  Device time on an NVIDIA H100 80GB HBM3 at 700.00 W
// (experiments/kernel_ab.py, PERF.md §6): 0.068-0.070 ms at the streaming
// block (~32 TFLOP/s), 0.040 ms at (4096, 256, 500); narrow, 0.0107 ms at
// kin8nm and 0.0111 at bench (the first narrow design 0.0126 and 0.0125
// in the same run); batched, one launch for 50 boston trials (455, 13, 70)
// 0.0155 ms, for 32 Bayes chains (6553, 8, 50) 0.0431, for 96 tempering
// trials 0.1437 (the first design 0.0188, 0.0635, 0.1767).
//
// Trials: the batched entry below launches B problems of one shape at once
// (features.cuh: blockIdx.z is the trial).

#include "features.cuh"

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer
// to contiguous float32 data holding `trials` problems one after another:
// X (trials, n, d), Fcat (trials, d, k), pcat (trials, k), scale (trials,),
// out (trials, n, 2k).  One launch maps them all (blockIdx.z is the trial);
// each trial gets the bits a launch with trials = 1 on its own data gives.
// `stream` is a cudaStream_t.  Launches on that stream, does not
// synchronise, allocates nothing, and returns the cudaGetLastError() code
// of the launch (0 on success).
extern "C" int scfgp_phi_fwd_f32(const float* X, const float* Fcat,
                                 const float* pcat, const float* scale,
                                 float* out, int trials, int n, int d, int k,
                                 void* stream) {
  return static_cast<int>(features::launch(X, Fcat, pcat, scale, out, n, d, k,
                                           2 * k,
                                           static_cast<cudaStream_t>(stream),
                                           trials));
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
