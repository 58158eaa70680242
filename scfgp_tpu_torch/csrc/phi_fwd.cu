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
// block); for D < 64 a 64 x 64 block with the projection in shared memory
// (feature_kernel).  Both give the same bits.
//
// Registers and shared memory (ptxas, sm_90a), no spills:
// feature_tile_kernel 119 and 16,896 bytes, feature_kernel 48 and 16,640
// (each with the 32-byte stack frame of sincosf's slow path); their
// batched instances 126 and 60.  Device time on an NVIDIA H100 80GB HBM3
// at 700.00 W (experiments/kernel_ab.py, PERF.md §6): 0.068 ms at the
// streaming block (~32 TFLOP/s; the previous one-design kernel, now the
// narrow one, 0.178), 0.040 ms at (4096, 256, 500) (0.094), 0.0124 ms at
// kin8nm and bench, where the wide design took 0.029-0.031.  Batched
// (chip_smoke.py phase 11a): 50 boston trials (455, 13, 70) 0.019 ms in
// one launch against 0.35 for 50 launches; at kin8nm and D = 256, where a
// trial fills the card, about B times one trial's time.
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
