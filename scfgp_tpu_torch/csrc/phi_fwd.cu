// K1 forward: the fused low-rank trig Fourier feature map on Hopper.
//
//   Phi[r, j]     = s * cos(T[r, j])      j < K
//   Phi[r, K + j] = s * sin(T[r, j])      T = X @ Fcat + pcat
//
// with X (N, D), Fcat (D, K), pcat (K,), s a device scalar, and Phi one
// contiguous (N, 2K) float32 array.  It replaces the Pallas TPU kernel
// scfgp_tpu/ops/phi.py::_fwd_kernel (entry fourier_features_pallas) and
// computes what that kernel computes, not its blocks: the 128-lane padding of
// D and K and the separate cos/sin outputs existed only for Mosaic's tiling
// and are gone; ragged N, D and K are masked here instead.
//
// What bounds it on an H100: the N * 2K * 4 bytes of stores (14.5 MB at the
// served kin8nm model, N=6553, 2K=554) plus one precise sincosf per (row,
// feature).  At 3.35 TB/s the stores take a few microseconds and the sincosf
// ALU work about as long, so at serving sizes a launch costs as much as the
// work: the kernel is launch-bound.  The design answers with ONE launch that
// does the whole map (the plain PyTorch version launches a GEMM, a bias add,
// cos, sin, a concatenation and a scale), never writes T to device memory,
// and reads s through a pointer so that no host synchronisation precedes it.
//
// The kernel itself, its layout and its precision are in features.cuh,
// which K2f and K2b share for their chunked features.

#include "features.cuh"

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer
// to contiguous float32 data; `stream` is a cudaStream_t.  Launches on that
// stream, does not synchronise, allocates nothing, and returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int scfgp_phi_fwd_f32(const float* X, const float* Fcat,
                                 const float* pcat, const float* scale,
                                 float* out, int n, int d, int k,
                                 void* stream) {
  return static_cast<int>(features::launch(
      X, Fcat, pcat, scale, out, n, d, k, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* scfgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
