// Shared by the kernel sources of nsol_tpu_torch/csrc: launch shape, the
// card's SM count, the deterministic block reduction and the NaN-keeping
// max(u, 0).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kReduceThreads = 1024;

// The card's SMs (the current device's cudaDevAttrMultiProcessorCount),
// read once a device. A failed query leaves its error to the launch's
// cudaGetLastError().
inline int device_sms() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] <= 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 1;
}

// A float load through the read-only (non-coherent) path (kNc), as the
// standalone kernels read their inputs, which nothing writes while they
// run; or a plain, coherent load, as admm_persistent.cu's one-launch solve
// reads a volume that other blocks wrote earlier in the same launch.
template <bool kNc>
__device__ __forceinline__ float load_f(const float* p) {
  return kNc ? __ldg(p) : *p;
}

// max(u, 0) as jnp.maximum(u, 0.0) takes it: a NaN stays NaN (fmaxf would
// return 0).
__device__ __forceinline__ float clip0(float u) { return u < 0.f ? 0.f : u; }

// Sum of one double per thread over the block; the result is valid in
// thread 0. The order is fixed by the launch shape. Every thread of the
// block must call it; put a __syncthreads() between two calls.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace
