// Shared definitions for the hand-written Hopper kernels of cusmc_tpu_torch.
//
// Every entry point has a plain C interface (bound from Python with ctypes,
// see ops/kernels.py): device pointers and the CUDA stream arrive as
// integers, the entry launches on that stream without synchronising, and
// returns cudaGetLastError() so that a refused launch is reported where it
// happened. Outputs and scratch are allocated by the Python wrapper.
#pragma once

#include <cuda_runtime.h>

#define CUSMC_EXPORT extern "C" __attribute__((visibility("default")))

namespace cusmc {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = v + y;
  }
  return v;
}

__device__ __forceinline__ float warp_inclusive_max(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = fmaxf(v, y);
  }
  return v;
}

// Inverse-CDF search: #{j < n : cdf[j] <= p}, clipped to n - 1
// (searchsorted, side right). `<=` never picks a zero-weight particle
// (equal consecutive cdf values). One binary search of the cdf in global
// memory: at N = 2^20 its 4 MB stay in L2, and neighbouring threads with
// sorted queries walk the same upper levels.
__device__ __forceinline__ long long upper_bound_clipped(
    const float* __restrict__ cdf, long long n, float p) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (cdf[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n - 1 ? lo : n - 1;
}

}  // namespace cusmc
