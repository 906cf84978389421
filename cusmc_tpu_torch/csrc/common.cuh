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

// lo + #{j in [lo, hi) : cdf[j] <= p} for a monotone cdf: one thread's
// binary search, in global or shared memory.
template <typename I>
__device__ __forceinline__ I upper_bound(const float* __restrict__ cdf, I lo,
                                         I hi, float p) {
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (cdf[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same count for K queries over one range at once: a branch-free
// binary search whose steps depend only on hi - lo, so the K searches' loads
// are independent and in flight together (a thread's queries do not wait on
// each other's ~log2(hi - lo) dependent loads). Each step keeps
// cdf[j] <= p for j < c and the count within [c, c + len].
template <int K, typename I>
__device__ __forceinline__ void upper_bound_k(const float* __restrict__ cdf,
                                              I lo, I hi, const float (&p)[K],
                                              I (&c)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = lo;
  if (hi <= lo) return;
  for (I len = hi - lo; len > 1;) {
    const I half = len >> 1;
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] += cdf[c[k] + half] <= p[k] ? half : 0;
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] += cdf[c[k]] <= p[k] ? 1 : 0;
}

// The same count over [lo, hi) by one warp, every lane passing the same p:
// a 32-ary search. Each round the 32 lanes load 32 evenly spaced pivots at
// once and a ballot keeps the stretch between the last pivot <= p and the
// first above it, so a 2^20-long cdf takes 4 rounds of loads where the
// binary search takes 20 dependent ones. (Two or four pivots a lane, for
// 3 rounds, were slower on the H100: the pivots' L2 sectors cost more than
// the round saves.) Every lane returns the count.
__device__ __forceinline__ long long warp_upper_bound(
    const float* __restrict__ cdf, long long lo, long long hi, float p) {
  const int lane = threadIdx.x & 31;
  // Invariant: cdf[j] <= p for j < lo, cdf[j] > p for j >= hi.
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) >> 5;
    const long long j = lo + (lane + 1) * step - 1;
    // Monotone cdf: the lanes whose pivot is <= p are a prefix.
    const int c = __popc(__ballot_sync(kFullMask, j < hi && cdf[j] <= p));
    const long long above = lo + (c + 1) * step - 1;  // lane c's pivot
    lo += c * step;
    hi = above < hi ? above : hi;
  }
  const long long j = lo + lane;
  return lo + __popc(__ballot_sync(kFullMask, j < hi && cdf[j] <= p));
}

// The stretch of the cdf that a block's queries can land on, and the
// search of a thread's queries in it (CdfWindow::search). For a monotone
// cdf and pmin <= p <= pmax, with lo = #{j : cdf[j] <= pmin} and
// hi = #{j : cdf[j] <= pmax}:
//   #{j : cdf[j] <= p} = lo + #{j in [lo, hi) : cdf[j] <= p},
// since every entry below lo is <= pmin <= p and every entry from hi on is
// > pmax >= p. So a block finds lo and hi once (two warps, 32-ary), copies
// cdf[lo, hi) into shared memory with coalesced loads when it fits W
// floats, and each thread answers its K queries by upper_bound_k there: a
// few shared-memory steps in place of ~log2(n) dependent L2 loads. A wider
// stretch (long zero runs, strided or unsorted queries) is searched by
// upper_bound_k in global memory within [lo, hi); a query outside
// [pmin, pmax] (NaN) searches the whole cdf. Every branch gives the
// inverse-CDF ancestor #{j < n : cdf[j] <= p} clipped to n - 1
// (searchsorted, side right; `<=` never picks a zero-weight particle, whose
// cdf value equals its predecessor's).
struct CdfWindow {
  const float* cdf;
  const float* win;  // cdf[lo, hi) in shared memory when `fits`
  long long n;
  long long lo;
  long long hi;
  float pmin;
  float pmax;
  bool fits;

  template <int K>
  __device__ __forceinline__ void search(const float (&p)[K],
                                         long long (&c)[K]) const {
    if (fits) {
      int w[K];
      upper_bound_k<K, int>(win, 0, static_cast<int>(hi - lo), p, w);
#pragma unroll
      for (int k = 0; k < K; ++k) c[k] = lo + w[k];
    } else {
      upper_bound_k<K, long long>(cdf, lo, hi, p, c);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!(p[k] >= pmin && p[k] <= pmax)) {
        c[k] = upper_bound<long long>(cdf, 0, n, p[k]);
      }
      c[k] = c[k] < n - 1 ? c[k] : n - 1;
    }
  }

  __device__ __forceinline__ long long search(float p) const {
    const float q[1] = {p};
    long long c[1];
    search<1>(q, c);
    return c[0];
  }
};

// Every thread of the block (at least 64) calls this with the block's
// smallest and largest query; `win` holds W floats and `s_range` two
// counts, both in shared memory. It synchronises the block twice.
template <int W>
__device__ __forceinline__ CdfWindow block_cdf_window(
    const float* __restrict__ cdf, long long n, float pmin, float pmax,
    float* win, long long* s_range) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long c = warp_upper_bound(cdf, 0, n, warp ? pmax : pmin);
    if ((threadIdx.x & 31) == 0) s_range[warp] = c;
  }
  __syncthreads();
  CdfWindow w{cdf, win, n, s_range[0], s_range[1], pmin, pmax, false};
  w.fits = w.hi - w.lo <= W;
  if (w.fits) {
    for (long long j = threadIdx.x; j < w.hi - w.lo; j += blockDim.x) {
      win[j] = cdf[w.lo + j];
    }
  }
  __syncthreads();
  return w;
}

}  // namespace cusmc
