// Fused inverse-CDF resample: ancestors and the resampled state in one pass.
//
// Replaces cusmc_tpu/ops/monotone_gather.py::_search_kernel (behind
// inverse_cdf_apply, without its sharded local_base mode). For each query
//   a[i] = #{j : cdf[j] <= pos[i]}, clipped to n - 1   (searchsorted, right)
// and out[r, i] = X[r, a[i]] for every state row r. `<=` keeps zero-weight
// particles (equal consecutive cdf values) from ever being chosen. The cdf
// may be unnormalised; positions are scaled by its total by the caller, and
// a last position that rounds past cdf[n-1] lands on n - 1 by the clip.
//
// The TPU kernel walks 2048-element cdf windows with DMAs and a two-gather
// lookup because Mosaic's dynamic gather spans one vreg; the coarse window
// placement (an argsort over the 128-strided cdf) and the merge-path window
// counts exist for the same reason. None of that is needed here: one thread
// per query binary-searches the cdf in global memory. The 4 MB cdf at
// N = 2^20 stays in the 50 MB L2, and sorted queries make neighbouring
// threads walk the same search path, so the upper levels hit in L1.
//
// Bound on the card: latency of the ~log2(N) dependent cdf loads per query
// (L2 hits), then memory: 4 B of positions, 4 B of ancestors and 8d B of
// state (read and write) per particle.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
inverse_cdf_apply_kernel(const float* __restrict__ cdf,
                         const float* __restrict__ pos,
                         const float* __restrict__ X, float* __restrict__ out,
                         int* __restrict__ anc, long long n, long long nq,
                         int d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nq) return;
  const long long a = cusmc::upper_bound_clipped(cdf, n, pos[i]);
  anc[i] = static_cast<int>(a);
  for (int r = 0; r < d; ++r) {
    out[static_cast<long long>(r) * nq + i] = X[static_cast<long long>(r) * n + a];
  }
}

}  // namespace

// cdf [n], pos [nq], X [d, n] (all f32, contiguous) -> out [d, nq] f32 and
// anc [nq] int32.
CUSMC_EXPORT int cusmc_inverse_cdf_apply(const float* cdf, const float* pos,
                                         const float* X, float* out, int* anc,
                                         long long n, long long nq, int d,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (nq + kThreads - 1) / kThreads;
  inverse_cdf_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      cdf, pos, X, out, anc, n, nq, d);
  return static_cast<int>(cudaGetLastError());
}
