// Inverse-CDF search and column gathers: the three kernels of
// cusmc_tpu/ops/monotone_gather.py.
//
// - inverse_cdf_apply replaces _search_kernel (behind inverse_cdf_apply,
//   both its global and its sharded local_base mode). For each query
//     a[i] = #{j : cdf[j] <= pos[i]}, clipped to n - 1   (searchsorted, right)
//   and out[r, i] = X[r, clip(a[i] - base, 0, nloc - 1)] for every state
//   row r of X [d, nloc], which holds the global columns [base, base+nloc).
//   base = 0, nloc = n is the single-shard mode. `<=` keeps zero-weight
//   particles (equal consecutive cdf values) from ever being chosen. The cdf
//   may be unnormalised; positions are scaled by its total by the caller,
//   and a last position that rounds past cdf[n-1] lands on n - 1 by the clip.
// - inverse_cdf_search replaces _search_only_kernel (behind
//   inverse_cdf_search): the same ancestors for nq queries, any nq, without
//   a state.
// - take_columns replaces _take_kernel and its jnp.take fallback (behind
//   take_columns): out[r, i] = X[r, clip(a[i], 0, n - 1)] for any ancestor
//   vector, sorted or not.
//
// The TPU kernels walk 2048-element cdf or state windows with DMAs and a
// two-gather lookup because Mosaic's dynamic gather spans one vreg; the
// coarse window placement (an argsort over the 128-strided cdf), the
// merge-path window counts and the runtime monotonicity check behind
// take_columns exist for the same reason. None of that is needed here: one
// thread per query binary-searches the cdf in global memory, and one thread
// per output column gathers its d values. The 4 MB cdf at N = 2^20 stays in
// the 50 MB L2, and sorted queries make neighbouring threads walk the same
// search path, so the upper levels hit in L1. Unsorted queries and ancestor
// vectors cost only locality, never correctness.
//
// Bound on the card: latency of the ~log2(N) dependent cdf loads per query
// (L2 hits), then memory: 4 B of positions, 4 B of ancestors and 8d B of
// state (read and write) per query, 4 B per cdf element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clip_index(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
inverse_cdf_apply_kernel(const float* __restrict__ cdf,
                         const float* __restrict__ pos,
                         const float* __restrict__ X, float* __restrict__ out,
                         int* __restrict__ anc, long long n, long long nq,
                         long long nloc, long long base, int d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nq) return;
  const long long a = cusmc::upper_bound_clipped(cdf, n, pos[i]);
  anc[i] = static_cast<int>(a);
  const long long rel = clip_index(a - base, nloc - 1);
  for (int r = 0; r < d; ++r) {
    out[static_cast<long long>(r) * nq + i] =
        X[static_cast<long long>(r) * nloc + rel];
  }
}

__global__ void __launch_bounds__(kThreads)
inverse_cdf_search_kernel(const float* __restrict__ cdf,
                          const float* __restrict__ pos,
                          int* __restrict__ anc, long long n, long long nq) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nq) return;
  anc[i] = static_cast<int>(cusmc::upper_bound_clipped(cdf, n, pos[i]));
}

__global__ void __launch_bounds__(kThreads)
take_columns_kernel(const float* __restrict__ X, const int* __restrict__ a,
                    float* __restrict__ out, long long n, long long m, int d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long col = clip_index(static_cast<long long>(a[i]), n - 1);
  for (int r = 0; r < d; ++r) {
    out[static_cast<long long>(r) * m + i] =
        X[static_cast<long long>(r) * n + col];
  }
}

unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

// cdf [n], pos [nq], X [d, nloc] (all f32, contiguous) -> out [d, nq] f32
// and anc [nq] int32 (global indices).
CUSMC_EXPORT int cusmc_inverse_cdf_apply(const float* cdf, const float* pos,
                                         const float* X, float* out, int* anc,
                                         long long n, long long nq,
                                         long long nloc, long long base, int d,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  inverse_cdf_apply_kernel<<<blocks_for(nq), kThreads, 0, s>>>(
      cdf, pos, X, out, anc, n, nq, nloc, base, d);
  return static_cast<int>(cudaGetLastError());
}

// cdf [n], pos [nq] (f32, contiguous) -> anc [nq] int32.
CUSMC_EXPORT int cusmc_inverse_cdf_search(const float* cdf, const float* pos,
                                          int* anc, long long n, long long nq,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  inverse_cdf_search_kernel<<<blocks_for(nq), kThreads, 0, s>>>(cdf, pos, anc,
                                                                 n, nq);
  return static_cast<int>(cudaGetLastError());
}

// X [d, n] f32 and a [m] int32 (contiguous) -> out [d, m] f32.
CUSMC_EXPORT int cusmc_take_columns(const float* X, const int* a, float* out,
                                    long long n, long long m, int d,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  take_columns_kernel<<<blocks_for(m), kThreads, 0, s>>>(X, a, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}
