// Inverse-CDF search and column gathers: the three kernels of
// cusmc_tpu/ops/monotone_gather.py.
//
// - inverse_cdf_apply replaces _search_kernel (behind inverse_cdf_apply,
//   both its global and its sharded local_base mode). For each query
//     a[i] = #{j : cdf[j] <= pos[i]}, clipped to n - 1   (searchsorted, right)
//   and out[r, i] = X[r, clip(a[i] - base, 0, nloc - 1)] for every state
//   row r of X [d, nloc], which holds the global columns [base, base+nloc).
//   base = 0, nloc = n is the single-shard mode. X is float32 or, under
//   mixed precision, bfloat16 (the gather's element type; the search is
//   float32 either way, and the gather copies values exactly; the TPU
//   package sends a bfloat16 X to XLA's gather instead). `<=` keeps zero-weight
//   particles (equal consecutive cdf values) from ever being chosen. The cdf
//   may be unnormalised; positions are scaled by its total by the caller,
//   and a last position that rounds past cdf[n-1] lands on n - 1 by the clip.
// - inverse_cdf_search replaces _search_only_kernel (behind
//   inverse_cdf_search): the same ancestors for nq queries, any nq, without
//   a state.
// - take_columns replaces _take_kernel and its jnp.take fallback (behind
//   take_columns): out[r, i] = X[r, clip(a[i], 0, n - 1)] for any ancestor
//   vector, sorted or not, of a float32 or a bfloat16 X (the TPU package
//   sends a bfloat16 X to jnp.take).
//
// The TPU kernels walk 2048-element cdf or state windows with DMAs and a
// two-gather lookup because Mosaic's dynamic gather spans one vreg; the
// coarse window placement (an argsort over the 128-strided cdf), the
// merge-path window counts and the runtime monotonicity check behind
// take_columns exist for the same reason. None of that is needed here.
// inverse_cdf_search and inverse_cdf_apply share their search
// (block_search): a block of kThreads threads takes kSearchPerThread
// queries each, reduces their min and max, and answers them through the
// block-window search of common.cuh (CdfWindow): two warps find the
// stretch cdf[lo, hi) the queries can land on in 4 rounds of 32 parallel
// loads, the block copies it into shared memory when it is at most
// kSearchWindow floats, and each thread searches its queries together
// there (upper_bound_k). The min and max make the window exact for queries
// in any order; unsorted queries cost only locality, never correctness
// (shuffled queries span the whole cdf and take the in-place search of
// every block). inverse_cdf_apply then gathers each query's d values from
// X row by row.
//
// Bound on the card: memory: 4 B of positions and 4 B of ancestors per
// query, 4 B per cdf element (inverse_cdf_apply adds 2 s d B of state read
// and written per query for s-byte values: at d = 32 in float32 the gather
// is 256 of its ~268 B a query). take_columns moves 4 + 2 s d B a column;
// on scattered ancestors each s-byte read still costs a 32-byte sector, so
// a bfloat16 gather saves only its writes there.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// inverse_cdf_search and inverse_cdf_apply: queries a block, and the
// capacity of the block's shared window (floats), both -D defines from
// ops/kernels.py (PERF.md says how they were chosen on the H100).
constexpr int kSearchBlock = CUSMC_SEARCH_BLOCK;
constexpr int kSearchWindow = CUSMC_SEARCH_WINDOW;
static_assert(kSearchBlock % kThreads == 0, "whole queries a thread");
constexpr int kSearchPerThread = kSearchBlock / kThreads;

__device__ __forceinline__ long long clip_index(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The ancestors of a block's kSearchBlock queries, c[k] for query
// i0 + k kThreads of this thread (coalesced loads and stores), through the
// block window: the block's smallest and largest query bound the stretch of
// the cdf it can land on. Every thread of the block calls this.
__device__ __forceinline__ void block_search(
    const float* __restrict__ cdf, const float* __restrict__ pos,
    long long n, long long nq, long long i0,
    long long (&c)[kSearchPerThread]) {
  __shared__ float s_win[kSearchWindow];
  __shared__ float s_min[kThreads / 32];
  __shared__ float s_max[kThreads / 32];
  __shared__ long long s_range[2];
  float p[kSearchPerThread];
  float lo = INFINITY;
  float hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kSearchPerThread; ++k) {
    const long long i = i0 + k * kThreads;
    p[k] = i < nq ? pos[i] : 0.0f;
    if (i < nq) {
      lo = fminf(lo, p[k]);
      hi = fmaxf(hi, p[k]);
    }
  }
  // The block's smallest and largest query (fminf and fmaxf skip a NaN,
  // which then searches the whole cdf).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(cusmc::kFullMask, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(cusmc::kFullMask, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    s_min[threadIdx.x >> 5] = lo;
    s_max[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = fminf(lo, s_min[w]);
    hi = fmaxf(hi, s_max[w]);
  }
  const cusmc::CdfWindow win =
      cusmc::block_cdf_window<kSearchWindow>(cdf, n, lo, hi, s_win, s_range);
  // A thread's queries are searched together; one past the end takes the
  // block's smallest, which stays inside the window.
#pragma unroll
  for (int k = 0; k < kSearchPerThread; ++k) {
    if (i0 + k * kThreads >= nq) p[k] = lo;
  }
  win.search(p, c);
}

__global__ void __launch_bounds__(kThreads)
inverse_cdf_search_kernel(const float* __restrict__ cdf,
                          const float* __restrict__ pos,
                          int* __restrict__ anc, long long n, long long nq) {
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kSearchBlock + threadIdx.x;
  long long c[kSearchPerThread];
  block_search(cdf, pos, n, nq, i0, c);
#pragma unroll
  for (int k = 0; k < kSearchPerThread; ++k) {
    const long long i = i0 + k * kThreads;
    if (i < nq) anc[i] = static_cast<int>(c[k]);
  }
}

// The search-only kernel's blocks, then each thread gathers the d values of
// its queries row by row: a row's kSearchPerThread loads are independent,
// and the stores of a row stay coalesced along i. The row loop is unrolled
// kUnroll deep: 8 for a wide state (at d = 32 the gather is most of the
// bytes, and scattered ancestors read a 32-byte sector for each 4-byte
// value), 4 for a narrow one, whose rows the deeper loop would leave to its
// remainder (the launch picks by d; both timed on the H100 in PERF.md).
template <int kUnroll, typename T>
__global__ void __launch_bounds__(kThreads)
inverse_cdf_apply_kernel(const float* __restrict__ cdf,
                         const float* __restrict__ pos,
                         const T* __restrict__ X, T* __restrict__ out,
                         int* __restrict__ anc, long long n, long long nq,
                         long long nloc, long long base, int d) {
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kSearchBlock + threadIdx.x;
  long long c[kSearchPerThread];
  block_search(cdf, pos, n, nq, i0, c);
  long long rel[kSearchPerThread];
#pragma unroll
  for (int k = 0; k < kSearchPerThread; ++k) {
    const long long i = i0 + k * kThreads;
    if (i < nq) anc[i] = static_cast<int>(c[k]);
    rel[k] = clip_index(c[k] - base, nloc - 1);
  }
#pragma unroll (kUnroll)
  for (int r = 0; r < d; ++r) {
    const T* __restrict__ row = X + static_cast<long long>(r) * nloc;
    T* __restrict__ orow = out + static_cast<long long>(r) * nq;
    T v[kSearchPerThread];
#pragma unroll
    for (int k = 0; k < kSearchPerThread; ++k) v[k] = row[rel[k]];
#pragma unroll
    for (int k = 0; k < kSearchPerThread; ++k) {
      const long long i = i0 + k * kThreads;
      if (i < nq) orow[i] = v[k];
    }
  }
}

// One thread a column of a band of kTakeRows state rows, band b =
// blockIdx.y: the thread reads its ancestor once, loads the band's values,
// then stores them (the stores of a row coalesced along i). The blocks of
// band 0 run before those of band 1 (blockIdx.x varies fastest), so the
// gather reads one band of X at a time, which scattered ancestors find in
// the 50 MB L2. A thread walking all d rows of its column spread its reads
// over the whole of X (64 MB at d = 32 in bfloat16) and took 2.2-2.3x
// index_select's time there (PERF.md section 6). Bands of 1, 2, 4 and 8
// rows timed against each other on the H100: 2 was the fastest, or within
// 1%, on every shape the main paths give the kernel (d = 2, and d = 32 on
// scattered ancestors); 1 lost on sorted ancestors, 8 on a scattered
// float32 state at d = 32. T is the state's type, float or, under mixed
// precision, __nv_bfloat16; the copy is exact.
constexpr int kTakeRows = 2;

template <typename T>
__global__ void __launch_bounds__(kThreads)
take_columns_kernel(const T* __restrict__ X, const int* __restrict__ a,
                    T* __restrict__ out, long long n, long long m, int d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int r0 = blockIdx.y * kTakeRows;
  const int rows = min(kTakeRows, d - r0);
  const long long col = clip_index(static_cast<long long>(a[i]), n - 1);
  T v[kTakeRows];
#pragma unroll
  for (int k = 0; k < kTakeRows; ++k) {
    if (k < rows) v[k] = X[static_cast<long long>(r0 + k) * n + col];
  }
#pragma unroll
  for (int k = 0; k < kTakeRows; ++k) {
    if (k < rows) out[static_cast<long long>(r0 + k) * m + i] = v[k];
  }
}

unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

unsigned search_blocks(long long nq) {
  return static_cast<unsigned>((nq + kSearchBlock - 1) / kSearchBlock);
}

template <typename T>
void launch_apply(const float* cdf, const float* pos, const void* X,
                  void* out, int* anc, long long n, long long nq,
                  long long nloc, long long base, int d, cudaStream_t s) {
  auto kernel = d >= 8 ? inverse_cdf_apply_kernel<8, T>
                       : inverse_cdf_apply_kernel<4, T>;
  kernel<<<search_blocks(nq), kThreads, 0, s>>>(
      cdf, pos, static_cast<const T*>(X), static_cast<T*>(out), anc, n, nq,
      nloc, base, d);
}

}  // namespace

// cdf [n], pos [nq] (f32), X [d, nloc] (f32, or bf16 when bf16 != 0; all
// contiguous) -> out [d, nq] of X's type and anc [nq] int32 (global
// indices).
CUSMC_EXPORT int cusmc_inverse_cdf_apply(const float* cdf, const float* pos,
                                         const void* X, void* out, int* anc,
                                         long long n, long long nq,
                                         long long nloc, long long base, int d,
                                         int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_apply<__nv_bfloat16>(cdf, pos, X, out, anc, n, nq, nloc, base, d,
                                s);
  } else {
    launch_apply<float>(cdf, pos, X, out, anc, n, nq, nloc, base, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// cdf [n], pos [nq] (f32, contiguous) -> anc [nq] int32.
CUSMC_EXPORT int cusmc_inverse_cdf_search(const float* cdf, const float* pos,
                                          int* anc, long long n, long long nq,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  inverse_cdf_search_kernel<<<search_blocks(nq), kThreads, 0, s>>>(
      cdf, pos, anc, n, nq);
  return static_cast<int>(cudaGetLastError());
}

// X [d, n] (f32, or bf16 when bf16 != 0) and a [m] int32 (contiguous) ->
// out [d, m] of X's type.
CUSMC_EXPORT int cusmc_take_columns(const void* X, const int* a, void* out,
                                    long long n, long long m, int d, int bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(m),
                  static_cast<unsigned>((d + kTakeRows - 1) / kTakeRows));
  if (bf16) {
    take_columns_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), a,
        static_cast<__nv_bfloat16*>(out), n, m, d);
  } else {
    take_columns_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(X), a, static_cast<float*>(out), n, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}
