// Monotone inclusive prefix sum of non-negative float32 weights.
//
// Replaces cusmc_tpu/ops/cumsum.py::_cumsum_kernel (behind blocked_cumsum).
// The TPU kernel runs its grid in order on one core and carries the running
// total in VMEM from block to block. Here blocks run in parallel, so the scan
// takes three launches on one stream:
//
//   A. tile_totals: each 4096-element tile computes its local scan and
//      writes its total (the local scan's last value);
//   B. tile_offsets: ONE thread turns the tile totals into exclusive tile
//      offsets, sequentially: off[b+1] = off[b] + total[b];
//   C. tile_apply: each tile recomputes the same local scan and writes
//      cdf = off[b] + local.
//
// Monotone output is what the inverse-CDF search relies on. Within a tile,
// each thread adds its 16 items sequentially (monotone, since w >= 0), the
// thread prefixes come from a shuffle scan, and an exact max-scan over the
// tile (max is exact in floating point) removes any one-ulp dip that the
// shuffle tree's rounding could leave between neighbouring threads. Across
// tiles, the last value of tile b is written as off[b] + total[b], which is
// bitwise the expression pass B carries into off[b+1]; tile b+1 starts at
// off[b+1] + w >= off[b+1]. This is the CUDA counterpart of the TPU kernel
// writing each block's last element with its carry expression
// (cumsum.py:67-74).
//
// Bound on the card: memory. Pass A reads w (4 B/particle), pass C reads w
// and writes cdf (8 B/particle): 12 B per particle, about 4 us of traffic at
// N = 2^20, so the three launches cost about as much as the traffic. Each
// tile moves through shared memory (padded one word in 32, so neither the
// coalesced global accesses nor the per-thread runs of 16 conflict on
// banks). The sequential pass B is ~4 cycles per tile (256 tiles at
// N = 2^20).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kOffsetChunk = 4096;
constexpr int kStage = kTile + kTile / 32;

// Shared-memory slot of tile element j: one pad word after every 32.
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

// Local (offset-free) monotone inclusive scan of tile [base, base + kTile).
// Thread t owns elements [16 t, 16 t + 16) of the tile. Leaves its 16 local
// prefixes in vals and returns the tile total, which equals the last local
// prefix of the tile. stage is the block's kStage-float staging buffer.
__device__ float tile_scan(const float* __restrict__ w, long long base,
                           long long n, float (&vals)[kItems],
                           float* stage) {
  __shared__ float warp_part[kWarps];
  __shared__ float tile_total;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

#pragma unroll
  for (int k = 0; k < kItems; ++k) {  // coalesced: element k * 256 + t
    const int j = k * kThreads + t;
    const long long i = base + j;
    stage[pad(j)] = (i < n) ? w[i] : 0.f;
  }
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc = acc + stage[pad(t * kItems + k)];
    vals[k] = acc;
  }

  // Exclusive prefix of the thread totals: warp shuffles, then the warps.
  const float incl = cusmc::warp_inclusive_sum(acc, lane);
  float excl = __shfl_up_sync(cusmc::kFullMask, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float s = (lane < kWarps) ? warp_part[lane] : 0.f;
    const float si = cusmc::warp_inclusive_sum(s, lane);
    float se = __shfl_up_sync(cusmc::kFullMask, si, 1);
    if (lane == 0) se = 0.f;
    if (lane < kWarps) warp_part[lane] = se;
  }
  __syncthreads();
  const float p = warp_part[warp] + excl;
#pragma unroll
  for (int k = 0; k < kItems; ++k) vals[k] = p + vals[k];
  __syncthreads();  // warp_part is reused below

  // Exact max-scan: every value is raised to the largest value before it.
  const float mine = vals[kItems - 1];
  const float mi = cusmc::warp_inclusive_max(mine, lane);
  float me = __shfl_up_sync(cusmc::kFullMask, mi, 1);
  if (lane == 0) me = -INFINITY;
  if (lane == 31) warp_part[warp] = mi;
  __syncthreads();
  if (warp == 0) {
    const float s = (lane < kWarps) ? warp_part[lane] : -INFINITY;
    const float si = cusmc::warp_inclusive_max(s, lane);
    float se = __shfl_up_sync(cusmc::kFullMask, si, 1);
    if (lane == 0) se = -INFINITY;
    if (lane < kWarps) warp_part[lane] = se;
    if (lane == kWarps - 1) tile_total = si;
  }
  __syncthreads();
  const float floor_v = fmaxf(warp_part[warp], me);
#pragma unroll
  for (int k = 0; k < kItems; ++k) vals[k] = fmaxf(vals[k], floor_v);
  return tile_total;
}

__global__ void __launch_bounds__(kThreads)
tile_totals_kernel(const float* __restrict__ w, float* __restrict__ totals,
                   long long n) {
  __shared__ float stage[kStage];
  float vals[kItems];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const float total = tile_scan(w, base, n, vals, stage);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// totals[b] -> exclusive offsets, in place, in one sequential chain.
__global__ void tile_offsets_kernel(float* __restrict__ totals, long long nb) {
  __shared__ float buf[kOffsetChunk];
  float running = 0.f;
  for (long long c0 = 0; c0 < nb; c0 += kOffsetChunk) {
    const int m = static_cast<int>(nb - c0 < kOffsetChunk ? nb - c0
                                                          : kOffsetChunk);
    for (int i = threadIdx.x; i < m; i += blockDim.x) buf[i] = totals[c0 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) {
        const float s = buf[i];
        buf[i] = running;
        running = running + s;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) totals[c0 + i] = buf[i];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
tile_apply_kernel(const float* __restrict__ w,
                  const float* __restrict__ offsets, float* __restrict__ cdf,
                  long long n) {
  __shared__ float stage[kStage];
  float vals[kItems];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  tile_scan(w, base, n, vals, stage);
  const float off = offsets[blockIdx.x];
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) stage[pad(t * kItems + k)] = off + vals[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {  // coalesced: element k * 256 + t
    const int j = k * kThreads + t;
    const long long i = base + j;
    if (i < n) cdf[i] = stage[pad(j)];
  }
}

}  // namespace

// w [n] f32 -> cdf [n] f32; scratch holds ceil(n / 4096) floats.
CUSMC_EXPORT int cusmc_blocked_cumsum(const float* w, float* cdf,
                                      float* scratch, long long n,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kTile - 1) / kTile;
  tile_totals_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      w, scratch, n);
  tile_offsets_kernel<<<1, 1024, 0, s>>>(scratch, nb);
  tile_apply_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      w, scratch, cdf, n);
  return static_cast<int>(cudaGetLastError());
}

CUSMC_EXPORT int cusmc_cumsum_tile() { return kTile; }
