// Monotone inclusive prefix sum of non-negative float32 weights.
//
// Replaces cusmc_tpu/ops/cumsum.py::_cumsum_kernel (behind blocked_cumsum).
// The TPU kernel runs its grid in order on one core and carries the running
// total in VMEM from block to block. Here blocks run in parallel, so the
// carry goes through a single-pass chained scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016): one launch, one read of w and one write of cdf.
//
// Each block of 512 threads takes the next 8192-element tile in launch order
// from a ticket counter, so every tile it waits on belongs to a block that
// is already running. It then
//   1. loads its tile (16-byte vector loads where the tile is whole and w is
//      16-byte aligned, masked scalar loads on the ragged tail) into shared
//      memory, padded one word in 32 so neither the coalesced accesses nor
//      the per-thread runs of 16 conflict on banks;
//   2. scans it locally: each thread adds its 16 items sequentially, the
//      thread prefixes come from a shuffle scan, and an exact max-scan over
//      the tile (max is exact in floating point) removes any one-ulp dip the
//      shuffle tree's rounding could leave between neighbouring threads.
//      The tile's aggregate agg(b) is its last local value;
//   3. publishes agg(b) in its status word (flag AGG), and looks back;
//   4. publishes its inclusive prefix I(b) = excl(b) + agg(b) (flag INCL)
//      and writes cdf = excl(b) + local, coalesced.
//
// The look-back sums in one fixed order. Warp 0 first walks back, reading
// 128 status words at once, until it finds a tile P < b whose INCL word is
// out, then one lane adds the aggregates of tiles P+1 .. b-1 to I(P) one
// at a time, left to right, from shared memory (a word that has turned
// INCL meanwhile is taken as the running sum). By induction every I(j) is bitwise the sequential sum
//   S(0) = 0, S(j+1) = S(j) + agg(j),
// whichever P a tile happened to find: the result does not depend on the
// timing and is the same on every run.
//
// Monotone output, which the inverse-CDF search relies on: within a tile,
// excl + local is non-decreasing since local is and rounding is monotone.
// Across tiles, tile b's last value is excl(b) + agg(b) = I(b) bitwise (the
// same expression), and tile b+1's excl is S(b+1) = I(b) bitwise, so every
// value tile b+1 writes is fl(I(b) + local) >= I(b). The floor that tile
// b+1 raises its values to is therefore tile b's published inclusive
// prefix, exactly; the fmaxf that applies it (below) never has to move a
// value.
//
// Why the look-back cannot deadlock: a tile publishes its AGG word right
// after its own local scan, before it waits on anything, and the look-back
// waits only for AGG or INCL words of tiles with a smaller ticket, whose
// blocks are already resident. Tile b publishes INCL after its own
// look-back, never after tile b+1's. Tile 0 publishes INCL at once.
//
// No per-call reset: every status word carries the call's epoch beside its
// flag ((epoch << 2 | flag) in the high half, the float in the low half,
// written and read as one relaxed 64-bit access, so no fence has to order a
// value before its flag), and a word of another epoch reads as "not yet
// published". The ticket counter is never reset either: the caller
// passes the count of tickets handed out before this call (ops/cumsum.py
// keeps it, with the epoch, per device and stream).
//
// Rounding depth: an element of the output passes through at most 15
// in-thread additions, 5 warp-shuffle levels, 4 levels of the warp-offset
// scan (16 warps), the two additions that apply them, tiles - 1 additions
// of the sequential tile prefix and the final excl + local: 26 + tiles
// roundings, tiles = ceil(N / 8192). So |cdf - exact| <= gamma(26 + tiles)
// * total, with gamma(k) = k u / (1 - k u), u = 2^-24 (chip_smoke.py,
// tests/test_torch_cuda.py).
//
// Bound on the card: memory, 8 B per element (w read once, cdf written
// once): 2.5 us at N = 2^20 on an H100 SXM (3.35 TB/s).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 8192 elements per block
constexpr int kChunk = 4;                 // look-back windows read at once
constexpr int kWarps = kThreads / 32;
constexpr int kStage = kTile + kTile / 32;
constexpr uint32_t kAgg = 1u;
constexpr uint32_t kIncl = 2u;

// Shared-memory slot of tile element j: one pad word after every 32.
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

__device__ __forceinline__ void publish(unsigned long long* word,
                                        uint32_t epoch, uint32_t flag,
                                        float v) {
  const unsigned long long w =
      (static_cast<unsigned long long>((epoch << 2) | flag) << 32) |
      __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

// The flag of a status word if it belongs to this call's epoch, else 0.
__device__ __forceinline__ uint32_t read_status(
    const unsigned long long* word, uint32_t epoch, float* v) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word)
               : "memory");
  const uint32_t hi = static_cast<uint32_t>(w >> 32);
  *v = __uint_as_float(static_cast<uint32_t>(w));
  return (hi >> 2) == epoch ? (hi & 3u) : 0u;
}

// Thread t's share of tile b: elements 4 (k * 512 + t) + c of the tile,
// k < 4, c < 4, as four coalesced 16-byte loads when the tile is whole and
// w is 16-byte aligned, else as masked scalar loads.
__device__ __forceinline__ void load_tile(const float* __restrict__ w,
                                          long long b, long long n,
                                          int aligned,
                                          float4 (&v4)[kItems / 4]) {
  const long long base = b * kTile;
  const int t = threadIdx.x;
  if (aligned && base + kTile <= n) {
    const float4* w4 = reinterpret_cast<const float4*>(w + base);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) v4[k] = __ldg(w4 + k * kThreads + t);
  } else {
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const long long i = base + 4LL * (k * kThreads + t);
      v4[k] = make_float4(i < n ? w[i] : 0.f, i + 1 < n ? w[i + 1] : 0.f,
                          i + 2 < n ? w[i + 2] : 0.f,
                          i + 3 < n ? w[i + 3] : 0.f);
    }
  }
}

// Local (offset-free) monotone inclusive scan of the staged tile. Thread t
// owns elements [16 t, 16 t + 16). Leaves its 16 local prefixes in vals and
// returns the tile aggregate, the largest (and last) local prefix.
__device__ float tile_scan(const float* stage, float (&vals)[kItems],
                           float* warp_part) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
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
    if (lane == kWarps - 1) warp_part[kWarps] = si;
  }
  __syncthreads();
  const float floor_v = fmaxf(warp_part[warp], me);
#pragma unroll
  for (int k = 0; k < kItems; ++k) vals[k] = fmaxf(vals[k], floor_v);
  return warp_part[kWarps];
}

// Lane l of warp 0 holds the status of tiles lo + 32 q + l, q < kChunk.
// Folds tiles [from, to) of them into acc, left to right: an INCL word is
// the running sum itself, an AGG word is added. The values go through
// `scratch` (2 * 32 kChunk words of shared memory), and lane 0 folds
// them: one dependent add a tile. Returns acc on every lane.
__device__ __forceinline__ float fold_chunk(long long lo, long long from,
                                            long long to,
                                            const float (&v)[kChunk],
                                            const uint32_t (&f)[kChunk],
                                            float acc, float* scratch) {
  const int lane = threadIdx.x & 31;
  uint32_t* flags = reinterpret_cast<uint32_t*>(scratch + 32 * kChunk);
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    scratch[32 * q + lane] = v[q];
    flags[32 * q + lane] = f[q];
  }
  __syncwarp();
  if (lane == 0) {
    const int i1 = static_cast<int>(to - lo);
#pragma unroll 8
    for (int i = static_cast<int>(from - lo); i < i1; ++i) {
      acc = flags[i] == kIncl ? scratch[i] : acc + scratch[i];
    }
  }
  __syncwarp();
  return __shfl_sync(cusmc::kFullMask, acc, 0);
}

// Reads the status words of tiles lo + 32 q + lane (q < kChunk, tiles >= 0
// and < b) until each is published: the loads of a chunk are in flight
// together, and only a word not yet published is read again.
__device__ __forceinline__ void read_chunk(
    const unsigned long long* status, long long lo, long long b,
    uint32_t epoch, float (&v)[kChunk], uint32_t (&f)[kChunk]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const long long j = lo + 32 * q + lane;
    f[q] = 0u;
    v[q] = 0.f;
    if (j >= 0 && j < b) f[q] = read_status(status + j, epoch, &v[q]);
  }
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const long long j = lo + 32 * q + lane;
    while (j >= 0 && j < b && f[q] == 0u) {
      f[q] = read_status(status + j, epoch, &v[q]);
    }
  }
}

// Warp 0 of tile b > 0: the exclusive prefix S(b), the sequential sum of
// the aggregates of tiles 0 .. b-1 (see the file comment). Walks back a
// chunk of 32 kChunk tiles at a time to the nearest published INCL word P,
// then folds forward from I(P); chunks above P's are read again. Up to
// N = 2^20 (128 tiles) the first chunk reaches tile 0, so a look-back is
// one round of loads and one fold.
__device__ float look_back(const unsigned long long* status, long long b,
                           uint32_t epoch, float* scratch) {
  float v[kChunk];
  uint32_t f[kChunk];
  long long lo = b - 32 * kChunk;
  long long start = -1;
  for (;;) {
    read_chunk(status, lo, b, epoch, v, f);
#pragma unroll
    for (int q = kChunk - 1; q >= 0; --q) {
      const unsigned m = __ballot_sync(cusmc::kFullMask, f[q] == kIncl);
      if (start < 0 && m != 0u) start = lo + 32 * q + (31 - __clz(m));
    }
    if (start >= 0) break;
    lo -= 32 * kChunk;  // tile 0 is always INCL, so this ends
  }
  const long long hi = lo + 32 * kChunk;
  float acc = fold_chunk(lo, start, hi < b ? hi : b, v, f, 0.f, scratch);
  for (lo = hi; lo < b; lo += 32 * kChunk) {
    read_chunk(status, lo, b, epoch, v, f);
    acc = fold_chunk(lo, lo, lo + 32 * kChunk < b ? lo + 32 * kChunk : b, v,
                     f, acc, scratch);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ w, float* __restrict__ cdf,
            unsigned long long* __restrict__ state, long long n,
            long long ticket_base, uint32_t epoch, int aligned) {
  __shared__ float stage[kStage];
  __shared__ float warp_part[kWarps + 1];
  __shared__ long long s_tile;
  __shared__ float s_excl;
  const int t = threadIdx.x;
  unsigned long long* status = state + 1;  // state[0] is the ticket counter

  if (t == 0) {
    s_tile = static_cast<long long>(atomicAdd(state, 1ull)) - ticket_base;
  }
  __syncthreads();
  const long long b = s_tile;
  float4 v4[kItems / 4];
  load_tile(w, b, n, aligned, v4);
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {  // element 4 (k * 512 + t) + c
    const int q = k * kThreads + t;
    stage[pad(4 * q)] = v4[k].x;
    stage[pad(4 * q + 1)] = v4[k].y;
    stage[pad(4 * q + 2)] = v4[k].z;
    stage[pad(4 * q + 3)] = v4[k].w;
  }
  __syncthreads();
  float vals[kItems];
  const float agg = tile_scan(stage, vals, warp_part);
  const long long base = b * kTile;
  const bool whole = aligned && base + kTile <= n;

  if (b == 0) {
    if (t == 0) {
      publish(status, epoch, kIncl, agg);
      s_excl = 0.f;
    }
  } else {
    if (t == 0) publish(status + b, epoch, kAgg, agg);
    if (t < 32) {
      // stage is free until the output pass: it holds the fold's values.
      const float excl = look_back(status, b, epoch, stage);
      if (t == 0) {
        publish(status + b, epoch, kIncl, excl + agg);
        s_excl = excl;
      }
    }
  }
  __syncthreads();
  // Raised to the predecessor's inclusive prefix, which excl is bitwise.
  const float excl = s_excl;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    stage[pad(t * kItems + k)] = fmaxf(excl + vals[k], excl);
  }
  __syncthreads();
  if (whole) {
    float4* c4 = reinterpret_cast<float4*>(cdf + base);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int q = k * kThreads + t;
      c4[q] = make_float4(stage[pad(4 * q)], stage[pad(4 * q + 1)],
                          stage[pad(4 * q + 2)], stage[pad(4 * q + 3)]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + t;
      const long long i = base + j;
      if (i < n) cdf[i] = stage[pad(j)];
    }
  }
}

}  // namespace

// w [n] f32 -> cdf [n] f32, one launch. state: state_words 64-bit words
// (the ticket counter, then one status word per 8192-element tile), zeroed
// once when allocated and kept across calls; ticket_base: the counter's
// value when this call starts; epoch in [1, 2^30): differs from every
// earlier call's on this state since it was zeroed. Both fixed by the
// caller. cudaErrorInvalidValue if the state is too small.
CUSMC_EXPORT int cusmc_blocked_cumsum(const float* w, float* cdf,
                                      unsigned long long* state,
                                      long long state_words, long long n,
                                      long long ticket_base, int epoch,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kTile - 1) / kTile;
  if (1 + nb > state_words || epoch < 1 || epoch >= (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int aligned =
      (reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
       reinterpret_cast<uintptr_t>(cdf) % 16 == 0) ? 1 : 0;
  scan_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      w, cdf, state, n, ticket_base, static_cast<uint32_t>(epoch), aligned);
  return static_cast<int>(cudaGetLastError());
}
