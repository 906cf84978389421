// Fused filter step, windowed Metropolis: resample, propagate and reweight
// in one pass.
//
// Replaces cusmc_tpu/ops/fused_step.py::_step_kernel (behind
// fused_filter_step). For tile i of `tile` particles, the candidate window
// is the source tiles (i + s0) mod nb and (i + s0 + 1) mod nb, plus tile
// (i + s1) mod nb when num_window_tiles = 3, read through a lane rotation
// r (one per tile). Each of the B sweeps proposes, for lane l, window
// position db + l of the rotated window, with a 128-aligned offset db per
// tile and sweep; the chain accepts when u * w_cur < w_cand (exp space,
// float32, strict). The ancestor map is the TPU kernel's
// (fused_step.py:257-270); propagate and reweight follow (one of the two
// designs below). Random bits: Philox (philox.cuh); stream 1 of the tile
// gives r (row 0, lane 0) and the B offsets (row 1, lane b), stream 0 of
// the particle gives its B accept uniforms, then the noise rows.
//
// The TPU kernel double-buffers the window through VMEM with DMAs, because
// a random gather is slow there. Here each particle reads its candidates
// straight from global memory: the window is 2-3 tiles, so it sits in L2,
// and a warp's lanes read consecutive addresses. A block never straddles a
// tile, so its tile id, key, rotation, sweep offsets and window are the
// block's, formed once in 32 bits (n < 2^31: the ancestors are int32); a
// particle's candidate is then 32-bit adds and one wrap. Its walk loads
// the weights of kWalkChunk sweeps (and its start) together, draws the
// chunk's accept uniforms while they fly, and only then runs the accept
// chain, in the sweeps' order.
//
// Two designs of the propagate-and-reweight half, chosen by the caller as a
// plain function of (d, k) (ops/fused_step.py::step_path):
//   - "thread" (d and k up to 16 but d = k = 16; propagate.cuh): in the
//     compiled width bucket (DM, KM) of ops/fused_step.py::step_widths,
//     two particles a thread (one at DM = 16). A bucket's block holds 128
//     particles a thread's particle count; where that does not divide the
//     tile (a tile of an odd multiple of 128), the bucket (16, 1 or 16)
//     runs, one particle a thread, with the same values. The ancestors'
//     columns are loaded right after the walk and fly while the noise is
//     drawn.
//   - "tile" (d = k in {16, 32}, and every shape wider than 16): each
//     warp's 32 particles go through the four matrix products as 3xTF32
//     tensor-core tiles; the per-thread design spent ~4600 issue slots a
//     particle on FFMAs and their broadcast loads and ran 8.6x its bound at
//     d = 32 (PERF.md). At d = k in {16, 32} over shared-memory tiles of
//     exactly those widths (tile_propagate.cuh); past 16 at the padded
//     widths (DM, KM) of ops/fused_step.py::step_widths, DM in {32, 64,
//     128}, with one state tile a warp and the matrices' k-panels staged
//     for the whole block (wide_propagate.cuh). No shape runs at run-time
//     widths.
// The resample half is the same code in both: ancestors are bitwise the
// plain version's; states and log-likelihoods agree to rounding. Both
// designs take a float32 or, under mixed precision, a bfloat16 state (the
// element type T; propagate.cuh and tile_propagate.cuh give its law, the
// TPU kernel's); the walk reads float32 weights either way, so the
// ancestors do not depend on T.
//
// Bound on the card, per particle at B sweeps: bytes 2 s d + 12 (X[:, a]
// read, the state, ll and a written, s-byte states; the B + 1 weights
// come from L2); operations ceil((B + 2 d + chi-square rows) / 4) Philox
// calls of 40 integer multiplies, B + 1 exps and three special functions
// a normal on the special-function units, and 2 (2 d^2 + k d + k^2)
// float32 flops. At d = 2 the Philox multiplies bind, at d = 13, k = 1 the
// bytes; what the kernel reaches against them is in PERF.md.
#include "wide_propagate.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 128;
// Sweeps whose candidate weights a particle loads together (a multiple of
// 4: the accept rows of a chunk are whole Philox groups).
constexpr int kWalkChunk = 8;
static_assert(kWalkChunk % 4 == 0, "whole groups of accept rows");

// The window of a tile: its two (three) source tiles, in 32 bits.
struct Window {
  unsigned n;
  unsigned tile;
  unsigned ws;   // start of the contiguous pair
  unsigned ws2;  // start of the third tile
  unsigned len;  // num_window_tiles * tile

  // Global index of pre-rotation window position q in [0, len).
  __device__ __forceinline__ unsigned at(unsigned q) const {
    if (q < 2 * tile) {
      const unsigned g = ws + q;
      return g >= n ? g - n : g;
    }
    return ws2 + (q - 2 * tile);
  }

  __device__ __forceinline__ unsigned wrap(unsigned q) const {
    return q >= len ? q - len : q;
  }
};

// The block's tile (a block of `per_block` particles never straddles one:
// tile % per_block == 0): its draws (stream 1: the lane rotation r, row 0
// of lane 0, and the B sweep offsets, row 1 of lane sw) into s_r and s_db,
// and, by thread 0, its window into s_win. The caller synchronises.
struct BlockTile {
  unsigned ti;
  uint2 key;
};

__device__ __forceinline__ BlockTile block_tile(
    const int* __restrict__ s, const int* __restrict__ seed, unsigned n,
    unsigned tile, unsigned per_block, int num_sweeps, int num_window_tiles,
    int* s_db, int* s_r, Window* s_win) {
  const unsigned ti = blockIdx.x * per_block / tile;
  const uint2 key = cusmc::philox_key(seed, ti);
  const unsigned n_off = (num_window_tiles - 1) * tile / 128 + 1;
  if (threadIdx.x < static_cast<unsigned>(num_sweeps > 0 ? num_sweeps : 1)) {
    const uint4 c = cusmc::philox4x32_10(
        make_uint4(threadIdx.x, 0u, 1u, 0u), key);
    if (threadIdx.x == 0) *s_r = static_cast<int>(c.x & 127u);
    if (static_cast<int>(threadIdx.x) < num_sweeps) {
      s_db[threadIdx.x] = static_cast<int>(128 * ((c.y & 0x7FFFFFFFu) % n_off));
    }
  }
  if (threadIdx.x == 0) {
    const int nb = static_cast<int>(n / tile);
    int s0 = s[0] % nb;
    int s1 = s[1] % nb;
    s0 += s0 < 0 ? nb : 0;
    s1 += s1 < 0 ? nb : 0;
    Window w;
    w.n = n;
    w.tile = tile;
    w.ws = (ti + s0) % nb * tile;
    w.ws2 = (ti + s1) % nb * tile;
    w.len = num_window_tiles * tile;
    *s_win = w;
  }
  return {ti, key};
}

// The windowed Metropolis walks of P particles of one tile, at lanes
// `lane`: their ancestors `a`. The accept rows are rows 0 .. B - 1 of each
// particle's stream; `last_g` and `last` return the last group of them that
// was drawn (-1 when B = 0), which the noise rows that follow may share.
template <int P>
__device__ __forceinline__ void window_ancestors(
    const float* __restrict__ logw, const Window& win,
    const unsigned (&lane)[P], int num_sweeps, const int* s_db, int r,
    uint2 key, unsigned (&a)[P], int& last_g, uint4 (&last)[P]) {
  unsigned base[P];
  float lw_cur[P];
  float w_cur[P];
  int a_off[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    base[i] = lane[i] + r;
    lw_cur[i] = logw[win.at(win.wrap(base[i]))];
    w_cur[i] = 0.0f;
    a_off[i] = 0;
  }
  last_g = -1;
  for (int sw0 = 0; sw0 < num_sweeps || sw0 == 0; sw0 += kWalkChunk) {
    float lw[kWalkChunk][P];
#pragma unroll
    for (int j = 0; j < kWalkChunk; ++j) {
#pragma unroll
      for (int i = 0; i < P; ++i) lw[j][i] = 0.0f;
      if (sw0 + j < num_sweeps) {
        const unsigned db = s_db[sw0 + j];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          lw[j][i] = logw[win.at(win.wrap(base[i] + db))];
        }
      }
    }
    uint4 g[kWalkChunk / 4][P];
#pragma unroll
    for (int q = 0; q < kWalkChunk / 4; ++q) {
#pragma unroll
      for (int i = 0; i < P; ++i) g[q][i] = make_uint4(0u, 0u, 0u, 0u);
      if (sw0 + 4 * q < num_sweeps) {
        last_g = (sw0 >> 2) + q;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          g[q][i] = cusmc::philox4x32_10(
              make_uint4(lane[i], static_cast<uint32_t>(last_g), 0u, 0u),
              key);
          last[i] = g[q][i];
        }
      }
    }
    if (sw0 == 0) {
#pragma unroll
      for (int i = 0; i < P; ++i) w_cur[i] = expf(lw_cur[i]);
    }
#pragma unroll
    for (int j = 0; j < kWalkChunk; ++j) {
      if (sw0 + j < num_sweeps) {
        const int db = s_db[sw0 + j];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float w_cand = expf(lw[j][i]);
          const float u =
              cusmc::to_uniform(cusmc::word_of(g[j >> 2][i], j & 3));
          if (__fmul_rn(u, w_cur[i]) < w_cand) {
            w_cur[i] = w_cand;
            a_off[i] = db;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) a[i] = win.at(win.wrap(base[i] + a_off[i]));
}

// The "thread" design in bucket (DM, KM) (propagate.cuh), P particles a
// thread. A block holds kThreads * P particles, particle i of thread t at
// (block * P + i) * kThreads + t.
template <int DM, int KM, typename T>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ X, const float* __restrict__ logw,
                  const int* __restrict__ s, const int* __restrict__ seed,
                  cusmc::StepModelT<T> m, T* __restrict__ Xo,
                  float* __restrict__ ll, int* __restrict__ anc, unsigned n,
                  unsigned tile, int num_sweeps, int num_window_tiles) {
  constexpr int P = cusmc::bucket_particles<DM>(true);
  __shared__ cusmc::BucketModel<DM, KM> s_m;
  __shared__ int s_db[kMaxSweeps];
  __shared__ int s_r;
  __shared__ Window s_win;
  const BlockTile bt = block_tile(s, seed, n, tile, kThreads * P, num_sweeps,
                                  num_window_tiles, s_db, &s_r, &s_win);
  cusmc::stage_bucket(m, s_m);
  __syncthreads();
  unsigned p[P];
  unsigned lane[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    p[i] = (blockIdx.x * P + i) * kThreads + threadIdx.x;
    lane[i] = p[i] - bt.ti * tile;
  }
  unsigned a[P];
  int last_g;
  uint4 last[P];
#pragma unroll
  for (int i = 0; i < P; ++i) last[i] = make_uint4(0u, 0u, 0u, 0u);
  window_ancestors<P>(logw, s_win, lane, num_sweeps, s_db, s_r, bt.key, a,
                      last_g, last);
#pragma unroll
  for (int i = 0; i < P; ++i) anc[p[i]] = static_cast<int>(a[i]);
  float x[P][DM];
  cusmc::load_columns(X, n, a, m.d, x);
  cusmc::RowCursors<P> rows(bt.key, lane, 0u);
  if (last_g >= 0) rows.hold(last_g, last);
  cusmc::propagate_bucket(s_m, m, x, n, Xo, ll, p, rows, num_sweeps);
}

// The "tile" design: tile_propagate.cuh, d = k = D.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 3)
fused_step_tile_kernel(const T* __restrict__ X,
                       const float* __restrict__ logw,
                       const int* __restrict__ s,
                       const int* __restrict__ seed, cusmc::StepModelT<T> m,
                       T* __restrict__ Xo, float* __restrict__ ll,
                       int* __restrict__ anc, unsigned n, unsigned tile,
                       int num_sweeps, int num_window_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_db[kMaxSweeps];
  __shared__ int s_r;
  __shared__ Window s_win;
  const BlockTile bt = block_tile(s, seed, n, tile, kThreads, num_sweeps,
                                  num_window_tiles, s_db, &s_r, &s_win);
  __syncthreads();
  const unsigned p = blockIdx.x * kThreads + threadIdx.x;
  const unsigned lane[1] = {p - bt.ti * tile};
  unsigned a[1];
  int last_g;
  uint4 last[1] = {make_uint4(0u, 0u, 0u, 0u)};
  window_ancestors<1>(logw, s_win, lane, num_sweeps, s_db, s_r, bt.key, a,
                      last_g, last);
  anc[p] = static_cast<int>(a[0]);
  const cusmc::BitStream bs(bt.key, lane[0], 0u);
  cusmc::tile_propagate_reweight<D>(m, smem, X, n, a[0], Xo, ll, p, bs,
                                    num_sweeps);
}

// The "tile" design at the padded widths (DM, KM): wide_propagate.cuh.
template <int DM, int KM, typename T>
__global__ void __launch_bounds__(kThreads, DM > 64 ? 2 : DM > 32 ? 3 : 4)
fused_step_wide_kernel(const T* __restrict__ X,
                       const float* __restrict__ logw,
                       const int* __restrict__ s,
                       const int* __restrict__ seed, cusmc::StepModelT<T> m,
                       T* __restrict__ Xo, float* __restrict__ ll,
                       int* __restrict__ anc, unsigned n, unsigned tile,
                       int num_sweeps, int num_window_tiles) {
  static_assert(kThreads == 32 * cusmc::kWideWarps, "the panels' warps");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_db[kMaxSweeps];
  __shared__ int s_r;
  __shared__ Window s_win;
  const BlockTile bt = block_tile(s, seed, n, tile, kThreads, num_sweeps,
                                  num_window_tiles, s_db, &s_r, &s_win);
  __syncthreads();
  const unsigned p = blockIdx.x * kThreads + threadIdx.x;
  const unsigned lane[1] = {p - bt.ti * tile};
  unsigned a[1];
  int last_g;
  uint4 last[1] = {make_uint4(0u, 0u, 0u, 0u)};
  window_ancestors<1>(logw, s_win, lane, num_sweeps, s_db, s_r, bt.key, a,
                      last_g, last);
  anc[p] = static_cast<int>(a[0]);
  cusmc::RowCursors<1> rows(bt.key, lane, 0u);
  if (last_g >= 0) rows.hold(last_g, last);
  cusmc::wide_propagate_reweight<DM, KM>(m, smem, X, n, a[0], Xo, ll, p,
                                         rows, num_sweeps);
}

template <int DM, int KM, typename T>
int launch(const T* X, const float* logw, const int* s, const int* seed,
           const cusmc::StepModelT<T>& m, T* Xo, float* ll, int* anc,
           unsigned n, unsigned tile, int num_sweeps, int wt,
           cudaStream_t stream) {
  constexpr unsigned per_block =
      kThreads * cusmc::bucket_particles<DM>(true);
  if (m.d > DM || m.k > KM) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (per_block > kThreads) {
    if (tile % per_block != 0) {  // a block would straddle two tiles
      return launch<16, KM == 1 ? 1 : 16>(X, logw, s, seed, m, Xo, ll, anc, n,
                                          tile, num_sweeps, wt, stream);
    }
  }
  fused_step_kernel<DM, KM, T><<<n / per_block, kThreads, 0, stream>>>(
      X, logw, s, seed, m, Xo, ll, anc, n, tile, num_sweeps, wt);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_tile(const T* X, const float* logw, const int* s,
                const int* seed, const cusmc::StepModelT<T>& m, T* Xo,
                float* ll, int* anc, unsigned n, unsigned tile,
                int num_sweeps, int wt, cudaStream_t stream) {
  constexpr size_t bytes = cusmc::TileLayout<D, T>::bytes(kThreads / 32);
  static_assert(bytes <= 48 * 1024,
                "above 48 KB the launch needs cudaFuncSetAttribute");
  fused_step_tile_kernel<D, T><<<n / kThreads, kThreads, bytes, stream>>>(
      X, logw, s, seed, m, Xo, ll, anc, n, tile, num_sweeps, wt);
  return static_cast<int>(cudaGetLastError());
}

template <int DM, int KM, typename T>
int launch_wide(const T* X, const float* logw, const int* s,
                const int* seed, const cusmc::StepModelT<T>& m, T* Xo,
                float* ll, int* anc, unsigned n, unsigned tile,
                int num_sweeps, int wt, cudaStream_t stream) {
  constexpr size_t bytes = cusmc::WideLayout<DM, KM>::bytes(kThreads / 32);
  if (m.d > DM || m.k > KM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      fused_step_wide_kernel<DM, KM, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_step_wide_kernel<DM, KM, T><<<n / kThreads, kThreads, bytes, stream>>>(
      X, logw, s, seed, m, Xo, ll, anc, n, tile, num_sweeps, wt);
  return static_cast<int>(cudaGetLastError());
}

// One element type: the design that `tiled` names, in its compiled widths
// (dm, km): the "tile" design's exact kernel for d = k = dm = km in
// {16, 32}, else its padded widths; the "thread" design's width bucket.
template <typename T>
int launch_step(const T* X, const float* logw, const int* s, const int* seed,
                const cusmc::StepModelT<T>& m, T* Xo, float* ll, int* anc,
                unsigned n, unsigned tile, int num_sweeps, int wt,
                int tiled, int dm, int km, cudaStream_t st) {
#define CUSMC_WIDTHS(LAUNCH, DM, KM)                                      \
  if (dm == DM && km == KM)                                               \
    return LAUNCH<DM, KM>(X, logw, s, seed, m, Xo, ll, anc, n, tile,      \
                          num_sweeps, wt, st);
  if (tiled) {
    if (m.d == dm && m.k == km && dm == km) {
      if (dm == 16) {
        return launch_tile<16>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                               num_sweeps, wt, st);
      }
      if (dm == 32) {
        return launch_tile<32>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                               num_sweeps, wt, st);
      }
    }
    CUSMC_WIDTHS(launch_wide, 32, 16)
    CUSMC_WIDTHS(launch_wide, 32, 32)
    CUSMC_WIDTHS(launch_wide, 64, 16)
    CUSMC_WIDTHS(launch_wide, 64, 64)
    CUSMC_WIDTHS(launch_wide, 128, 16)
    CUSMC_WIDTHS(launch_wide, 128, 128)
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUSMC_WIDTHS(launch, 2, 1)
  CUSMC_WIDTHS(launch, 2, 2)
  CUSMC_WIDTHS(launch, 4, 1)
  CUSMC_WIDTHS(launch, 4, 4)
  CUSMC_WIDTHS(launch, 8, 1)
  CUSMC_WIDTHS(launch, 8, 8)
  CUSMC_WIDTHS(launch, 16, 1)
  CUSMC_WIDTHS(launch, 16, 16)
#undef CUSMC_WIDTHS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// X [d, n], G, Q [d, d] and F [k, d] (f32, or all bf16 when bf16 != 0; the
// bf16 tile design also needs G, Q and F 4-byte aligned), logw [n], y [k]
// and Li [k, k] (f32), all contiguous, s [2] and seed [2] int32 on the
// device -> Xo [d, n] of X's type, ll [n] f32, anc [n] int32. The caller
// checks n % tile == 0, tile % 128 == 0, n >= num_window_tiles * tile,
// d, k <= 128, num_sweeps <= 128, n < 2^31 and, for bf16, even d and X
// 4-byte aligned. noise: 0 MVN, 1 MVT; df_int 0 selects Marsaglia-Tsang.
// tiled: 1 takes the "tile" design, 0 the "thread" one, each in the
// compiled widths (dm, km) of ops/fused_step.py::step_widths (d <= dm,
// k <= km). cudaErrorInvalidValue for a shape or widths that are not
// compiled.
CUSMC_EXPORT int cusmc_fused_step(
    const void* X, const float* logw, const float* y, const void* G,
    const void* Q, const void* F, const float* Li, const int* s,
    const int* seed, void* Xo, float* ll, int* anc, long long n,
    long long tile, int d, int k, int num_sweeps, int num_window_tiles,
    int noise, int df_int, float df, float log_norm, int tiled, int dm,
    int km, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nu = static_cast<unsigned>(n);
  const unsigned tu = static_cast<unsigned>(tile);
  if (bf16) {
    using B = __nv_bfloat16;
    const cusmc::StepModelT<B> m{static_cast<const B*>(G),
                                 static_cast<const B*>(Q),
                                 static_cast<const B*>(F),
                                 Li, y, d, k, noise, df_int, df, log_norm};
    return launch_step<B>(static_cast<const B*>(X), logw, s, seed, m,
                          static_cast<B*>(Xo), ll, anc, nu, tu, num_sweeps,
                          num_window_tiles, tiled, dm, km, st);
  }
  const cusmc::StepModel m{static_cast<const float*>(G),
                           static_cast<const float*>(Q),
                           static_cast<const float*>(F),
                           Li, y, d, k, noise, df_int, df, log_norm};
  return launch_step<float>(static_cast<const float*>(X), logw, s, seed, m,
                            static_cast<float*>(Xo), ll, anc, nu, tu,
                            num_sweeps, num_window_tiles, tiled, dm, km, st);
}
