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
// a random gather is slow there. Here one thread per particle reads its
// candidates straight from global memory: the window is 2-3 tiles, so it
// sits in L2, and a warp's lanes read consecutive addresses. The block's
// tile id is the particle index over the tile (blocks of 128 threads never
// straddle a tile, as tile % 128 == 0).
//
// Two designs of the propagate-and-reweight half, chosen by the caller as a
// plain function of (d, k) (ops/fused_step.py::step_path):
//   - "thread" (d = k in {2, 4, 8} compiled, any other d or k at run
//     time): one thread per particle, the vectors in registers
//     (propagate.cuh). At d <= 8 the step is bound by Philox, expf and
//     memory, not by the products. The matrices go to shared memory when
//     they fit in 48 KB (d = k <= 55), else they are read through L1.
//   - "tile" (d = k in {16, 32}): each warp's 32 particles go through
//     the four matrix products as 3xTF32 tensor-core tiles over
//     shared-memory tiles (tile_propagate.cuh); the per-thread design
//     spent ~4600 issue slots a particle on FFMAs and their broadcast
//     loads and ran 8.6x its bound at d = 32 (PERF.md).
// The resample half is the same code in both: ancestors are bitwise the
// plain version's; states and log-likelihoods agree to rounding. Both
// designs take a float32 or, under mixed precision, a bfloat16 state (the
// element type T; propagate.cuh and tile_propagate.cuh give its law, the
// TPU kernel's); the walk reads float32 weights either way, so the
// ancestors do not depend on T.
//
// Bound on the card: at d = 2, memory: per particle it reads X[:, a] and
// B + 1 weights (L2), writes d states, ll and a (2 s d + 12 bytes of
// device traffic for s-byte states, counting each input once). At d = 32,
// the 2d^2 + 2k^2 FMAs of the four products (4096 at d = k = 32) and the
// Philox rounds bind.
#include "tile_propagate.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 128;

struct Window {
  long long n;
  long long tile;
  long long ws;   // start of the contiguous pair
  long long ws2;  // start of the third tile
  long long len;  // num_window_tiles * tile

  // Global index of pre-rotation window position q in [0, len).
  __device__ __forceinline__ long long at(long long q) const {
    if (q < 2 * tile) {
      const long long g = ws + q;
      return g >= n ? g - n : g;
    }
    return ws2 + (q - 2 * tile);
  }

  __device__ __forceinline__ long long wrap(long long q) const {
    return q >= len ? q - len : q;
  }
};

// Block-shared draws of tile ti: the lane rotation r and the B sweep
// offsets (stream 1), into s_r and s_db; the caller synchronises.
__device__ __forceinline__ void tile_draws(uint2 key, long long tile,
                                           int num_sweeps,
                                           int num_window_tiles, int* s_db,
                                           int* s_r) {
  const int n_off = static_cast<int>((num_window_tiles - 1) * tile / 128 + 1);
  if (threadIdx.x < (num_sweeps > 0 ? num_sweeps : 1)) {
    const uint4 c = cusmc::philox4x32_10(
        make_uint4(threadIdx.x, 0u, 1u, 0u), key);
    if (threadIdx.x == 0) *s_r = static_cast<int>(c.x & 127u);
    if (static_cast<int>(threadIdx.x) < num_sweeps) {
      s_db[threadIdx.x] =
          128 * static_cast<int>((c.y & 0x7FFFFFFFu) %
                                 static_cast<uint32_t>(n_off));
    }
  }
}

// The window of tile ti: its two (three) source tiles.
__device__ __forceinline__ Window make_window(const int* __restrict__ s,
                                              long long n, long long tile,
                                              long long ti,
                                              int num_window_tiles) {
  const long long nb = n / tile;
  long long s0 = s[0] % nb;
  long long s1 = s[1] % nb;
  s0 += s0 < 0 ? nb : 0;
  s1 += s1 < 0 ? nb : 0;
  Window win;
  win.n = n;
  win.tile = tile;
  win.ws = ((ti + s0) % nb) * tile;
  win.ws2 = ((ti + s1) % nb) * tile;
  win.len = num_window_tiles * tile;
  return win;
}

// The windowed Metropolis walk of the particle at `lane` of its tile: its
// ancestor. Leaves bs after the B accept rows.
__device__ __forceinline__ long long window_ancestor(
    const float* __restrict__ logw, const Window& win, long long lane,
    int num_sweeps, const int* s_db, int r, cusmc::BitStream& bs) {
  const long long base = lane + r;
  float w_cur = expf(logw[win.at(win.wrap(base))]);
  int a_off = 0;
  for (int sw = 0; sw < num_sweeps; ++sw) {
    const int db = s_db[sw];
    const float w_cand = expf(logw[win.at(win.wrap(base + db))]);
    const float u = cusmc::to_uniform(bs.bits(sw));
    if (__fmul_rn(u, w_cur) < w_cand) {
      w_cur = w_cand;
      a_off = db;
    }
  }
  return win.at(win.wrap(base + a_off));
}

// The "thread" design: propagate.cuh, one particle per thread.
template <int D, int K, typename T>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ X, const float* __restrict__ logw,
                  const int* __restrict__ s, const int* __restrict__ seed,
                  cusmc::StepModelT<T> m, T* __restrict__ Xo,
                  float* __restrict__ ll, int* __restrict__ anc, long long n,
                  long long tile, int num_sweeps, int num_window_tiles,
                  int staged) {
  extern __shared__ float smem[];
  __shared__ int s_db[kMaxSweeps];
  __shared__ int s_r;
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long ti = p / tile;
  const long long lane = p - ti * tile;
  const uint2 key = cusmc::philox_key(seed, ti);
  tile_draws(key, tile, num_sweeps, num_window_tiles, s_db, &s_r);
  m = cusmc::stage_model(m, smem, staged != 0);
  __syncthreads();
  cusmc::BitStream bs(key, static_cast<uint32_t>(lane), 0u);
  const Window win = make_window(s, n, tile, ti, num_window_tiles);
  const long long a =
      window_ancestor(logw, win, lane, num_sweeps, s_db, s_r, bs);
  anc[p] = static_cast<int>(a);
  cusmc::propagate_reweight<D, K>(m, X, n, a, Xo, ll, p, bs, num_sweeps);
}

// The "tile" design: tile_propagate.cuh, d = k = D. The tile id, its key
// and its window are the block's (tile % 128 == 0), formed once.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 3)
fused_step_tile_kernel(const T* __restrict__ X,
                       const float* __restrict__ logw,
                       const int* __restrict__ s,
                       const int* __restrict__ seed, cusmc::StepModelT<T> m,
                       T* __restrict__ Xo, float* __restrict__ ll,
                       int* __restrict__ anc, long long n, long long tile,
                       int num_sweeps, int num_window_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_db[kMaxSweeps];
  __shared__ int s_r;
  __shared__ Window s_win;
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  // n < 2^31 (int32 ancestors): a 32-bit division.
  const long long ti =
      static_cast<unsigned>(p0) / static_cast<unsigned>(tile);
  const uint2 key = cusmc::philox_key(seed, ti);
  tile_draws(key, tile, num_sweeps, num_window_tiles, s_db, &s_r);
  if (threadIdx.x == 0) s_win = make_window(s, n, tile, ti, num_window_tiles);
  __syncthreads();
  const long long p = p0 + threadIdx.x;
  const long long lane = p - ti * tile;
  cusmc::BitStream bs(key, static_cast<uint32_t>(lane), 0u);
  const long long a =
      window_ancestor(logw, s_win, lane, num_sweeps, s_db, s_r, bs);
  anc[p] = static_cast<int>(a);
  cusmc::tile_propagate_reweight<D>(m, smem, X, n, a, Xo, ll, p, bs,
                                    num_sweeps);
}

template <int D, int K, typename T>
int launch(const T* X, const float* logw, const int* s, const int* seed,
           const cusmc::StepModelT<T>& m, T* Xo, float* ll, int* anc,
           long long n, long long tile, int num_sweeps, int wt,
           cudaStream_t stream) {
  const size_t bytes = cusmc::model_bytes<T>(m.d, m.k);
  const int staged = bytes <= cusmc::kStageBytes ? 1 : 0;
  const long long blocks = n / kThreads;
  fused_step_kernel<D, K, T><<<static_cast<unsigned>(blocks), kThreads,
                               staged ? bytes : 0, stream>>>(
      X, logw, s, seed, m, Xo, ll, anc, n, tile, num_sweeps, wt, staged);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_tile(const T* X, const float* logw, const int* s,
                const int* seed, const cusmc::StepModelT<T>& m, T* Xo,
                float* ll, int* anc, long long n, long long tile,
                int num_sweeps, int wt, cudaStream_t stream) {
  constexpr size_t bytes = cusmc::TileLayout<D, T>::bytes(kThreads / 32);
  static_assert(bytes <= cusmc::kStageBytes,
                "above 48 KB the launch needs cudaFuncSetAttribute");
  const long long blocks = n / kThreads;
  fused_step_tile_kernel<D, T><<<static_cast<unsigned>(blocks), kThreads,
                                 bytes, stream>>>(X, logw, s, seed, m, Xo, ll,
                                                  anc, n, tile, num_sweeps,
                                                  wt);
  return static_cast<int>(cudaGetLastError());
}

// One element type: the design that `tiled` names, at the compiled
// widths.
template <typename T>
int launch_step(const T* X, const float* logw, const int* s, const int* seed,
                const cusmc::StepModelT<T>& m, T* Xo, float* ll, int* anc,
                long long n, long long tile, int num_sweeps, int wt,
                int tiled, cudaStream_t st) {
  const int d = m.d;
  if (tiled) {
    switch (d == m.k ? d : 0) {
      case 16:
        return launch_tile<16>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                               num_sweeps, wt, st);
      case 32:
        return launch_tile<32>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                               num_sweeps, wt, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (d == m.k ? d : 0) {
    case 2:
      return launch<2, 2>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                          num_sweeps, wt, st);
    case 4:
      return launch<4, 4>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                          num_sweeps, wt, st);
    case 8:
      return launch<8, 8>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                          num_sweeps, wt, st);
    default:
      return launch<0, 0>(X, logw, s, seed, m, Xo, ll, anc, n, tile,
                          num_sweeps, wt, st);
  }
}

}  // namespace

// X [d, n], G, Q [d, d] and F [k, d] (f32, or all bf16 when bf16 != 0; the
// bf16 tile design also needs G, Q and F 4-byte aligned), logw [n], y [k]
// and Li [k, k] (f32), all contiguous, s [2] and seed [2] int32 on the
// device -> Xo [d, n] of X's type, ll [n] f32, anc [n] int32. The caller
// checks n % tile == 0, tile % 128 == 0, n >= num_window_tiles * tile,
// d, k <= 128, num_sweeps <= 128 and, for bf16, even d. noise: 0 MVN,
// 1 MVT; df_int 0 selects Marsaglia-Tsang. tiled: 1 takes the "tile"
// design, which needs d = k in {16, 32} (cudaErrorInvalidValue
// otherwise), 0 the "thread" one.
CUSMC_EXPORT int cusmc_fused_step(
    const void* X, const float* logw, const float* y, const void* G,
    const void* Q, const void* F, const float* Li, const int* s,
    const int* seed, void* Xo, float* ll, int* anc, long long n,
    long long tile, int d, int k, int num_sweeps, int num_window_tiles,
    int noise, int df_int, float df, float log_norm, int tiled, int bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = __nv_bfloat16;
    const cusmc::StepModelT<B> m{static_cast<const B*>(G),
                                 static_cast<const B*>(Q),
                                 static_cast<const B*>(F),
                                 Li, y, d, k, noise, df_int, df, log_norm};
    return launch_step<B>(static_cast<const B*>(X), logw, s, seed, m,
                          static_cast<B*>(Xo), ll, anc, n, tile, num_sweeps,
                          num_window_tiles, tiled, st);
  }
  const cusmc::StepModel m{static_cast<const float*>(G),
                           static_cast<const float*>(Q),
                           static_cast<const float*>(F),
                           Li, y, d, k, noise, df_int, df, log_norm};
  return launch_step<float>(static_cast<const float*>(X), logw, s, seed, m,
                            static_cast<float*>(Xo), ll, anc, n, tile,
                            num_sweeps, num_window_tiles, tiled, st);
}
