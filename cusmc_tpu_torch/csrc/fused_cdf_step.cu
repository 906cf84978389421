// Fused inverse-CDF filter step: systematic or stratified positions, the
// search, the gather, propagate and reweight in one pass.
//
// Replaces cusmc_tpu/ops/fused_cdf_step.py::_fused_cdf_kernel (behind
// fused_cdf_filter_step). Output slot g takes the position
//   p = fl(fl(g + u_g) * pscale),  pscale = fl(cdf[n-1] / n),
// with u_g = u (systematic) or the uniform of the slot's row 0 (stratified),
// and the ancestor a = #{j : cdf[j] <= p}, clipped to n - 1. Then X[:, a]
// is propagated and reweighted (one of the two designs below). Random bits:
// Philox (philox.cuh), stream 0, one lane per slot of the `tile`-slot
// block: row 0 the stratified uniform, then the noise rows.
//
// The TPU kernel walks the cdf in DMA'd windows placed by group-bound
// tables (srows, wcnt, woff, grows) because Mosaic's dynamic gather spans
// one vreg. None of that is needed here. The positions rise with the slot
// (g + u_g < g + 1 <= g + 1 + u_{g+1}, and rounding keeps the order), so a
// block's slots lie between its first and its last slot's position:
// the block-window search of common.cuh (CdfWindow) finds the stretch of
// the cdf between them with two warps and 32 parallel loads a round, copies
// it into shared memory, and each slot searches it there, in place of
// ~log2(N) dependent L2 loads a slot.
//
// Two designs of the propagate-and-reweight half, chosen by the caller as a
// plain function of (d, k) (ops/fused_step.py::step_path, the rule of
// fused_step.cu):
//   - "thread" (d and k up to 16 but d = k = 16; propagate.cuh): in the
//     compiled width bucket (DM, KM) of ops/fused_step.py::step_widths,
//     two slots a thread (the block's 256 slots search one window, two
//     queries a thread). The block's Philox key and pscale are formed once,
//     in 32 bits; the ancestors' columns fly while the noise is drawn.
//   - "tile" (d = k in {16, 32}, and every shape wider than 16): each
//     warp's 32 slots go through the four matrix products as 3xTF32
//     tensor-core tiles, at d = k in {16, 32} (tile_propagate.cuh) or at
//     the padded widths of ops/fused_step.py::step_widths
//     (wide_propagate.cuh); the window is laid over the tiles' shared
//     memory, which the search is done with before the tiles are written.
// The ancestors are bitwise the plain version's in both; states and
// log-likelihoods agree to rounding.
//
// Bound on the card, per particle: bytes 8 d + 12 (4 B of cdf, 4 d of
// state read, 4 d + 8 written); operations ceil((1 + 2 d + chi-square
// rows) / 4) Philox calls of 40 integer multiplies, three special
// functions a normal, and 2 (2 d^2 + k d + k^2) float32 flops. At d = 2
// and at d = 13, k = 1 the bytes bind; at d = 32 the four products (4096
// multiply-adds per particle at d = k = 32) and the Box-Muller draws.
#include "wide_propagate.cuh"

namespace {

// Slots a block and the block's shared cdf window (floats): -D defines
// from ops/kernels.py.
constexpr int kThreads = CUSMC_CDF_BLOCK;
constexpr int kWindow = CUSMC_CDF_WINDOW;
static_assert(kThreads % 32 == 0 && kThreads >= 64 && 1024 % kThreads == 0,
              "whole warps, two to search, and whole blocks in a 1024 tile");
constexpr size_t kWindowBytes = sizeof(float) * kWindow;

// The positions of slots p[i]: fl(fl(p + u_g) pscale), u_g the systematic
// u or the stratified uniform of the slot's row 0 (cursor one of `rows`).
template <int P>
__device__ __forceinline__ void slot_positions(const unsigned (&p)[P],
                                               const float* __restrict__ u,
                                               int stratified, float pscale,
                                               cusmc::RowCursors<P>& rows,
                                               float (&pos)[P]) {
  float ug[P];
  if (stratified) {
    uint32_t w[P];
    rows.first(0, w);
#pragma unroll
    for (int i = 0; i < P; ++i) ug[i] = cusmc::to_uniform(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) ug[i] = u[0];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    pos[i] = __fmul_rn(__fadd_rn(static_cast<float>(p[i]), ug[i]), pscale);
  }
}

// Slot p's position, one slot a thread drawing its row 0 from `bs`.
__device__ __forceinline__ float slot_position(const float* __restrict__ cdf,
                                               const float* __restrict__ u,
                                               long long n, long long p,
                                               int stratified,
                                               cusmc::BitStream& bs) {
  const float pscale = __fdiv_rn(cdf[n - 1], static_cast<float>(n));
  const float ug = stratified ? cusmc::to_uniform(bs.bits(0)) : u[0];
  return __fmul_rn(__fadd_rn(static_cast<float>(p), ug), pscale);
}

// The ancestors of the block's slots, P a thread (their positions rise
// with the slot: thread 0's first and the last thread's last bound the
// block's), through the block's window. Shared memory: `win` kWindow
// floats, `s_pos` 2 floats, `s_range` 2 counts. Synchronises the block.
template <int P>
__device__ __forceinline__ void block_ancestors(
    const float* __restrict__ cdf, long long n, const float (&pos)[P],
    float* win, float* s_pos, long long* s_range, long long (&c)[P]) {
  if (threadIdx.x == 0) s_pos[0] = pos[0];
  if (threadIdx.x == kThreads - 1) s_pos[1] = pos[P - 1];
  __syncthreads();
  cusmc::block_cdf_window<kWindow>(cdf, n, s_pos[0], s_pos[1], win, s_range)
      .search<P>(pos, c);
}

// The "thread" design in bucket (DM, KM) (propagate.cuh), P slots a
// thread. A block holds kThreads * P slots, slot i of thread t at
// (block * P + i) * kThreads + t; pscale and the Philox key are the
// block's (tile % 1024 == 0).
template <int DM, int KM>
__global__ void __launch_bounds__(kThreads)
fused_cdf_kernel(const float* __restrict__ cdf, const float* __restrict__ X,
                 const float* __restrict__ u, const int* __restrict__ seed,
                 cusmc::StepModel m, float* __restrict__ Xo,
                 float* __restrict__ ll, int* __restrict__ anc, unsigned n,
                 unsigned tile, int stratified) {
  constexpr int P = cusmc::bucket_particles<DM>(false);
  __shared__ cusmc::BucketModel<DM, KM> s_m;
  __shared__ float s_win[kWindow];
  __shared__ float s_pos[2];
  __shared__ long long s_range[2];
  __shared__ float s_pscale;
  cusmc::stage_bucket(m, s_m);
  if (threadIdx.x == 0) {
    s_pscale = __fdiv_rn(cdf[n - 1], static_cast<float>(n));
  }
  __syncthreads();
  const unsigned blk = blockIdx.x * (kThreads * P) / tile;
  unsigned p[P];
  unsigned lane[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    p[i] = (blockIdx.x * P + i) * kThreads + threadIdx.x;
    lane[i] = p[i] - blk * tile;
  }
  const uint2 key = cusmc::philox_key(seed, blk);
  cusmc::RowCursors<P> rows(key, lane, 0u);
  float pos[P];
  slot_positions(p, u, stratified, s_pscale, rows, pos);
  long long c[P];
  block_ancestors<P>(cdf, n, pos, s_win, s_pos, s_range, c);
  unsigned a[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    a[i] = static_cast<unsigned>(c[i]);
    anc[p[i]] = static_cast<int>(a[i]);
  }
  float x[P][DM];
  cusmc::load_columns(X, n, a, m.d, x);
  cusmc::propagate_bucket(s_m, m, x, n, Xo, ll, p, rows, 1);
}

// The "tile" design, d = k = D. The block's slots share one Philox block
// (tile % 1024 == 0).
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
fused_cdf_tile_kernel(const float* __restrict__ cdf,
                      const float* __restrict__ X,
                      const float* __restrict__ u,
                      const int* __restrict__ seed, cusmc::StepModel m,
                      float* __restrict__ Xo, float* __restrict__ ll,
                      int* __restrict__ anc, long long n, long long tile,
                      int stratified) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_pos[2];
  __shared__ long long s_range[2];
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  // n <= 2^24: a 32-bit division.
  const long long blk =
      static_cast<unsigned>(p0) / static_cast<unsigned>(tile);
  const long long p = p0 + threadIdx.x;
  cusmc::BitStream bs(cusmc::philox_key(seed, blk),
                      static_cast<uint32_t>(p - blk * tile), 0u);
  const float pos[1] = {slot_position(cdf, u, n, p, stratified, bs)};
  long long a[1];
  block_ancestors<1>(cdf, n, pos, smem, s_pos, s_range, a);
  anc[p] = static_cast<int>(a[0]);
  __syncthreads();  // every read of the window is done: the tiles take it
  cusmc::tile_propagate_reweight<D>(m, smem, X, n, a[0], Xo, ll, p, bs, 1);
}

// The "tile" design at the padded widths (DM, KM): wide_propagate.cuh.
// The block's slots share one Philox block (tile % 1024 == 0).
template <int DM, int KM>
__global__ void __launch_bounds__(kThreads, DM > 64 ? 2 : DM > 32 ? 3 : 4)
fused_cdf_wide_kernel(const float* __restrict__ cdf,
                      const float* __restrict__ X,
                      const float* __restrict__ u,
                      const int* __restrict__ seed, cusmc::StepModel m,
                      float* __restrict__ Xo, float* __restrict__ ll,
                      int* __restrict__ anc, unsigned n, unsigned tile,
                      int stratified) {
  static_assert(kThreads == 32 * cusmc::kWideWarps, "the panels' warps");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_pos[2];
  __shared__ long long s_range[2];
  __shared__ float s_pscale;
  if (threadIdx.x == 0) {
    s_pscale = __fdiv_rn(cdf[n - 1], static_cast<float>(n));
  }
  __syncthreads();
  const unsigned blk = blockIdx.x * kThreads / tile;
  const unsigned p[1] = {blockIdx.x * kThreads + threadIdx.x};
  const unsigned lane[1] = {p[0] - blk * tile};
  cusmc::RowCursors<1> rows(cusmc::philox_key(seed, blk), lane, 0u);
  float pos[1];
  slot_positions(p, u, stratified, s_pscale, rows, pos);
  long long c[1];
  block_ancestors<1>(cdf, n, pos, smem, s_pos, s_range, c);
  anc[p[0]] = static_cast<int>(c[0]);
  __syncthreads();  // every read of the window is done: the tiles take it
  cusmc::wide_propagate_reweight<DM, KM>(m, smem, X, n,
                                         static_cast<unsigned>(c[0]), Xo, ll,
                                         p[0], rows, 1);
}

template <int DM, int KM>
int launch(const float* cdf, const float* X, const float* u, const int* seed,
           const cusmc::StepModel& m, float* Xo, float* ll, int* anc,
           unsigned n, unsigned tile, int stratified, cudaStream_t stream) {
  // kThreads * P divides 1024, and so n and the tile.
  constexpr unsigned per_block =
      kThreads * cusmc::bucket_particles<DM>(false);
  static_assert(1024 % per_block == 0, "whole blocks in a 1024 tile");
  if (m.d > DM || m.k > KM) return static_cast<int>(cudaErrorInvalidValue);
  fused_cdf_kernel<DM, KM><<<n / per_block, kThreads, 0, stream>>>(
      cdf, X, u, seed, m, Xo, ll, anc, n, tile, stratified);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tile(const float* cdf, const float* X, const float* u,
                const int* seed, const cusmc::StepModel& m, float* Xo,
                float* ll, int* anc, unsigned n, unsigned tile,
                int stratified, cudaStream_t stream) {
  constexpr size_t bytes = cusmc::TileLayout<D>::bytes(kThreads / 32);
  static_assert(bytes <= 48 * 1024,
                "above 48 KB the launch needs cudaFuncSetAttribute");
  static_assert(kWindowBytes <= bytes, "the window lies over the tiles");
  fused_cdf_tile_kernel<D><<<n / kThreads, kThreads, bytes, stream>>>(
      cdf, X, u, seed, m, Xo, ll, anc, n, tile, stratified);
  return static_cast<int>(cudaGetLastError());
}

template <int DM, int KM>
int launch_wide(const float* cdf, const float* X, const float* u,
                const int* seed, const cusmc::StepModel& m, float* Xo,
                float* ll, int* anc, unsigned n, unsigned tile,
                int stratified, cudaStream_t stream) {
  constexpr size_t bytes = cusmc::WideLayout<DM, KM>::bytes(kThreads / 32);
  static_assert(kWindowBytes <= bytes, "the window lies over the tiles");
  if (m.d > DM || m.k > KM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      fused_cdf_wide_kernel<DM, KM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_cdf_wide_kernel<DM, KM><<<n / kThreads, kThreads, bytes, stream>>>(
      cdf, X, u, seed, m, Xo, ll, anc, n, tile, stratified);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cdf [n], X [d, n], y [k], G, Q [d, d], F [k, d], Li [k, k] (f32,
// contiguous), u [1] f32 and seed [2] int32 on the device -> Xo [d, n]
// f32, ll [n] f32, anc [n] int32. The caller checks n % tile == 0,
// tile % 1024 == 0, n <= 2^24 and d, k <= 128. mode: 0 systematic,
// 1 stratified; noise: 0 MVN, 1 MVT; df_int 0 selects Marsaglia-Tsang.
// tiled: 1 takes the "tile" design, 0 the "thread" one, each in the
// compiled widths (dm, km) of ops/fused_step.py::step_widths (d <= dm,
// k <= km). cudaErrorInvalidValue for a shape or widths that are not
// compiled.
CUSMC_EXPORT int cusmc_fused_cdf_step(
    const float* cdf, const float* X, const float* y, const float* G,
    const float* Q, const float* F, const float* Li, const float* u,
    const int* seed, float* Xo, float* ll, int* anc, long long n,
    long long tile, int d, int k, int mode, int noise, int df_int, float df,
    float log_norm, int tiled, int dm, int km, void* stream) {
  const cusmc::StepModel m{G, Q, F, Li, y, d, k, noise, df_int, df, log_norm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nu = static_cast<unsigned>(n);
  const unsigned tu = static_cast<unsigned>(tile);
#define CUSMC_WIDTHS(LAUNCH, DM, KM)                                      \
  if (dm == DM && km == KM)                                               \
    return LAUNCH<DM, KM>(cdf, X, u, seed, m, Xo, ll, anc, nu, tu, mode, st);
  if (tiled) {
    if (d == dm && k == km && dm == km) {
      if (dm == 16) {
        return launch_tile<16>(cdf, X, u, seed, m, Xo, ll, anc, nu, tu, mode,
                               st);
      }
      if (dm == 32) {
        return launch_tile<32>(cdf, X, u, seed, m, Xo, ll, anc, nu, tu, mode,
                               st);
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
