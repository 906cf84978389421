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
//   - "thread" (d = k in {2, 4, 8} compiled, any other d or k at run
//     time): one thread per particle, the vectors in registers
//     (propagate.cuh). The matrices go to shared memory when they fit
//     beside the window in 48 KB, else they are read through L1.
//   - "tile" (d = k in {16, 32}): each warp's 32 slots go through the four
//     matrix products as 3xTF32 tensor-core tiles (tile_propagate.cuh);
//     the window is laid over the tiles' shared memory, which the search
//     is done with before the tiles are written.
// The ancestors are bitwise the plain version's in both; states and
// log-likelihoods agree to rounding.
//
// Bound on the card: at d = 2, memory: 4 B of cdf, 4d B of state read,
// 4d + 8 B written per particle; the Philox rounds and expf keep it over
// that. At d = 32 the four products (4096 multiply-adds per particle at
// d = k = 32) and the Box-Muller draws.
#include "tile_propagate.cuh"

namespace {

// Slots a block and the block's shared cdf window (floats): -D defines
// from ops/kernels.py.
constexpr int kThreads = CUSMC_CDF_BLOCK;
constexpr int kWindow = CUSMC_CDF_WINDOW;
static_assert(kThreads % 32 == 0 && kThreads >= 64 && 1024 % kThreads == 0,
              "whole warps, two to search, and whole blocks in a 1024 tile");
constexpr size_t kWindowBytes = sizeof(float) * kWindow;

// Slot p's position.
__device__ __forceinline__ float slot_position(const float* __restrict__ cdf,
                                               const float* __restrict__ u,
                                               long long n, long long p,
                                               int stratified,
                                               cusmc::BitStream& bs) {
  const float pscale = __fdiv_rn(cdf[n - 1], static_cast<float>(n));
  const float ug = stratified ? cusmc::to_uniform(bs.bits(0)) : u[0];
  return __fmul_rn(__fadd_rn(static_cast<float>(p), ug), pscale);
}

// The ancestor of each slot of the block, through the block's window.
// Shared memory: `win` kWindow floats, `s_pos` 2 floats, `s_range` 2
// counts. Synchronises the block.
__device__ __forceinline__ long long block_ancestor(
    const float* __restrict__ cdf, long long n, float pos, float* win,
    float* s_pos, long long* s_range) {
  if (threadIdx.x == 0) s_pos[0] = pos;
  if (threadIdx.x == kThreads - 1) s_pos[1] = pos;
  __syncthreads();
  return cusmc::block_cdf_window<kWindow>(cdf, n, s_pos[0], s_pos[1], win,
                                          s_range)
      .search(pos);
}

// The "thread" design.
template <int D, int K>
__global__ void __launch_bounds__(kThreads)
fused_cdf_kernel(const float* __restrict__ cdf, const float* __restrict__ X,
                 const float* __restrict__ u, const int* __restrict__ seed,
                 cusmc::StepModel m, float* __restrict__ Xo,
                 float* __restrict__ ll, int* __restrict__ anc, long long n,
                 long long tile, int stratified, int staged) {
  extern __shared__ float smem[];
  __shared__ float s_win[kWindow];
  __shared__ float s_pos[2];
  __shared__ long long s_range[2];
  m = cusmc::stage_model(m, smem, staged != 0);  // block_ancestor syncs
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long blk = p / tile;
  cusmc::BitStream bs(cusmc::philox_key(seed, blk),
                      static_cast<uint32_t>(p - blk * tile), 0u);
  const float pos = slot_position(cdf, u, n, p, stratified, bs);
  const long long a = block_ancestor(cdf, n, pos, s_win, s_pos, s_range);
  anc[p] = static_cast<int>(a);
  cusmc::propagate_reweight<D, K>(m, X, n, a, Xo, ll, p, bs, 1);
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
  const float pos = slot_position(cdf, u, n, p, stratified, bs);
  const long long a = block_ancestor(cdf, n, pos, smem, s_pos, s_range);
  anc[p] = static_cast<int>(a);
  __syncthreads();  // every read of the window is done: the tiles take it
  cusmc::tile_propagate_reweight<D>(m, smem, X, n, a, Xo, ll, p, bs, 1);
}

template <int D, int K>
int launch(const float* cdf, const float* X, const float* u, const int* seed,
           const cusmc::StepModel& m, float* Xo, float* ll, int* anc,
           long long n, long long tile, int stratified, cudaStream_t stream) {
  const size_t bytes = cusmc::model_bytes(m.d, m.k);
  const int staged = bytes + kWindowBytes <= cusmc::kStageBytes ? 1 : 0;
  const long long blocks = n / kThreads;
  fused_cdf_kernel<D, K><<<static_cast<unsigned>(blocks), kThreads,
                           staged ? bytes : 0, stream>>>(
      cdf, X, u, seed, m, Xo, ll, anc, n, tile, stratified, staged);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tile(const float* cdf, const float* X, const float* u,
                const int* seed, const cusmc::StepModel& m, float* Xo,
                float* ll, int* anc, long long n, long long tile,
                int stratified, cudaStream_t stream) {
  constexpr size_t bytes = cusmc::TileLayout<D>::bytes(kThreads / 32);
  static_assert(bytes <= cusmc::kStageBytes,
                "above 48 KB the launch needs cudaFuncSetAttribute");
  static_assert(kWindowBytes <= bytes, "the window lies over the tiles");
  const long long blocks = n / kThreads;
  fused_cdf_tile_kernel<D><<<static_cast<unsigned>(blocks), kThreads, bytes,
                             stream>>>(cdf, X, u, seed, m, Xo, ll, anc, n,
                                       tile, stratified);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cdf [n], X [d, n], y [k], G, Q [d, d], F [k, d], Li [k, k] (f32,
// contiguous), u [1] f32 and seed [2] int32 on the device -> Xo [d, n]
// f32, ll [n] f32, anc [n] int32. The caller checks n % tile == 0,
// tile % 1024 == 0, n <= 2^24 and d, k <= 128. mode: 0 systematic,
// 1 stratified; noise: 0 MVN, 1 MVT; df_int 0 selects Marsaglia-Tsang.
// tiled: 1 takes the "tile" design, which needs d = k in {16, 32}
// (cudaErrorInvalidValue otherwise), 0 the "thread" one.
CUSMC_EXPORT int cusmc_fused_cdf_step(
    const float* cdf, const float* X, const float* y, const float* G,
    const float* Q, const float* F, const float* Li, const float* u,
    const int* seed, float* Xo, float* ll, int* anc, long long n,
    long long tile, int d, int k, int mode, int noise, int df_int, float df,
    float log_norm, int tiled, void* stream) {
  const cusmc::StepModel m{G, Q, F, Li, y, d, k, noise, df_int, df, log_norm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiled) {
    switch (d == k ? d : 0) {
      case 16:
        return launch_tile<16>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode,
                               st);
      case 32:
        return launch_tile<32>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode,
                               st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (d == k ? d : 0) {
    case 2:
      return launch<2, 2>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
    case 4:
      return launch<4, 4>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
    case 8:
      return launch<8, 8>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
    default:
      return launch<0, 0>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
  }
}
