// Fused inverse-CDF filter step: systematic or stratified positions, the
// search, the gather, propagate and reweight in one pass.
//
// Replaces cusmc_tpu/ops/fused_cdf_step.py::_fused_cdf_kernel (behind
// fused_cdf_filter_step). Output slot g takes the position
//   p = fl(fl(g + u_g) * pscale),  pscale = fl(cdf[n-1] / n),
// with u_g = u (systematic) or the uniform of the slot's row 0 (stratified),
// and the ancestor a = #{j : cdf[j] <= p}, clipped to n - 1: the search of
// monotone_gather.cu, shared through common.cuh. Then X[:, a] is
// propagated and reweighted in registers (propagate.cuh). Random bits:
// Philox (philox.cuh), stream 0, one lane per slot of the `tile`-slot
// block: row 0 the stratified uniform, then the noise rows.
//
// The TPU kernel walks the cdf in DMA'd windows placed by group-bound
// tables (srows, wcnt, woff, grows) because Mosaic's dynamic gather spans
// one vreg. None of that is needed here: one thread per output slot
// binary-searches the cdf, which sits in L2 (4 MB at N = 2^20), and the
// sorted positions keep a warp's search paths together. The matrices are
// staged as in fused_step.cu.
//
// Bound on the card: at d = 2, the ~log2(N) dependent cdf loads per slot
// (L2 latency) and memory: 4 B of cdf, 4d B of state read, 4d + 8 B written
// per particle. At d = 32 the four matrix-vector products (4096 FMAs per
// particle at d = k = 32) and the Philox rounds bind.
#include "propagate.cuh"

namespace {

constexpr int kThreads = 128;

template <int D, int K>
__global__ void __launch_bounds__(kThreads)
fused_cdf_kernel(const float* __restrict__ cdf, const float* __restrict__ X,
                 const float* __restrict__ u, const int* __restrict__ seed,
                 cusmc::StepModel m, float* __restrict__ Xo,
                 float* __restrict__ ll, int* __restrict__ anc, long long n,
                 long long tile, int stratified, int staged) {
  extern __shared__ float smem[];
  m = cusmc::stage_model(m, smem, staged != 0);
  __syncthreads();
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long blk = p / tile;
  const long long lane = p - blk * tile;
  cusmc::BitStream bs(cusmc::philox_key(seed, blk),
                      static_cast<uint32_t>(lane), 0u);
  const float pscale = __fdiv_rn(cdf[n - 1], static_cast<float>(n));
  const float ug = stratified ? cusmc::to_uniform(bs.bits(0)) : u[0];
  const float pos =
      __fmul_rn(__fadd_rn(static_cast<float>(p), ug), pscale);
  const long long a = cusmc::upper_bound_clipped(cdf, n, pos);
  anc[p] = static_cast<int>(a);
  cusmc::propagate_reweight<D, K>(m, X, n, a, Xo, ll, p, bs, 1);
}

template <int D, int K>
int launch(const float* cdf, const float* X, const float* u, const int* seed,
           const cusmc::StepModel& m, float* Xo, float* ll, int* anc,
           long long n, long long tile, int stratified, cudaStream_t stream) {
  const size_t bytes = cusmc::model_bytes(m.d, m.k);
  const int staged = bytes <= cusmc::kStageBytes ? 1 : 0;
  const long long blocks = n / kThreads;
  fused_cdf_kernel<D, K><<<static_cast<unsigned>(blocks), kThreads,
                           staged ? bytes : 0, stream>>>(
      cdf, X, u, seed, m, Xo, ll, anc, n, tile, stratified, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cdf [n], X [d, n], y [k], G, Q [d, d], F [k, d], Li [k, k] (f32,
// contiguous), u [1] f32 and seed [2] int32 on the device -> Xo [d, n]
// f32, ll [n] f32, anc [n] int32. The caller checks n % tile == 0,
// tile % 1024 == 0, n <= 2^24 and d, k <= 128. mode: 0 systematic,
// 1 stratified; noise: 0 MVN, 1 MVT; df_int 0 selects Marsaglia-Tsang.
CUSMC_EXPORT int cusmc_fused_cdf_step(
    const float* cdf, const float* X, const float* y, const float* G,
    const float* Q, const float* F, const float* Li, const float* u,
    const int* seed, float* Xo, float* ll, int* anc, long long n,
    long long tile, int d, int k, int mode, int noise, int df_int, float df,
    float log_norm, void* stream) {
  const cusmc::StepModel m{G, Q, F, Li, y, d, k, noise, df_int, df, log_norm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d == k ? d : 0) {
    case 2:
      return launch<2, 2>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
    case 4:
      return launch<4, 4>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
    case 8:
      return launch<8, 8>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
    case 16:
      return launch<16, 16>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode,
                            st);
    case 32:
      return launch<32, 32>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode,
                            st);
    default:
      return launch<0, 0>(cdf, X, u, seed, m, Xo, ll, anc, n, tile, mode, st);
  }
}
