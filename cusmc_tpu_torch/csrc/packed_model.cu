// The composed DLM step's propagate and log-likelihood, a particle's
// products and the elementwise chain around them in registers: the two
// kernels behind DLM.propagate_packed and DLM.observation_logpdf_packed
// for a float32 state with d, k <= 16 (ops/packed_model.py).
//
// They replace no TPU kernel. The JAX package leaves this work to XLA
// (cusmc_tpu/models/dlm.py, the packed methods over
// cusmc_tpu/ops/packed.py), whose fusion keeps the [d, N] intermediates
// out of memory. Eager PyTorch on the card has no such fusion: it ran each
// product as cuBLAS GEMM tiles of 128 x 32 outputs (for M = 2 or 13 and
// K = 2 or 13, most of each tile padding) and some twenty elementwise and
// reduction kernels around them, each writing and reading a [d, N] or [N]
// intermediate.
//
//   packed_propagate_kernel: X_new = G x + (Q z) s, s = sqrt(df / g)
//     (MVT) or 1 (MVN), from the composed path's own draws in memory
//     (DLM.packed_noise): z [d, N] and, for an integer df, the df / 2
//     uniform rows and the normal row of chi2_integer_df, whose transform
//     runs here (ops/random.py::chi2_integer_df_transform: the product of
//     the uniforms clamped at the least normal float, -2 log of it, plus
//     the normal's square), each operation rounded once in the plain
//     version's order. For another df the caller passes g itself, from
//     the plain chi2_transform: its four Marsaglia-Tsang rounds stay in
//     PyTorch.
//   packed_loglik_kernel: ll = log p(y | x) through Li = V^-1/2, MVN or
//     MVT (propagate.cuh's reweight); log_norm is read on the device.
//
// Design: the fused kernels' "thread" design (propagate.cuh). The
// matrices are staged once a block in shared memory in the width bucket
// (DM, KM) of ops/fused_step.py::step_widths, DM in {2, 4, 8, 16} and KM
// in {1, DM}, with loops unrolled to it and guarded by the run-time d and
// k, and the same FMA chains (propagate_rows, quad_forms). A thread holds
// P particles (4 at DM <= 4, 2 at 8, 1 at 16), neighbouring threads on
// neighbouring particles, and issues all of a particle's loads before its
// arithmetic. Each block walks the particles in a grid-stride loop over a
// grid that just fills the card, so the staging is paid once a block. The
// state may be a column slice (a sharded filter's rank): X is read
// through its row stride.
//
// Bound: bytes. Per particle the propagate reads d state and d normal
// floats and the chi-square rows and writes d floats; the likelihood
// reads d and writes 1. At d = 2, MVT df = 5, that is 0.090 and 0.030 ms
// at N = 2^23; at d = 13, k = 1, MVN, 0.195 and 0.070 ms at N = 2^22
// (3.35 TB/s). The 2 d^2 and 2 k (d + k) flops a particle are far below
// the float32 rate at these widths.
#include <cfloat>

#include "common.cuh"
#include "propagate.cuh"

namespace {

constexpr int kThreads = 256;

template <int DM>
__host__ __device__ constexpr int packed_particles() {
  return DM <= 4 ? 4 : DM == 8 ? 2 : 1;
}

// Rows of float32 values in device memory, row r of particle p at
// base[r * ld + p]: the composed path's state and draws, read where the
// fused kernels draw Philox rows (RowCursors).
struct MemRows {
  const float* base;
  size_t ld;

  // Rows 0 .. DM - 1 of P particles: 0 from row d on and outside n.
  template <int DM, int P>
  __device__ __forceinline__ void columns(int d, const unsigned (&p)[P],
                                          const bool (&in)[P],
                                          float (&v)[P][DM]) const {
#pragma unroll
    for (int c = 0; c < DM; ++c) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        v[i][c] = 0.0f;
        if (c < d && in[i]) v[i][c] = __ldg(base + c * ld + p[i]);
      }
    }
  }

  // Row r of P particles: 1 outside n.
  template <int P>
  __device__ __forceinline__ void row(int r, const unsigned (&p)[P],
                                      const bool (&in)[P],
                                      float (&v)[P]) const {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      v[i] = in[i] ? __ldg(base + r * ld + p[i]) : 1.0f;
    }
  }
};

// The particles of one pass of a block's grid-stride loop: particle i of
// thread t at base + i * kThreads + t.
template <int P>
__device__ __forceinline__ void pass_particles(unsigned base, unsigned n,
                                               unsigned (&p)[P],
                                               bool (&in)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    p[i] = base + i * kThreads + threadIdx.x;
    in[i] = p[i] < n;
  }
}

// sqrt(df / g) of P particles, g ~ chi-square(df): for an integer df
// (m.df_int > 0) from chi2_integer_df's draws, the df / 2 uniform rows of
// `u` and the normal row `zc` (odd df); for another df `u` holds g.
template <int P>
__device__ __forceinline__ void chi_scales(const MemRows& u,
                                           const MemRows& zc,
                                           const cusmc::StepModel& m,
                                           const unsigned (&p)[P],
                                           const bool (&in)[P],
                                           float (&scale)[P]) {
  float g[P];
  if (m.df_int > 0) {
    const int half = m.df_int >> 1;
#pragma unroll
    for (int i = 0; i < P; ++i) g[i] = 0.0f;
    if (half > 0) {
      float prod[P];
      u.row(0, p, in, prod);
      for (int j = 1; j < half; ++j) {
        float v[P];
        u.row(j, p, in, v);
#pragma unroll
        for (int i = 0; i < P; ++i) prod[i] = __fmul_rn(prod[i], v[i]);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        g[i] = __fmul_rn(-2.0f, logf(fmaxf(prod[i], FLT_MIN)));
      }
    }
    if (m.df_int & 1) {
      float z[P];
      zc.row(0, p, in, z);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        g[i] = __fadd_rn(g[i], __fmul_rn(z[i], z[i]));
      }
    }
  } else {
    u.row(0, p, in, g);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) scale[i] = sqrtf(__fdiv_rn(m.df, g[i]));
}

// X_new [d, n] (contiguous) from X, z and the chi-square rows u, zc.
template <int DM>
__global__ void __launch_bounds__(kThreads)
packed_propagate_kernel(MemRows X, MemRows z, MemRows u, MemRows zc,
                        cusmc::StepModel m, float* __restrict__ Xo,
                        unsigned n) {
  constexpr int P = packed_particles<DM>();
  __shared__ cusmc::BucketModel<DM, 1> s_m;
  cusmc::stage_transition(m, s_m);
  __syncthreads();
  const int d = m.d;
  for (unsigned base = blockIdx.x * (kThreads * P); base < n;
       base += gridDim.x * (kThreads * P)) {
    unsigned p[P];
    bool in[P];
    pass_particles(base, n, p, in);
    float x[P][DM];
    float zr[P][DM];
    X.columns<DM>(d, p, in, x);
    z.columns<DM>(d, p, in, zr);
    float scale[P];
    if (m.mvt) {
      chi_scales(u, zc, m, p, in, scale);
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) scale[i] = 1.0f;
    }
    // Q z: column c's normal added into each row's FMA chain in the order
    // c = 0, 1, ..., as propagate_bucket adds its drawn normals.
    float xq[P][DM];
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int r = 0; r < DM; ++r) xq[i][r] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < DM; ++c) {
      if (c < d) {
        float qc[DM];
        cusmc::load_row<DM>(s_m.Qt + c * DM, qc);
#pragma unroll
        for (int i = 0; i < P; ++i) {
#pragma unroll
          for (int r = 0; r < DM; ++r) {
            xq[i][r] = fmaf(qc[r], zr[i][c], xq[i][r]);
          }
        }
      }
    }
    float xn[P][DM];
    cusmc::propagate_rows(s_m, m, x, xq, scale, n, Xo, p, in, xn);
  }
}

// ll [n] from X.
template <int DM, int KM>
__global__ void __launch_bounds__(kThreads)
packed_loglik_kernel(MemRows X, const float* __restrict__ log_norm,
                     cusmc::StepModel m, float* __restrict__ ll,
                     unsigned n) {
  constexpr int P = packed_particles<DM>();
  __shared__ cusmc::BucketModel<DM, KM> s_m;
  cusmc::stage_observation(m, s_m);
  m.log_norm = __ldg(log_norm);
  __syncthreads();
  for (unsigned base = blockIdx.x * (kThreads * P); base < n;
       base += gridDim.x * (kThreads * P)) {
    unsigned p[P];
    bool in[P];
    pass_particles(base, n, p, in);
    float x[P][DM];
    X.columns<DM>(m.d, p, in, x);
    float quad[P];
    cusmc::quad_forms(s_m, m.d, m.k, x, quad);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (in[i]) ll[p[i]] = cusmc::reweight(m, quad[i]);
    }
  }
}

// The grid of a grid-stride kernel: the blocks that fill every SM at the
// kernel's occupancy (per_sm, found at its first launch), or fewer where
// n needs fewer.
template <typename K>
int grid_of(K kernel, unsigned n, int per_block, int& per_sm,
            unsigned* grid) {
  if (per_sm == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned need = (n + per_block - 1) / per_block;
  const unsigned fill = static_cast<unsigned>(per_sm > 0 ? per_sm : 1) * sms;
  *grid = need < fill ? need : fill;
  return 0;
}

template <int DM>
int launch_propagate(const MemRows& X, const MemRows& z, const MemRows& u,
                     const MemRows& zc, const cusmc::StepModel& m,
                     float* Xo, unsigned n, cudaStream_t st) {
  static int per_sm = 0;
  if (m.d > DM) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  const int rc = grid_of(packed_propagate_kernel<DM>, n,
                         kThreads * packed_particles<DM>(), per_sm, &grid);
  if (rc != 0) return rc;
  packed_propagate_kernel<DM><<<grid, kThreads, 0, st>>>(X, z, u, zc, m, Xo,
                                                         n);
  return static_cast<int>(cudaGetLastError());
}

template <int DM, int KM>
int launch_loglik(const MemRows& X, const float* log_norm,
                  const cusmc::StepModel& m, float* ll, unsigned n,
                  cudaStream_t st) {
  static int per_sm = 0;
  if (m.d > DM || m.k > KM) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  const int rc = grid_of(packed_loglik_kernel<DM, KM>, n,
                         kThreads * packed_particles<DM>(), per_sm, &grid);
  if (rc != 0) return rc;
  packed_loglik_kernel<DM, KM><<<grid, kThreads, 0, st>>>(X, log_norm, m, ll,
                                                          n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X [d, n] f32 with row stride ldx, z [d, n] with row stride ldz, G and
// Q [d, d] contiguous f32 -> Xo [d, n] contiguous f32. noise: 0 MVN, 1
// MVT. MVT with df_int > 0: u holds the df_int / 2 uniform rows (row
// stride ldu; none at df_int = 1) and zc the normal row (odd df_int); with
// df_int = 0, u holds g. dm: the bucket of ops/fused_step.py::step_widths
// (d <= dm). The caller checks n < 2^31. cudaErrorInvalidValue for a
// bucket that is not compiled.
CUSMC_EXPORT int cusmc_packed_propagate(
    const float* X, long long ldx, const float* z, long long ldz,
    const float* u, long long ldu, const float* zc, const float* G,
    const float* Q, float* Xo, long long n, int d, int noise, int df_int,
    float df, int dm, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nu = static_cast<unsigned>(n);
  const MemRows xr{X, static_cast<size_t>(ldx)};
  const MemRows zr{z, static_cast<size_t>(ldz)};
  const MemRows ur{u, static_cast<size_t>(ldu)};
  const MemRows cr{zc, 0};
  const cusmc::StepModel m{G, Q, nullptr, nullptr, nullptr, d, 0, noise,
                           df_int, df, 0.0f};
  switch (dm) {
    case 2: return launch_propagate<2>(xr, zr, ur, cr, m, Xo, nu, st);
    case 4: return launch_propagate<4>(xr, zr, ur, cr, m, Xo, nu, st);
    case 8: return launch_propagate<8>(xr, zr, ur, cr, m, Xo, nu, st);
    case 16: return launch_propagate<16>(xr, zr, ur, cr, m, Xo, nu, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// X [d, n] f32 with row stride ldx, y [k], F [k, d] and Li [k, k]
// contiguous f32, log_norm one f32 on the device -> ll [n] f32. noise: 0
// MVN, 1 MVT. (dm, km): the bucket of ops/fused_step.py::step_widths,
// dm <= 16. The caller checks n < 2^31. cudaErrorInvalidValue for a bucket
// that is not compiled.
CUSMC_EXPORT int cusmc_packed_loglik(const float* X, long long ldx,
                                     const float* y, const float* F,
                                     const float* Li, const float* log_norm,
                                     float* ll, long long n, int d, int k,
                                     int noise, float df, int dm, int km,
                                     void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nu = static_cast<unsigned>(n);
  const MemRows xr{X, static_cast<size_t>(ldx)};
  const cusmc::StepModel m{nullptr, nullptr, F, Li, y, d, k, noise, 0, df,
                           0.0f};
#define CUSMC_BUCKET(DM, KM)                                              \
  if (dm == DM && km == KM) return launch_loglik<DM, KM>(xr, log_norm, m, \
                                                         ll, nu, st);
  CUSMC_BUCKET(2, 1)
  CUSMC_BUCKET(2, 2)
  CUSMC_BUCKET(4, 1)
  CUSMC_BUCKET(4, 4)
  CUSMC_BUCKET(8, 1)
  CUSMC_BUCKET(8, 8)
  CUSMC_BUCKET(16, 1)
  CUSMC_BUCKET(16, 16)
#undef CUSMC_BUCKET
  return static_cast<int>(cudaErrorInvalidValue);
}
