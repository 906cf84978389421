// Propagate and reweight one particle a thread: the second half of both
// fused step kernels' "thread" design (fused_step.cu, fused_cdf_step.cu),
// and, with the draws read from memory, the composed path's two kernels
// (packed_model.cu: stage_transition, stage_observation, propagate_rows,
// quad_forms, reweight).
//
// The TPU kernels' stages (cusmc_tpu/ops/fused_step.py:291-343,
// ops/fused_cdf_step.py:257-304), for the particle whose ancestor is a:
//   x_new = G x[:, a] + Q z * s,   z ~ N(0, I) by Box-Muller,
//   s = 1 (MVN) or sqrt(df / g), g ~ chi-square(df) (MVT: one log of a
//       product of uniforms for integer df, else 4 fixed Marsaglia-Tsang
//       rounds of Gamma(df / 2)),
//   ll = log_norm - quad / 2 (MVN) or log_norm - (df + k) / 2
//        log1p(quad / df) (MVT),  quad = |Li (y - F x_new)|^2.
// The random rows of a particle are read in the order z's first
// Box-Muller uniforms (d rows), their partners (d rows), then the
// chi-square rows. Every scalar operation outside the four matrix-vector
// products is rounded once, in the order the plain PyTorch version
// computes it (__fmul_rn and friends keep nvcc from contracting them into
// FMAs), so the chi-square accept tests agree with the plain version
// exactly; each product is an FMA chain over the columns in order.
//
// The compiled width buckets (DM, KM) of ops/fused_step.py::step_widths,
// DM >= d and KM >= k, DM in {2, 4, 8, 16} and KM in {1, DM}
// (propagate_bucket): loops unrolled to DM and KM and guarded by the
// run-time d and k, so that every vector lives in registers, and
// P = bucket_particles<DM>(walk) particles a thread. The matrices are
// staged once a block, widened to float32, in shared memory at the
// bucket's padded strides (Q transposed), where a row is contiguous and
// loads as 16-byte vectors that serve the thread's P particles. The
// ancestors' columns are loaded first, and their loads fly while the noise
// is drawn: one pass over the columns c, each drawing z_c from its two rows
// (RowCursors' two cursors) and adding Q[:, c] z_c into the running sums,
// so the normals need no array. Every bucket at least as wide as the shape
// gives the same values: the guards keep each product's FMA chain and
// every rounding. Shapes wider than 16 take the "tile" design
// (tile_propagate.cuh, wide_propagate.cuh).
//
// The state's type T is float or, under mixed precision, __nv_bfloat16,
// with G, Q and F of the same type (Li, y, the noise's scale and ll stay
// float32). In bfloat16 the TPU kernel's law holds
// (cusmc_tpu/ops/fused_step.py:277-336): each loaded value is widened to
// float32, each normal is rounded to bfloat16 before the Q product, the
// products of two bfloat16 values are exact in float32 and sum there,
// G x + Q z s is rounded once to the stored state, and F x_new is taken
// from that stored value. In float32 the roundings are the identity.
#pragma once

#include <cuda_bf16.h>

#include "philox.cuh"

namespace cusmc {

constexpr int kMtRounds = 4;

template <typename T = float>
struct StepModelT {
  const T* G;       // [d, d]
  const T* Q;       // [d, d] transition noise square root
  const T* F;       // [k, d]
  const float* Li;  // [k, k] inverse Cholesky factor of V
  const float* y;   // [k] observation
  int d;
  int k;
  int mvt;          // 0: MVN, 1: MVT
  int df_int;       // MVT: the integer df, or 0 for Marsaglia-Tsang
  float df;
  float log_norm;
};
using StepModel = StepModelT<float>;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x in the state's type (round to nearest even).
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the state's type, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

// sqrt(df / g), g ~ chi-square(df), for the P particles of `rows` (a
// RowCursors<P>, or a BitStream for one particle) from their rows crow,
// crow + 1, ...
template <int P, typename S, typename T>
__device__ __forceinline__ void mvt_scales(S& rows, int crow,
                                           const StepModelT<T>& m,
                                           float (&scale)[P]) {
  uint32_t w[P];
  uint32_t w2[P];
  float g[P];
  if (m.df_int > 0) {
    const int half = m.df_int >> 1;
    if (half > 0) {
      float prod[P];
      rows.bits(crow, w);
#pragma unroll
      for (int i = 0; i < P; ++i) prod[i] = to_uniform(w[i]);
      for (int j = 1; j < half; ++j) {
        rows.bits(crow + j, w);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          prod[i] = __fmul_rn(prod[i], to_uniform(w[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        g[i] = __fmul_rn(-2.0f, logf(fmaxf(prod[i], 1e-38f)));
      }
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) g[i] = 0.0f;
    }
    if (m.df_int & 1) {
      rows.bits(crow + half, w);
      rows.bits(crow + half + 1, w2);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float zc = box_muller(to_uniform(w[i]), to_uniform(w2[i]));
        g[i] = __fadd_rn(g[i], __fmul_rn(zc, zc));
      }
    }
  } else {
    const float alpha = __fmul_rn(0.5f, m.df);
    const float dd = __fsub_rn(alpha, 1.0f / 3.0f);
    const float c = __fdiv_rn(1.0f, sqrtf(__fmul_rn(9.0f, dd)));
    float out[P];
    bool accepted[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      out[i] = alpha;
      accepted[i] = false;
    }
    uint32_t w3[P];
#pragma unroll 1
    for (int r = 0; r < kMtRounds; ++r) {
      rows.bits(crow + 3 * r, w);
      rows.bits(crow + 3 * r + 1, w2);
      rows.bits(crow + 3 * r + 2, w3);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float x = box_muller(to_uniform(w[i]), to_uniform(w2[i]));
        const float t = __fadd_rn(1.0f, __fmul_rn(c, x));
        const float v = __fmul_rn(__fmul_rn(t, t), t);
        const float u = to_uniform(w3[i]);
        const float rhs = __fadd_rn(
            __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x), dd),
                      __fmul_rn(dd, v)),
            __fmul_rn(dd, logf(v > 0.0f ? v : 1.0f)));
        const bool ok = v > 0.0f && logf(u) < rhs;
        if (ok && !accepted[i]) out[i] = __fmul_rn(dd, v);
        accepted[i] = accepted[i] || ok;
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) g[i] = __fmul_rn(2.0f, out[i]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) scale[i] = sqrtf(__fdiv_rn(m.df, g[i]));
}

// ll from the quadratic form, MVN or MVT, rounded as the plain version.
template <typename T>
__device__ __forceinline__ float reweight(const StepModelT<T>& m,
                                          float quad) {
  if (m.mvt) {
    const float half_dfk =
        __fmul_rn(0.5f, __fadd_rn(m.df, static_cast<float>(m.k)));
    return __fsub_rn(m.log_norm,
                     __fmul_rn(half_dfk, log1pf(__fdiv_rn(quad, m.df))));
  }
  return __fsub_rn(m.log_norm, __fmul_rn(0.5f, quad));
}

// Particles a thread in bucket DM, for the Metropolis step (`walk`) or
// the inverse-CDF step: each staged matrix element a thread loads from
// shared memory serves this many particles, and their work interleaves.
// Two, but one for the Metropolis step at DM = 16, where two particles'
// walks and vectors took 136 registers and three blocks an SM, and one
// particle ran faster (PERF.md).
template <int DM>
__host__ __device__ constexpr int bucket_particles(bool walk) {
  return walk && DM > 8 ? 1 : 2;
}

// A bucket's matrices in shared memory, widened to float32 and padded to
// its compiled strides with zeros; each row starts on 16 bytes.
template <int DM, int KM>
struct BucketModel {
  alignas(16) float G[DM * DM];   // G[r * DM + c]
  alignas(16) float Qt[DM * DM];  // Q transposed: Qt[c * DM + r] = Q[r][c]
  alignas(16) float F[KM * DM];   // F[j * DM + c]
  alignas(16) float Li[KM * KM];  // Li[i * KM + j]
  float y[KM];
};

// Stages m's transition matrices (G, Q transposed) into `s` (the
// block's); the caller synchronises the block before they are read.
template <int DM, int KM, typename T>
__device__ __forceinline__ void stage_transition(const StepModelT<T>& m,
                                                 BucketModel<DM, KM>& s) {
  const int d = m.d;
  for (int i = threadIdx.x; i < DM * DM; i += blockDim.x) {
    const int r = i / DM;
    const int c = i % DM;
    const bool in = r < d && c < d;
    s.G[i] = in ? widen(m.G[r * d + c]) : 0.0f;
    s.Qt[i] = in ? widen(m.Q[c * d + r]) : 0.0f;
  }
}

// Stages m's observation side (F, Li, y) into `s`, as stage_transition.
template <int DM, int KM, typename T>
__device__ __forceinline__ void stage_observation(const StepModelT<T>& m,
                                                  BucketModel<DM, KM>& s) {
  const int d = m.d;
  const int k = m.k;
  for (int i = threadIdx.x; i < KM * DM; i += blockDim.x) {
    const int j = i / DM;
    const int c = i % DM;
    s.F[i] = j < k && c < d ? widen(m.F[j * d + c]) : 0.0f;
  }
  for (int i = threadIdx.x; i < KM * KM; i += blockDim.x) {
    const int r = i / KM;
    const int c = i % KM;
    s.Li[i] = r < k && c < k ? m.Li[r * k + c] : 0.0f;
  }
  if (threadIdx.x < KM) {
    s.y[threadIdx.x] = static_cast<int>(threadIdx.x) < k ? m.y[threadIdx.x]
                                                         : 0.0f;
  }
}

// Stages all of m's matrices into `s`.
template <int DM, int KM, typename T>
__device__ __forceinline__ void stage_bucket(const StepModelT<T>& m,
                                             BucketModel<DM, KM>& s) {
  stage_transition(m, s);
  stage_observation(m, s);
}

// A staged row of W floats (16-byte aligned), in vector loads.
template <int W>
__device__ __forceinline__ void load_row(const float* row, float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + c);
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
  } else if constexpr (W == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = row[c];
  }
}

// The ancestors' columns a[i] of X [d, n], widened; entries from d on are
// 0. Their loads go out together, before the caller draws the noise.
template <int DM, int P, typename T>
__device__ __forceinline__ void load_columns(const T* __restrict__ X,
                                             unsigned n,
                                             const unsigned (&a)[P], int d,
                                             float (&x)[P][DM]) {
#pragma unroll
  for (int c = 0; c < DM; ++c) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      x[i][c] = 0.0f;
      if (c < d) x[i][c] = widen(X[static_cast<size_t>(c) * n + a[i]]);
    }
  }
}

// x_new = G x + (Q z) s of P particles from their states x and their
// sums xq = Q z, row by row: each row's G x an FMA chain over the columns
// in order, (Q z) s rounded once (MVT), and their sum once, to T. Row r
// of particle i is stored at Xo[r * n + p[i]] where store[i], and its
// stored value is returned widened in xn[i][r] (0 from d on).
template <int DM, int KM, int P, typename T>
__device__ __forceinline__ void propagate_rows(
    const BucketModel<DM, KM>& sm, const StepModelT<T>& m,
    const float (&x)[P][DM], const float (&xq)[P][DM],
    const float (&scale)[P], unsigned n, T* __restrict__ Xo,
    const unsigned (&p)[P], const bool (&store)[P], float (&xn)[P][DM]) {
  const int d = m.d;
#pragma unroll
  for (int r = 0; r < DM; ++r) {
#pragma unroll
    for (int i = 0; i < P; ++i) xn[i][r] = 0.0f;
    if (r < d) {
      float gr[DM];
      load_row<DM>(sm.G + r * DM, gr);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < DM; ++c) {
          if (c < d) acc = fmaf(gr[c], x[i][c], acc);
        }
        const float qz = m.mvt ? __fmul_rn(xq[i][r], scale[i]) : xq[i][r];
        const T xt = narrow<T>(__fadd_rn(acc, qz));
        xn[i][r] = widen(xt);
        if (store[i]) Xo[static_cast<size_t>(r) * n + p[i]] = xt;
      }
    }
  }
}

// quad = |Li (y - F x)|^2 of P particles' states x (0 from d on): each
// residual y_j - F_j x with F_j x an FMA chain over the columns in order,
// each row of Li r one over the residuals, and their squares summed in an
// FMA chain over the rows.
template <int DM, int KM, int P>
__device__ __forceinline__ void quad_forms(const BucketModel<DM, KM>& sm,
                                           int d, int k,
                                           const float (&x)[P][DM],
                                           float (&quad)[P]) {
  float res[P][KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
#pragma unroll
    for (int i = 0; i < P; ++i) res[i][j] = 0.0f;
    if (j < k) {
      float fr[DM];
      load_row<DM>(sm.F + j * DM, fr);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < DM; ++c) {
          if (c < d) acc = fmaf(fr[c], x[i][c], acc);
        }
        res[i][j] = __fsub_rn(sm.y[j], acc);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) quad[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    if (r < k) {
      float lr[KM];
      load_row<KM>(sm.Li + r * KM, lr);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) acc = fmaf(lr[j], res[i][j], acc);
        }
        quad[i] = fmaf(acc, acc, quad[i]);
      }
    }
  }
}

// The bucket path: propagates particles p[i] from their ancestors'
// columns `x` (load_columns), writes columns p[i] of Xo [d, n] and ll[p[i]].
// The noise rows start at zrow; `rows` holds on cursor one the group the
// caller drew last (RowCursors::hold), if any.
template <int DM, int KM, int P, typename T>
__device__ __forceinline__ void propagate_bucket(
    const BucketModel<DM, KM>& sm, const StepModelT<T>& m,
    const float (&x)[P][DM], unsigned n, T* __restrict__ Xo,
    float* __restrict__ ll, const unsigned (&p)[P], RowCursors<P>& rows,
    int zrow) {
  const int d = m.d;
  const int k = m.k;
  // Q z: column c's normal from rows zrow + c and zrow + d + c, added into
  // each row's FMA chain in the order c = 0, 1, ...; the padded rows of Qt
  // are zero and their sums are never read.
  float xq[P][DM];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int r = 0; r < DM; ++r) xq[i][r] = 0.0f;
  }
  rows.start_second(zrow + d);
  for (int c = 0; c < d; ++c) {
    uint32_t w1[P];
    uint32_t w2[P];
    rows.first(zrow + c, w1);
    rows.second(zrow + d + c, w2);
    float qc[DM];
    load_row<DM>(sm.Qt + c * DM, qc);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float z = round_to<T>(
          box_muller(to_uniform(w1[i]), to_uniform(w2[i])));
#pragma unroll
      for (int r = 0; r < DM; ++r) xq[i][r] = fmaf(qc[r], z, xq[i][r]);
    }
  }
  float scale[P];
  if (m.mvt) {
    mvt_scales(rows, zrow + 2 * d, m, scale);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) scale[i] = 1.0f;
  }
  bool all[P];
#pragma unroll
  for (int i = 0; i < P; ++i) all[i] = true;
  float xn[P][DM];
  propagate_rows(sm, m, x, xq, scale, n, Xo, p, all, xn);
  float quad[P];
  quad_forms(sm, d, k, xn, quad);
#pragma unroll
  for (int i = 0; i < P; ++i) ll[p[i]] = reweight(m, quad[i]);
}

}  // namespace cusmc
