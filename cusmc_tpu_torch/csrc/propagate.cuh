// Propagate and reweight one particle in registers: the second half of both
// fused step kernels (fused_step.cu, fused_cdf_step.cu).
//
// The TPU kernels' stages (cusmc_tpu/ops/fused_step.py:291-343,
// ops/fused_cdf_step.py:257-304), for the particle whose ancestor is a:
//   x_new = G x[:, a] + Q z * s,   z ~ N(0, I) by Box-Muller,
//   s = 1 (MVN) or sqrt(df / g), g ~ chi-square(df) (MVT: one log of a
//       product of uniforms for integer df, else 4 fixed Marsaglia-Tsang
//       rounds of Gamma(df / 2)),
//   ll = log_norm - quad / 2 (MVN) or log_norm - (df + k) / 2
//        log1p(quad / df) (MVT),  quad = |Li (y - F x_new)|^2.
// The random rows of a particle are read from its BitStream in the order
// z's first Box-Muller uniforms (d rows), their partners (d rows), then the
// chi-square rows. Every scalar operation outside the four matrix-vector
// products is rounded once, in the order the plain PyTorch version
// computes it (__fmul_rn and friends keep nvcc from contracting them into
// FMAs), so the chi-square accept tests agree with the plain version
// exactly; the products sum in their own order and agree to rounding.
//
// Matrices are row-major. They are staged in shared memory when all four
// fit in 48 KB (d = k <= 55 in float32), else read through L1 from global
// memory. D, K > 0 fix the dimensions at compile time (fully unrolled, the
// vectors in registers); D = K = 0 takes them at run time, up to 128, with
// the vectors in local memory.
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

constexpr int kMaxDim = 128;
constexpr int kMtRounds = 4;
constexpr size_t kStageBytes = 48 * 1024;

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

// Bytes of the staged matrices: G, Q, F in the state's type, then Li in
// float32 at a 4-byte boundary.
template <typename T = float>
inline size_t model_bytes(int d, int k) {
  const size_t head = sizeof(T) * (2 * static_cast<size_t>(d) * d +
                                   static_cast<size_t>(k) * d);
  return (head + 3) / 4 * 4 + sizeof(float) * static_cast<size_t>(k) * k;
}

// Copies the matrices into `smem` (the block's dynamic shared memory) when
// `staged`; the caller synchronises the block before using the result.
template <typename T>
__device__ __forceinline__ StepModelT<T> stage_model(StepModelT<T> m,
                                                     float* smem,
                                                     bool staged) {
  if (!staged) return m;
  const int dd = m.d * m.d;
  const int kd = m.k * m.d;
  const int kk = m.k * m.k;
  T* G = reinterpret_cast<T*>(smem);
  T* Q = G + dd;
  T* F = Q + dd;
  float* L = smem + (sizeof(T) * (2 * dd + kd) + 3) / 4;
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    G[i] = m.G[i];
    Q[i] = m.Q[i];
  }
  for (int i = threadIdx.x; i < kd; i += blockDim.x) F[i] = m.F[i];
  for (int i = threadIdx.x; i < kk; i += blockDim.x) L[i] = m.Li[i];
  m.G = G;
  m.Q = Q;
  m.F = F;
  m.Li = L;
  return m;
}

// sqrt(df / g), g ~ chi-square(df) from the rows crow, crow + 1, ...
template <typename T>
__device__ __forceinline__ float mvt_scale(BitStream& bs, int crow,
                                           const StepModelT<T>& m) {
  float g;
  if (m.df_int > 0) {
    const int half = m.df_int >> 1;
    if (half > 0) {
      float prod = to_uniform(bs.bits(crow));
      for (int j = 1; j < half; ++j) {
        prod = __fmul_rn(prod, to_uniform(bs.bits(crow + j)));
      }
      g = __fmul_rn(-2.0f, logf(fmaxf(prod, 1e-38f)));
    } else {
      g = 0.0f;
    }
    if (m.df_int & 1) {
      const float u1 = to_uniform(bs.bits(crow + half));
      const float zc = box_muller(u1, to_uniform(bs.bits(crow + half + 1)));
      g = __fadd_rn(g, __fmul_rn(zc, zc));
    }
  } else {
    const float alpha = __fmul_rn(0.5f, m.df);
    const float dd = __fsub_rn(alpha, 1.0f / 3.0f);
    const float c = __fdiv_rn(1.0f, sqrtf(__fmul_rn(9.0f, dd)));
    float out = alpha;
    bool accepted = false;
    for (int i = 0; i < kMtRounds; ++i) {
      const float u1 = to_uniform(bs.bits(crow + 3 * i));
      const float x = box_muller(u1, to_uniform(bs.bits(crow + 3 * i + 1)));
      const float t = __fadd_rn(1.0f, __fmul_rn(c, x));
      const float v = __fmul_rn(__fmul_rn(t, t), t);
      const float u = to_uniform(bs.bits(crow + 3 * i + 2));
      const float rhs = __fadd_rn(
          __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x), dd),
                    __fmul_rn(dd, v)),
          __fmul_rn(dd, logf(v > 0.0f ? v : 1.0f)));
      const bool ok = v > 0.0f && logf(u) < rhs;
      if (ok && !accepted) out = __fmul_rn(dd, v);
      accepted = accepted || ok;
    }
    g = __fmul_rn(2.0f, out);
  }
  return sqrtf(__fdiv_rn(m.df, g));
}

// Propagates particle p from its ancestor a (column a of X [d, n]), writes
// column p of Xo [d, n] and ll[p]. zrow: the particle's first noise row.
template <int D, int K, typename T>
__device__ __forceinline__ void propagate_reweight(
    const StepModelT<T>& m, const T* __restrict__ X, long long n, long long a,
    T* __restrict__ Xo, float* __restrict__ ll, long long p,
    BitStream& bs, int zrow) {
  constexpr int DM = D > 0 ? D : kMaxDim;
  constexpr int KM = K > 0 ? K : kMaxDim;
  const int d = D > 0 ? D : m.d;
  const int k = K > 0 ? K : m.k;
  float v[DM];   // the normals z, then the ancestor state
  float xn[DM];  // Q z (scaled), then the new state
  float res[KM];
#pragma unroll
  for (int r = 0; r < d; ++r) v[r] = to_uniform(bs.bits(zrow + r));
#pragma unroll
  for (int r = 0; r < d; ++r) {
    v[r] = round_to<T>(box_muller(v[r], to_uniform(bs.bits(zrow + d + r))));
  }
  const float scale = m.mvt ? mvt_scale(bs, zrow + 2 * d, m) : 1.0f;
#pragma unroll
  for (int r = 0; r < d; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < d; ++c) acc = fmaf(widen(m.Q[r * d + c]), v[c], acc);
    xn[r] = m.mvt ? __fmul_rn(acc, scale) : acc;
  }
#pragma unroll
  for (int c = 0; c < d; ++c) {
    v[c] = widen(X[static_cast<long long>(c) * n + a]);
  }
#pragma unroll
  for (int r = 0; r < d; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < d; ++c) acc = fmaf(widen(m.G[r * d + c]), v[c], acc);
    const T x = narrow<T>(__fadd_rn(acc, xn[r]));
    xn[r] = widen(x);
    Xo[static_cast<long long>(r) * n + p] = x;
  }
#pragma unroll
  for (int j = 0; j < k; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < d; ++c) acc = fmaf(widen(m.F[j * d + c]), xn[c], acc);
    res[j] = __fsub_rn(m.y[j], acc);
  }
  float quad = 0.0f;
#pragma unroll
  for (int i = 0; i < k; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < k; ++j) acc = fmaf(m.Li[i * k + j], res[j], acc);
    quad = fmaf(acc, acc, quad);
  }
  if (m.mvt) {
    const float half_dfk =
        __fmul_rn(0.5f, __fadd_rn(m.df, static_cast<float>(k)));
    ll[p] = __fsub_rn(m.log_norm,
                      __fmul_rn(half_dfk, log1pf(__fdiv_rn(quad, m.df))));
  } else {
    ll[p] = __fsub_rn(m.log_norm, __fmul_rn(0.5f, quad));
  }
}

}  // namespace cusmc
