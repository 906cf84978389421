// Propagate and reweight particles with warp-level matrix products on the
// tensor cores: the second half of the fused Metropolis step
// (fused_step.cu) at d = k in {16, 32}, written so that the fused
// inverse-CDF step can call it too (it needs only each thread's ancestor
// and BitStream).
//
// The arithmetic is propagate.cuh's, per particle:
//   x_new = G x[:, a] + (Q z) * s,  res = y - F x_new,
//   quad = |Li res|^2,  ll = log_norm - ... (MVN or MVT, as there),
// with the same Philox rows (the d first Box-Muller uniforms, their d
// partners, then the chi-square rows) and every scalar step outside the
// four products rounded once in the plain version's order.
//
// What changes is where the products run. propagate.cuh gives each thread
// its own particle and runs the 2 d^2 + 2 k^2 multiply-adds (4096 at
// d = k = 32) as FFMAs, each behind a broadcast shared-memory load: those
// alone issue ~4600 instructions a particle, and the step ran 8.6x its
// bound. Here each warp works on a tile of its 32 particles:
//   1. each lane starts the copy of its ancestor's column X[:, a] into the
//      warp's [d x 32] tile T1 with cp.async (4 bytes per element), and
//      draws its d normals into the warp's tile T2 and its MVT scale while
//      the copies fly;
//   2. the products Q T2, G T1, F Xn and Li R run as mma.sync m16n8k8
//      TF32 tiles in the 3xTF32 split: each float32 operand x is cut into
//      big = tf32(x) and small = tf32(x - big), and a product is
//      big*big + big*small + small*big, which keeps float32 accuracy
//      (plain TF32 keeps about three digits; the kernel is held to its
//      float32 plain version at 1e-4). The A fragments (the model
//      matrices, 16 KB at d = 32) are read through L1 from the row-major
//      tensors; the B fragments come from the tiles, whose rows are padded
//      to 40 floats so that a fragment load hits 32 distinct banks;
//   3. each column's squared norm is summed over the fragment rows with
//      warp shuffles, and each lane finishes its own ll.
// A product then costs a warp (d/16) (d/8) 4 x 3 mma instructions plus the
// splits, ~40 issue slots a particle for all four at d = 32 instead of
// ~4600, so the FP32 pipes are left to the Philox and Box-Muller work. The
// warps of a block share nothing here: they synchronise with __syncwarp
// alone.
//
// Why this design: register-blocked FFMA over the same tiles, with the
// block or each warp as the unit, computes the products bitwise as an FMA
// chain but spends the FP32 issue slots the draws need; on the card it was
// slower at d = 32 than this design. What bounds this design there is no
// longer the products: the precise Box-Muller draws (logf, sqrtf, cosf,
// kept for the plain version's law), the Metropolis walk's dependent
// weight loads and the scattered ancestor gather take most of the time,
// and the tensor-core phase does not overlap them well (PERF.md).
//
// Shared memory (dynamic, TileLayout<D>::bytes(warps) for a block of that
// many warps): per warp T1 and T2 ([d x 40] each) and 32 MVT scales,
// 10.1 KB a warp at d = 32.
//
// The bfloat16 state (mixed precision; the second tile_propagate_reweight
// below) keeps the TPU kernel's law (propagate.cuh) and changes the
// products: G T1, Q T2 and F Xn run as mma.sync m16n8k16 bf16 x bf16 ->
// f32 tiles in one pass (the TPU's native bf16 mode,
// cusmc_tpu/ops/fused_step.py:277-280: the products of two bfloat16 values
// are exact and sum in float32), Li R stays 3xTF32 in float32. T1 and T2
// hold bfloat16 particle-major, [32 x (d + 8)]: a B fragment register is
// two consecutive state components of one particle, one 32-bit load, and
// the 8-element pad keeps a fragment load on 32 distinct banks and each
// particle's row 16-byte aligned. cp.async copies 4, 8 or 16 bytes, and the
// d elements of an ancestor's column lie n apart, so each lane loads its
// ancestor's elements (ld.global.nc) into registers before the draws, and
// stores them into its row of T1 after. The draws go through a float32
// [d x 40] tile R (the layout of the float32 design's T2), which later
// holds the residuals for Li R. 10.1 KB a warp at d = 32.
#pragma once

#include <cstdint>

#include "propagate.cuh"

namespace cusmc {

constexpr int kTileP = 32;   // particles of a warp tile
constexpr int kTileLd = 40;  // padded tile row: fragment loads conflict-free

template <int D, typename T = float>
struct TileLayout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 32, "d = k in {16, 32}");
  static constexpr int kT2 = D * kTileLd;  // offsets within a warp's part
  static constexpr int kScale = 2 * D * kTileLd;
  static constexpr int kPerWarp = kScale + kTileP;
  static constexpr size_t bytes(int warps) {
    return sizeof(float) * static_cast<size_t>(warps) * kPerWarp;
  }
};

// The bfloat16 design's part of a warp, in floats: R [D x kTileLd] f32,
// then T1 and T2, [kTileP x Ld] bfloat16 each, then 32 scales.
template <int D>
struct TileLayout<D, __nv_bfloat16> {
  static_assert(D % 16 == 0 && D >= 16 && D <= 32, "d = k in {16, 32}");
  static constexpr int kLd = D + 8;  // bfloat16 elements a particle's row
  static constexpr int kT1 = D * kTileLd;
  static constexpr int kT2 = kT1 + kTileP * kLd / 2;
  static constexpr int kScale = kT2 + kTileP * kLd / 2;
  static constexpr int kPerWarp = kScale + kTileP;
  static_assert(kT1 % 4 == 0 && kT2 % 4 == 0 && kPerWarp % 4 == 0 &&
                    kLd % 8 == 0,
                "16-byte aligned rows");
  static constexpr size_t bytes(int warps) {
    return sizeof(float) * static_cast<size_t>(warps) * kPerWarp;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] = M [D x D] (row-major, global) times the warp tile T
// [D x 32] (row stride kTileLd), as m16n8k8 fragments: lane (g, t) =
// (lane / 4, lane % 4) holds acc[mt][nt][0..3] at rows 16 mt + g (+8 for
// [2], [3]) and columns 8 nt + 2 t (+1 for [1], [3]).
template <int D>
__device__ __forceinline__ void tile_product(const float* __restrict__ M,
                                             const float* T,
                                             float (&acc)[D / 16][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ab[D / 16][4], as[D / 16][4];
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      const float* m0 = M + (16 * mt + g) * D + 8 * ks + t;
      split_tf32(__ldg(m0), ab[mt][0], as[mt][0]);
      split_tf32(__ldg(m0 + 8 * D), ab[mt][1], as[mt][1]);
      split_tf32(__ldg(m0 + 4), ab[mt][2], as[mt][2]);
      split_tf32(__ldg(m0 + 8 * D + 4), ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* b = T + (8 * ks + t) * kTileLd + 8 * nt + g;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b[0], bb0, bs0);
      split_tf32(b[4 * kTileLd], bb1, bs1);
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        mma_tf32(acc[mt][nt], as[mt], bb0, bb1);
        mma_tf32(acc[mt][nt], ab[mt], bs0, bs1);
        mma_tf32(acc[mt][nt], ab[mt], bb0, bb1);
      }
    }
  }
}

// Stores a product's fragments into the tile T (row stride kTileLd).
template <int D>
__device__ __forceinline__ void store_tile(float* T,
                                           const float (&v)[D / 16][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* c = T + (16 * mt + g) * kTileLd + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(c) =
          make_float2(v[mt][nt][0], v[mt][nt][1]);
      *reinterpret_cast<float2*>(c + 8 * kTileLd) =
          make_float2(v[mt][nt][2], v[mt][nt][3]);
    }
  }
}

// Propagates the warp's 32 particles (lane: particle p, ancestor a) and
// writes Xo[:, p] and ll[p]; p is consecutive across the warp's lanes.
// smem is the block's dynamic shared memory (TileLayout<D>); every lane of
// the warp calls this. zrow: the particle's first noise row of bs.
template <int D>
__device__ __forceinline__ void tile_propagate_reweight(
    const StepModel& m, float* smem, const float* __restrict__ X,
    long long n, long long a, float* __restrict__ Xo,
    float* __restrict__ ll, long long p, const BitStream& bs, int zrow) {
  using L = TileLayout<D>;
  constexpr int MT = D / 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float* T1 = smem + (threadIdx.x >> 5) * L::kPerWarp;
  float* T2 = T1 + L::kT2;
  float* scale = T1 + L::kScale;

  // 1. the ancestor column, in flight while the normals are drawn: four
  // noise rows of BitStream's layout from each Philox call with no
  // per-row branch; the first uniforms (rows zrow .. zrow + D - 1) go to
  // T2, then their partners (rows zrow + D ..) turn them into normals.
  // The calls of a pass are independent, and so are the four Box-Muller
  // transforms of a call.
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    cp_async4(T1 + c * kTileLd + lane, X + static_cast<long long>(c) * n + a);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 3
  for (int grp = zrow >> 2; grp <= (zrow + D - 1) >> 2; ++grp) {
    const uint4 w = philox4x32_10(
        make_uint4(bs.lane, static_cast<uint32_t>(grp), bs.stream, 0u),
        bs.key);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * grp + j - zrow;
      if (r >= 0 && r < D) T2[r * kTileLd + lane] = to_uniform(wv[j]);
    }
  }
#pragma unroll 3
  for (int grp = (zrow + D) >> 2; grp <= (zrow + 2 * D - 1) >> 2; ++grp) {
    const uint4 w = philox4x32_10(
        make_uint4(bs.lane, static_cast<uint32_t>(grp), bs.stream, 0u),
        bs.key);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * grp + j - zrow - D;
      if (r >= 0 && r < D) {
        float* z = T2 + r * kTileLd + lane;
        *z = box_muller(*z, to_uniform(wv[j]));
      }
    }
  }
  BitStream bc(bs.key, bs.lane, bs.stream);  // the chi-square rows
  float s1[1] = {1.0f};
  if (m.mvt) mvt_scales(bc, zrow + 2 * D, m, s1);
  scale[lane] = s1[0];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // 2. x_new = G x_anc + (Q z) s.
  float xn[MT][4][4];
  {
    float qz[MT][4][4];
    tile_product<D>(m.Q, T2, qz);
    if (m.mvt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float s0 = scale[8 * nt + 2 * t];
        const float s1 = scale[8 * nt + 2 * t + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          qz[mt][nt][0] = __fmul_rn(qz[mt][nt][0], s0);
          qz[mt][nt][1] = __fmul_rn(qz[mt][nt][1], s1);
          qz[mt][nt][2] = __fmul_rn(qz[mt][nt][2], s0);
          qz[mt][nt][3] = __fmul_rn(qz[mt][nt][3], s1);
        }
      }
    }
    tile_product<D>(m.G, T1, xn);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xn[mt][nt][e] = __fadd_rn(xn[mt][nt][e], qz[mt][nt][e]);
        }
      }
    }
  }
  __syncwarp();  // every read of T1 is done
  store_tile<D>(T1, xn);
  __syncwarp();
#pragma unroll 8
  for (int c = 0; c < D; ++c) {  // coalesced: column p of Xo
    Xo[static_cast<long long>(c) * n + p] = T1[c * kTileLd + lane];
  }

  // 3. res = y - F x_new, into T2 (every read of T2 ended before the last
  // __syncwarp).
  {
    float fx[MT][4][4];
    tile_product<D>(m.F, T1, fx);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float y0 = __ldg(m.y + 16 * mt + g);
      const float y1 = __ldg(m.y + 16 * mt + g + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        fx[mt][nt][0] = __fsub_rn(y0, fx[mt][nt][0]);
        fx[mt][nt][1] = __fsub_rn(y0, fx[mt][nt][1]);
        fx[mt][nt][2] = __fsub_rn(y1, fx[mt][nt][2]);
        fx[mt][nt][3] = __fsub_rn(y1, fx[mt][nt][3]);
      }
    }
    store_tile<D>(T2, fx);
  }
  __syncwarp();  // T2 holds res

  // 4. quad = |Li res|^2: each lane's rows, then the 8 row groups (lanes
  // g = 0..7 of the same t) over shuffles.
  float lr[MT][4][4];
  tile_product<D>(m.Li, T2, lr);
  float q[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.0f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        s = fmaf(lr[mt][nt][e], lr[mt][nt][e], s);
        s = fmaf(lr[mt][nt][e + 2], lr[mt][nt][e + 2], s);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s = __fadd_rn(s, __shfl_xor_sync(kFullMask, s, off));
      }
      q[nt][e] = s;
    }
  }
  if (g == 0) {  // lanes 0..3 hold the totals of columns 8 nt + 2 t (+1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      scale[8 * nt + 2 * t] = q[nt][0];
      scale[8 * nt + 2 * t + 1] = q[nt][1];
    }
  }
  __syncwarp();
  const float quad = scale[lane];
  if (m.mvt) {
    const float half_dfk =
        __fmul_rn(0.5f, __fadd_rn(m.df, static_cast<float>(D)));
    ll[p] = __fsub_rn(m.log_norm,
                      __fmul_rn(half_dfk, log1pf(__fdiv_rn(quad, m.df))));
  } else {
    ll[p] = __fsub_rn(m.log_norm, __fmul_rn(0.5f, quad));
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] = M [D x D] (row-major bfloat16, global, 4-byte aligned)
// times the warp tile T, particle-major bfloat16 ([32 x Ld]: component c
// of particle j at T[j Ld + c]), as m16n8k16 fragments in float32: the
// accumulator layout of tile_product. A register holds two consecutive
// columns of M (A) or two consecutive components of one particle (B).
template <int D>
__device__ __forceinline__ void tile_product_bf16(
    const __nv_bfloat16* __restrict__ M, const __nv_bfloat16* T,
    float (&acc)[D / 16][4][4]) {
  constexpr int Ld = TileLayout<D, __nv_bfloat16>::kLd;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t* Mw = reinterpret_cast<const uint32_t*>(M);
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[D / 16][4];
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      const int w = ((16 * mt + g) * D + 16 * ks + 2 * t) >> 1;
      a[mt][0] = __ldg(Mw + w);
      a[mt][1] = __ldg(Mw + w + 4 * D);  // row + 8
      a[mt][2] = __ldg(Mw + w + 4);      // column + 8
      a[mt][3] = __ldg(Mw + w + 4 * D + 4);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(
          T + (8 * nt + g) * Ld + 16 * ks + 2 * t);
      const uint32_t b0 = b[0];
      const uint32_t b1 = b[4];  // component + 8
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// Two floats as the bits of two bfloat16 values, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bfloat16 state: as the float32 tile_propagate_reweight above, the
// warp's 32 particles (lane: particle p, ancestor a), with the law of the
// header comment.
template <int D>
__device__ __forceinline__ void tile_propagate_reweight(
    const StepModelT<__nv_bfloat16>& m, float* smem,
    const __nv_bfloat16* __restrict__ X, long long n, long long a,
    __nv_bfloat16* __restrict__ Xo, float* __restrict__ ll, long long p,
    const BitStream& bs, int zrow) {
  using L = TileLayout<D, __nv_bfloat16>;
  constexpr int MT = D / 16;
  constexpr int Ld = L::kLd;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float* R = smem + (threadIdx.x >> 5) * L::kPerWarp;
  __nv_bfloat16* T1 = reinterpret_cast<__nv_bfloat16*>(R + L::kT1);
  __nv_bfloat16* T2 = reinterpret_cast<__nv_bfloat16*>(R + L::kT2);
  float* scale = R + L::kScale;

  // 1. the ancestor's column, loaded into registers while the normals are
  // drawn into R (the float32 design's Philox loops).
  const unsigned short* Xs = reinterpret_cast<const unsigned short*>(X);
  uint32_t xa[D / 2];
#pragma unroll
  for (int c = 0; c < D; c += 2) {
    const uint32_t lo = __ldg(Xs + static_cast<long long>(c) * n + a);
    const uint32_t hi = __ldg(Xs + static_cast<long long>(c + 1) * n + a);
    xa[c / 2] = lo | (hi << 16);
  }
#pragma unroll 3
  for (int grp = zrow >> 2; grp <= (zrow + D - 1) >> 2; ++grp) {
    const uint4 w = philox4x32_10(
        make_uint4(bs.lane, static_cast<uint32_t>(grp), bs.stream, 0u),
        bs.key);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * grp + j - zrow;
      if (r >= 0 && r < D) R[r * kTileLd + lane] = to_uniform(wv[j]);
    }
  }
#pragma unroll 3
  for (int grp = (zrow + D) >> 2; grp <= (zrow + 2 * D - 1) >> 2; ++grp) {
    const uint4 w = philox4x32_10(
        make_uint4(bs.lane, static_cast<uint32_t>(grp), bs.stream, 0u),
        bs.key);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * grp + j - zrow - D;
      if (r >= 0 && r < D) {
        float* z = R + r * kTileLd + lane;
        *z = box_muller(*z, to_uniform(wv[j]));
      }
    }
  }
  BitStream bc(bs.key, bs.lane, bs.stream);  // the chi-square rows
  float s1[1] = {1.0f};
  if (m.mvt) mvt_scales(bc, zrow + 2 * D, m, s1);
  scale[lane] = s1[0];
  // Each lane's row of T1 (its ancestor) and of T2 (its normals, rounded
  // to bfloat16), eight components a 16-byte store.
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    *reinterpret_cast<uint4*>(T1 + lane * Ld + c) =
        make_uint4(xa[c / 2], xa[c / 2 + 1], xa[c / 2 + 2], xa[c / 2 + 3]);
    uint32_t z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      z[j] = pack_bf16(R[(c + 2 * j) * kTileLd + lane],
                       R[(c + 2 * j + 1) * kTileLd + lane]);
    }
    *reinterpret_cast<uint4*>(T2 + lane * Ld + c) =
        make_uint4(z[0], z[1], z[2], z[3]);
  }
  __syncwarp();

  // 2. x_new = round(G x_anc + (Q z) s), into T1 (particle-major) once
  // every read of T1 is done.
  float xn[MT][4][4];
  {
    float qz[MT][4][4];
    tile_product_bf16<D>(m.Q, T2, qz);
    if (m.mvt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float s0 = scale[8 * nt + 2 * t];
        const float s1 = scale[8 * nt + 2 * t + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          qz[mt][nt][0] = __fmul_rn(qz[mt][nt][0], s0);
          qz[mt][nt][1] = __fmul_rn(qz[mt][nt][1], s1);
          qz[mt][nt][2] = __fmul_rn(qz[mt][nt][2], s0);
          qz[mt][nt][3] = __fmul_rn(qz[mt][nt][3], s1);
        }
      }
    }
    tile_product_bf16<D>(m.G, T1, xn);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xn[mt][nt][e] = __fadd_rn(xn[mt][nt][e], qz[mt][nt][e]);
        }
      }
    }
  }
  __syncwarp();  // every read of T1 is done
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // (row 16 mt + g (+8 for e >= 2), particle 8 nt + 2 t (+1 for odd e))
      __nv_bfloat16* c = T1 + (8 * nt + 2 * t) * Ld + 16 * mt + g;
      c[0] = __float2bfloat16_rn(xn[mt][nt][0]);
      c[Ld] = __float2bfloat16_rn(xn[mt][nt][1]);
      c[8] = __float2bfloat16_rn(xn[mt][nt][2]);
      c[Ld + 8] = __float2bfloat16_rn(xn[mt][nt][3]);
    }
  }
  __syncwarp();
  // Column p of Xo from the lane's row of T1: coalesced along p.
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(T1 + lane * Ld + c);
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      reinterpret_cast<unsigned short*>(Xo)[static_cast<long long>(c + j) *
                                                n + p] =
          static_cast<unsigned short>(vw[j / 2] >> (16 * (j & 1)));
    }
  }

  // 3. res = y - F x_new (x_new the stored bfloat16 state), into R.
  {
    float fx[MT][4][4];
    tile_product_bf16<D>(m.F, T1, fx);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float y0 = __ldg(m.y + 16 * mt + g);
      const float y1 = __ldg(m.y + 16 * mt + g + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        fx[mt][nt][0] = __fsub_rn(y0, fx[mt][nt][0]);
        fx[mt][nt][1] = __fsub_rn(y0, fx[mt][nt][1]);
        fx[mt][nt][2] = __fsub_rn(y1, fx[mt][nt][2]);
        fx[mt][nt][3] = __fsub_rn(y1, fx[mt][nt][3]);
      }
    }
    store_tile<D>(R, fx);
  }
  __syncwarp();  // R holds res

  // 4. quad = |Li res|^2, 3xTF32 in float32, and ll: as the float32
  // design.
  float lr[MT][4][4];
  tile_product<D>(m.Li, R, lr);
  float q[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.0f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        s = fmaf(lr[mt][nt][e], lr[mt][nt][e], s);
        s = fmaf(lr[mt][nt][e + 2], lr[mt][nt][e + 2], s);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s = __fadd_rn(s, __shfl_xor_sync(kFullMask, s, off));
      }
      q[nt][e] = s;
    }
  }
  if (g == 0) {  // lanes 0..3 hold the totals of columns 8 nt + 2 t (+1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      scale[8 * nt + 2 * t] = q[nt][0];
      scale[8 * nt + 2 * t + 1] = q[nt][1];
    }
  }
  __syncwarp();
  const float quad = scale[lane];
  if (m.mvt) {
    const float half_dfk =
        __fmul_rn(0.5f, __fadd_rn(m.df, static_cast<float>(D)));
    ll[p] = __fsub_rn(m.log_norm,
                      __fmul_rn(half_dfk, log1pf(__fdiv_rn(quad, m.df))));
  } else {
    ll[p] = __fsub_rn(m.log_norm, __fmul_rn(0.5f, quad));
  }
}

}  // namespace cusmc
