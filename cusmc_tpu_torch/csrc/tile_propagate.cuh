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
#pragma once

#include <cstdint>

#include "propagate.cuh"

namespace cusmc {

constexpr int kTileP = 32;   // particles of a warp tile
constexpr int kTileLd = 40;  // padded tile row: fragment loads conflict-free

template <int D>
struct TileLayout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 32, "d = k in {16, 32}");
  static constexpr int kT2 = D * kTileLd;  // offsets within a warp's part
  static constexpr int kScale = 2 * D * kTileLd;
  static constexpr int kPerWarp = kScale + kTileP;
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
  scale[lane] = m.mvt ? mvt_scale(bc, zrow + 2 * D, m) : 1.0f;
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

}  // namespace cusmc
