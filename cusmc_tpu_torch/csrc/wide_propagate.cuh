// Propagate and reweight particles on tensor-core tiles at the widths past
// 16: the "tile" design of both fused step kernels (fused_step.cu,
// fused_cdf_step.cu) at padded widths (DM, KM) from
// ops/fused_step.py::step_widths, DM in {32, 64, 128} at least d (at least
// max(d, k) when k > 1), KM = 16 for k <= 16, else DM. d = k in {16, 32}
// keep tile_propagate.cuh's exact widths.
//
// The arithmetic is tile_propagate.cuh's, per particle:
//   x_new = G x[:, a] + (Q z) s,  res = y - F x_new,
//   quad = |Li res|^2,  ll = log_norm - ... (MVN or MVT, with the real k),
// with the same Philox rows (the d first Box-Muller uniforms, their d
// partners, then the chi-square rows: the padding draws no row), the four
// products as mma.sync m16n8k8 TF32 tiles over each warp's 32 particles,
// 3xTF32 in float32 (the kernel is held to its float32 plain version at
// 1e-4). What changes, and why:
//   - Zero padding. d and k are known at run time only. The matrices are
//     read unpadded and their panels (below) hold zeros outside [d|k x
//     d|k]; the tile's rows from d on are zero, so every padded term adds
//     an exact zero.
//   - One state tile a warp, T [DM x 32] float32, its columns swizzled
//     (sw) instead of padded, and no tile of normals. Each product keeps
//     its whole result, [DM x 32], in the warp's registers, the k-steps
//     outermost, so T can take the product's output once it is done: it
//     holds the ancestors, then G x, then x_new, then the residuals. The
//     normals are drawn a k-step (8 rows) at a time into an [8 x 32] tile
//     Z, just before the Q product's k-step reads them. A warp's part is
//     17.1 KB at DM = 128 (tile_propagate.cuh's two 40-float-row tiles
//     would take 41 KB), and the products' accumulators 128 registers a
//     lane. Only the tiles that hold a row and a column of the unpadded
//     matrix run: at d = 2, k = 64 the Q and G products take one m-tile
//     and one k-step of their 4 x 8.
//   - The matrices' k-panels in shared memory for the whole block. Every
//     warp would otherwise read, guard and split all four matrices for its
//     32 particles: 256 KB a warp at DM = 128, 8 GB of L2 reads a step at
//     N = 2^20. Here the block's warps stage each k-step's panel once: a
//     lane loads one A fragment (four guarded elements) of its warp's
//     m-tiles, splits it into TF32 big and small and stores both in
//     fragment order, so that every warp then reads a fragment as two
//     conflict-free 16-byte loads. Two buffers and one barrier a k-step;
//     the next step's loads fly while this step's normals are drawn and its
//     mma run. (Two k-steps a barrier ran 3-10% slower on the card.)
//   - G x runs first and waits in T, unrounded, while Q z runs; then
//     x_new = fl(G x + fl((Q z) s)), one IEEE rounding of the sum, the
//     rounding points of tile_propagate.cuh and of the plain version.
//     (Adding G x into (Q z) s on the tensor cores, whose accumulation is
//     not IEEE, ran 6-10% faster but put 235 of 2^26 bfloat16 states one
//     ulp off the plain version's, where this order puts 0-3.)
//   - A bfloat16 state: G, Q and F, the normals (rounded to bfloat16, the
//     law of propagate.cuh), the ancestors and x_new (rounded once to the
//     stored state) are bfloat16 values, exact in TF32, so their products
//     take one mma pass, not three: products exact, summed in float32,
//     the law of the TPU kernel's bfloat16 pass. Li and the residuals stay
//     float32 (3xTF32). The ancestors are copied as 4-byte words (the
//     element and its neighbour column) with cp.async and cut to the
//     element in place.
//
// Shared memory (dynamic, WideLayout<DM, KM>::bytes(warps)): the block's
// panel ring (2 buffers x 2 halves x DM/16 fragments x 32 lanes x 16
// bytes), then each warp's T, Z and 32 MVT scales: 84.5 KB a block of 4
// warps at DM = 128 (two blocks an SM, 219-231 registers), 44.5 KB at 64
// (three blocks: at four, 128 registers, the kernels spilled) and 24.5 KB
// at 32 (four blocks).
#pragma once

#include <type_traits>

#include "tile_propagate.cuh"

namespace cusmc {

constexpr int kWideWarps = 4;  // warps a block, in both kernels

template <int DM, int KM>
struct WideLayout {
  static_assert((DM == 32 || DM == 64 || DM == 128) &&
                    (KM == 16 || KM == DM),
                "DM in {32, 64, 128}, KM in {16, DM}");
  static constexpr int kMT = DM / 16;  // m-tiles, widest product
  // The panel ring: two buffers of (big, small) x kMT fragments x 32 lanes
  // x 4 floats.
  static constexpr int kRing = 2 * 2 * kMT * 128;
  static constexpr int kZ = DM * 32;  // offsets in a warp's part
  static constexpr int kScale = kZ + 8 * 32;
  static constexpr int kPerWarp = kScale + 32;
  static constexpr size_t bytes(int warps) {
    return sizeof(float) * (kRing + static_cast<size_t>(warps) * kPerWarp);
  }
};

// Element (r, c) of a [rows x 32] float tile: column c XORed with
// 8 (r mod 4). A lane's column writes, the B fragments' loads (rows t and
// t + 4, columns g + 8 nt) and the accumulators' float2 stores (rows g,
// columns 2 t + 8 nt) all hit distinct banks.
__device__ __forceinline__ int sw(int r, int c) {
  return (r << 5) + (c ^ ((r & 3) << 3));
}

// *p widened to float32, through the read-only cache.
__device__ __forceinline__ float load_widened(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_widened(const __nv_bfloat16* p) {
  const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// The A fragments of k-step ks that lane (g, t) of warp `warp` stages:
// m-tiles warp, warp + kWideWarps, ... of M [rows x cols] (row-major,
// widened to float32, zero outside), each as its four elements (16 mt + g,
// 8 ks + t), (+8, .), (., +4), (+8, +4).
template <int MT, bool kExact>
struct Panel {
  static constexpr int kPer = (MT + kWideWarps - 1) / kWideWarps;
  float4 v[kPer];

  template <typename E>
  __device__ __forceinline__ void load(const E* __restrict__ M, int rows,
                                       int cols, int ks, int warp, int g,
                                       int t) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r0 = 16 * (warp + j * kWideWarps) + g;
      const int c0 = 8 * ks + t;
      const bool in0 = r0 < rows;
      const bool in1 = r0 + 8 < rows;
      const bool ic0 = c0 < cols;
      const bool ic1 = c0 + 4 < cols;
      const E* m0 = M + r0 * cols + c0;
      v[j] = make_float4(
          in0 && ic0 ? load_widened(m0) : 0.0f,
          in1 && ic0 ? load_widened(m0 + 8 * cols) : 0.0f,
          in0 && ic1 ? load_widened(m0 + 4) : 0.0f,
          in1 && ic1 ? load_widened(m0 + 8 * cols + 4) : 0.0f);
    }
  }

  // Into one buffer of the ring: the big halves of the MT m-tiles, then
  // their small halves (kExact: the values as they are, no small half).
  __device__ __forceinline__ void store(float* buf, int warp,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int mt = warp + j * kWideWarps;
      if (mt < MT) {
        uint4* big = reinterpret_cast<uint4*>(buf) + mt * 32 + lane;
        if constexpr (kExact) {
          *big = make_uint4(__float_as_uint(v[j].x), __float_as_uint(v[j].y),
                            __float_as_uint(v[j].z), __float_as_uint(v[j].w));
        } else {
          uint4 b, s;
          split_tf32(v[j].x, b.x, s.x);
          split_tf32(v[j].y, b.y, s.y);
          split_tf32(v[j].z, b.z, s.z);
          split_tf32(v[j].w, b.w, s.w);
          *big = b;
          big[MT * 32] = s;
        }
      }
    }
  }
};

// acc[mt][nt] += M [rows x cols] (zero-padded to [16 MT x 8 KS]) times the
// warp's B [8 KS x 32] on m16n8k8 TF32 tiles, in the accumulator layout of
// tile_product (lane (g, t): rows 16 mt + g (+8), columns 8 nt + 2 t
// (+1)). Only the tiles that hold a row and a column of M run: m-tiles
// below ceil(rows / 16), k-steps below ceil(cols / 8) (the others add
// zeros). b(r, j) reads row r of particle column j; hook(ks) runs before
// k-step ks reads B and ends with a __syncwarp where it writes B. kExact:
// M and B hold values exact in TF32 (bfloat16 ones), one mma each in place
// of 3xTF32's three. Every thread of the block calls this at the same point
// with the same M: the panels are the block's. Each k-step's panel is
// loaded while the step before runs, and a barrier ends each step.
template <int MT, int KS, bool kExact, typename E, typename BRead,
          typename Hook>
__device__ __forceinline__ void wide_product(const E* __restrict__ M,
                                             int rows, int cols, float* ring,
                                             BRead b, Hook hook,
                                             float (&acc)[MT][4][4]) {
  constexpr int kBuf = 2 * MT * 128;  // floats a k-step's panel
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mts = (rows + 15) >> 4;
  const int kss = (cols + 7) >> 3;
  Panel<MT, kExact> panel;
  panel.load(M, rows, cols, 0, warp, g, t);
  panel.store(ring, warp, lane);
  __syncthreads();
#pragma unroll 1
  for (int ks = 0; ks < kss; ++ks) {
    if (ks + 1 < kss) panel.load(M, rows, cols, ks + 1, warp, g, t);
    hook(ks);
    uint32_t bb[4][2], bs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float x0 = b(8 * ks + t, 8 * nt + g);
      const float x1 = b(8 * ks + t + 4, 8 * nt + g);
      if constexpr (kExact) {
        bb[nt][0] = __float_as_uint(x0);
        bb[nt][1] = __float_as_uint(x1);
      } else {
        split_tf32(x0, bb[nt][0], bs[nt][0]);
        split_tf32(x1, bb[nt][1], bs[nt][1]);
      }
    }
    const uint4* big =
        reinterpret_cast<const uint4*>(ring + (ks & 1) * kBuf) + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mts) break;
      const uint4 ab = big[mt * 32];
      const uint32_t a[4] = {ab.x, ab.y, ab.z, ab.w};
      if constexpr (kExact) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], a, bb[nt][0], bb[nt][1]);
        }
      } else {
        const uint4 as4 = big[(MT + mt) * 32];
        const uint32_t as[4] = {as4.x, as4.y, as4.z, as4.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], as, bb[nt][0], bb[nt][1]);
          mma_tf32(acc[mt][nt], a, bs[nt][0], bs[nt][1]);
          mma_tf32(acc[mt][nt], a, bb[nt][0], bb[nt][1]);
        }
      }
    }
    if (ks + 1 < kss) panel.store(ring + ((ks + 1) & 1) * kBuf, warp, lane);
    __syncthreads();
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
}

// The accumulators into rows 0 .. 16 MT - 1 of the swizzled tile T, each
// value rounded to the state's type T first.
template <typename T, int MT>
__device__ __forceinline__ void store_rounded(float* tile,
                                              const float (&v)[MT][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = 16 * mt + g;
      const int c = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(tile + sw(r, c)) =
          make_float2(round_to<T>(v[mt][nt][0]), round_to<T>(v[mt][nt][1]));
      *reinterpret_cast<float2*>(tile + sw(r + 8, c)) =
          make_float2(round_to<T>(v[mt][nt][2]), round_to<T>(v[mt][nt][3]));
    }
  }
}

// Propagates the warp's 32 particles (lane: particle p, ancestor a) and
// writes Xo[:, p] and ll[p]; p is consecutive across the warp's lanes.
// smem is the block's dynamic shared memory (WideLayout<DM, KM>); every
// thread of the block calls this. `rows` holds the particle's Philox rows
// (cursor one may hold a group drawn before); the noise rows start at zrow.
template <int DM, int KM, typename T>
__device__ __forceinline__ void wide_propagate_reweight(
    const StepModelT<T>& m, float* smem, const T* __restrict__ X,
    unsigned n, unsigned a, T* __restrict__ Xo, float* __restrict__ ll,
    unsigned p, RowCursors<1>& rows, int zrow) {
  using L = WideLayout<DM, KM>;
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  constexpr int MT = DM / 16;
  constexpr int KMT = KM / 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d = m.d;
  const int k = m.k;
  float* ring = smem;
  float* tile = smem + L::kRing + (threadIdx.x >> 5) * L::kPerWarp;
  float* Z = tile + L::kZ;
  float* scale = tile + L::kScale;
  const auto from_tile = [tile](int r, int j) { return tile[sw(r, j)]; };
  const auto no_hook = [](int) {};

  // 1. The ancestor's column (4-byte words; bfloat16: the word that holds
  // the element), zero rows from d on.
#pragma unroll 8
  for (int c = 0; c < DM; ++c) {
    if (c < d) {
      const T* src = X + static_cast<size_t>(c) * n + (kBf16 ? a & ~1u : a);
      cp_async4(tile + sw(c, lane), reinterpret_cast<const float*>(src));
    } else {
      tile[sw(c, lane)] = 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. G x_anc, kept unrounded in T (every read of T ended at the
  // product's last barrier). The column lands while the product stages its
  // first panel.
  float acc[MT][4][4];
  zero(acc);
  wide_product<MT, DM / 8, kBf16>(
      m.G, d, d, ring, from_tile,
      [&](int ks) {
        if (ks > 0) return;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        if constexpr (kBf16) {  // the element's half of its word, widened
          const int shift = (a & 1u) ? 16 : 0;
          for (int c = 0; c < d; ++c) {
            float* w = tile + sw(c, lane);
            *w = __uint_as_float((__float_as_uint(*w) >> shift) << 16);
          }
        }
        __syncwarp();
      },
      acc);
  store_rounded<float>(tile, acc);

  // 3. Q z, k-step ks drawing the normals of rows 8 ks .. 8 ks + 7 into Z
  // (cursor one the first uniforms, cursor two their partners).
  zero(acc);
  rows.start_second(zrow + d);
  wide_product<MT, DM / 8, kBf16>(
      m.Q, d, d, ring, [Z](int r, int j) { return Z[sw(r & 7, j)]; },
      [&](int ks) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = 8 * ks + j;
          float z = 0.0f;
          if (r < d) {
            uint32_t w1[1], w2[1];
            rows.first(zrow + r, w1);
            rows.second(zrow + d + r, w2);
            z = round_to<T>(box_muller(to_uniform(w1[0]), to_uniform(w2[0])));
          }
          Z[sw(j, lane)] = z;
        }
        __syncwarp();
      },
      acc);

  // 4. (Q z) s: the chi-square rows follow the partners on cursor two.
  if (m.mvt) {
    float sc[1];
    mvt_scales(rows, zrow + 2 * d, m, sc);
    scale[lane] = sc[0];
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float s0 = scale[8 * nt + 2 * t];
      const float s1 = scale[8 * nt + 2 * t + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][nt][0] = __fmul_rn(acc[mt][nt][0], s0);
        acc[mt][nt][1] = __fmul_rn(acc[mt][nt][1], s1);
        acc[mt][nt][2] = __fmul_rn(acc[mt][nt][2], s0);
        acc[mt][nt][3] = __fmul_rn(acc[mt][nt][3], s1);
      }
    }
  }

  // 5. x_new = G x + (Q z) s, one rounding of the sum (tile_propagate.cuh's
  // order), then rounded to the state's type: into T, each lane at its own
  // accumulators' places, then column p of Xo, coalesced along p.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* x = reinterpret_cast<float2*>(
            tile + sw(16 * mt + g + 8 * h, 8 * nt + 2 * t));
        const float2 gx = *x;
        *x = make_float2(
            round_to<T>(__fadd_rn(gx.x, acc[mt][nt][2 * h])),
            round_to<T>(__fadd_rn(gx.y, acc[mt][nt][2 * h + 1])));
      }
    }
  }
  __syncwarp();
#pragma unroll 8
  for (int c = 0; c < d; ++c) {
    Xo[static_cast<size_t>(c) * n + p] = narrow<T>(tile[sw(c, lane)]);
  }

  // 6. res = y - F x_new (x_new the stored state), into T's first KM rows.
  float fx[KMT][4][4];
  zero(fx);
  wide_product<KMT, DM / 8, kBf16>(m.F, k, d, ring, from_tile, no_hook, fx);
#pragma unroll
  for (int mt = 0; mt < KMT; ++mt) {
    const int r = 16 * mt + g;
    const float y0 = r < k ? __ldg(m.y + r) : 0.0f;
    const float y1 = r + 8 < k ? __ldg(m.y + r + 8) : 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      fx[mt][nt][0] = __fsub_rn(y0, fx[mt][nt][0]);
      fx[mt][nt][1] = __fsub_rn(y0, fx[mt][nt][1]);
      fx[mt][nt][2] = __fsub_rn(y1, fx[mt][nt][2]);
      fx[mt][nt][3] = __fsub_rn(y1, fx[mt][nt][3]);
    }
  }
  store_rounded<float>(tile, fx);
  __syncwarp();

  // 7. quad = |Li res|^2: each lane's rows, then the 8 row groups (lanes
  // g = 0..7 of the same t) over shuffles; ll with the real k.
  float lr[KMT][4][4];
  zero(lr);
  wide_product<KMT, KM / 8, false>(m.Li, k, k, ring, from_tile, no_hook, lr);
  float q[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.0f;
#pragma unroll
      for (int mt = 0; mt < KMT; ++mt) {
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
  ll[p] = reweight(m, scale[lane]);
}

}  // namespace cusmc
