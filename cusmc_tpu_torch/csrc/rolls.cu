// Roll-Metropolis resample in exp space: B sweeps, the apply and the
// ancestors, in one pass while the state fits L2, else band by band.
//
// Replaces the XLA roll sweeps of
// cusmc_tpu/resampling/rolls.py::roll_metropolis_sweeps_expspace
// (roll_metropolis_weight_walk + apply_winning_rolls + winning_ancestors,
// rolls.py:57-117), which reach no Pallas kernel on the TPU. Sweep b
// proposes j = (i + s_b) mod n for every chain i, with one shift per sweep
// (jnp.roll(w, -s)[i] == w[(i + s) mod n]); chain i accepts iff
// u[b, i] * w_cur < w[j], in float32 and strict, so a 0/0 pair rejects
// (rolls.py:46-51,74). The winner is the last accepted proposal; then
// a[i] = winner and out[r, i] = X[r, a[i]].
//
// On the TPU the walk runs as lane rotations and the apply as a (B+1)-way
// select over rotated copies of X, because a random gather is slow there.
// On Hopper one thread per chain reads w[j] directly: within a warp the j
// are consecutive, so the B weight reads are coalesced and hit L2.
//
// The state is float32 or, under mixed precision, bfloat16; the walk, the
// uniforms and the ancestors are float32 and int32 either way, and the
// apply copies the winner's bits, so it is exact.
//
// Bound on the card: memory. Per particle the call must read B uniforms
// (4B bytes), its weight (4; the B proposals' reads hit L2), d state values
// at the winner, and write d state values and one ancestor: 4B + 2 s d + 8
// bytes for s-byte state values (60 MB at N = 2^20, B = 10, d = 2, float32;
// 319 MB at d = 32).
//
// What a single pass loses once X outgrows L2: a thread reads its winner's
// column row by row, a = i + s_b for one of the B + 1 shifts that all
// chains share, so across the grid B + 1 "fronts" sweep every row of X at
// offsets far apart, and each uses only part of every 32-byte sector it
// fetches (a warp's lanes split between the fronts). While X fits L2 the
// other fronts find those sectors there; once it does not, a sector comes
// from device memory about once per front that touches it. On the H100
// (N = 2^20, B = 10, d = 32 float32) one pass takes 0.12 ms when every
// chain keeps itself or all take the same shift, 0.42 ms on spread winners.
//
// The banded design, taken when X does not fit a share of L2
// (resampling/rolls.py::roll_band_rows): launch 1 is the one-pass kernel
// over the rows of band 0; launch 2 copies the other rows band by band
// (blockIdx.y; blocks go out band-major), each band a few MB, so that it
// stays in L2 while every front sweeps it: a sector of X is fetched from
// device memory once and the other fronts hit L2. The uniforms are read
// and the output written with the streaming hints (evict first), so that
// they do not push the band out. A thread of launch 2 takes
// kApplyParticles particles, for more loads in flight. Each band after the
// first reads the ancestors again: 4 bytes a particle a band (63 MB at
// d = 32 float32, 15 bands of 2 rows after the first, mostly from L2),
// beyond the bound above. What remains over the bound is the fronts' partial sectors, now
// served by L2: a cost per warp and row, not per byte, so a bfloat16 state,
// with half the bytes, pays as much of it as a float32 one (PERF.md).
// Particle-major records of each band (a transpose through L2, then whole
// sectors gathered) were measured slower: the transpose's traffic and two
// launches a band cost more than the partial sectors.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWalkBatch = 5;    // sweeps whose loads one thread has in flight
constexpr int kApplyUnroll = 8;  // values whose loads a thread has in flight
constexpr int kApplyParticles = 4;  // particles a thread of the band apply

// out[r, i] = X[r, a] for r < rows (row stride n), the loads of
// kApplyUnroll rows in flight before their stores.
template <typename W>
__device__ __forceinline__ void copy_rows(const W* __restrict__ X,
                                          W* __restrict__ out, long long n,
                                          long long i, long long a,
                                          int rows) {
  const W* src = X + a;
  W* dst = out + i;
  int r = 0;
  for (; r + kApplyUnroll <= rows; r += kApplyUnroll) {
    W v[kApplyUnroll];
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) v[k] = src[k * n];
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) __stcs(dst + k * n, v[k]);
    src += kApplyUnroll * n;
    dst += kApplyUnroll * n;
  }
  for (; r < rows; ++r) {
    __stcs(dst, *src);
    src += n;
    dst += n;
  }
}

// The walk and the apply of rows [0, rows), in one pass; W the state's bits
// (32 or 16). With rows = 0 it is the walk alone.
template <typename W>
__global__ void __launch_bounds__(kThreads)
roll_metropolis_kernel(const float* __restrict__ w,
                       const int* __restrict__ shifts,
                       const float* __restrict__ u,
                       const W* __restrict__ X, W* __restrict__ out,
                       int* __restrict__ anc, long long n, int num_sweeps,
                       int rows) {
  // Shifts reduced into [0, n) once per block, so any int32 shift is safe.
  extern __shared__ long long shift_mod[];
  for (int b = threadIdx.x; b < num_sweeps; b += blockDim.x) {
    long long s = static_cast<long long>(shifts[b]) % n;
    shift_mod[b] = s < 0 ? s + n : s;
  }
  __syncthreads();
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float w_cur = w[i];
  long long a = i;
  // The sweeps' loads do not depend on the accept chain: a batch's loads
  // are issued together, then its accept tests run in sweep order.
  int b = 0;
  for (; b + kWalkBatch <= num_sweeps; b += kWalkBatch) {
    long long j[kWalkBatch];
    float w_cand[kWalkBatch], ub[kWalkBatch];
#pragma unroll
    for (int k = 0; k < kWalkBatch; ++k) {
      j[k] = i + shift_mod[b + k];
      if (j[k] >= n) j[k] -= n;
      w_cand[k] = w[j[k]];
      ub[k] = __ldcs(u + static_cast<long long>(b + k) * n + i);
    }
#pragma unroll
    for (int k = 0; k < kWalkBatch; ++k) {
      if (__fmul_rn(ub[k], w_cur) < w_cand[k]) {
        w_cur = w_cand[k];
        a = j[k];
      }
    }
  }
  for (; b < num_sweeps; ++b) {
    long long j = i + shift_mod[b];
    if (j >= n) j -= n;
    const float w_cand = w[j];
    const float ub = __ldcs(u + static_cast<long long>(b) * n + i);
    if (__fmul_rn(ub, w_cur) < w_cand) {
      w_cur = w_cand;
      a = j;
    }
  }
  anc[i] = static_cast<int>(a);
  copy_rows(X, out, n, i, a, rows);
}

// Band blockIdx.y of launch 2: rows [y * band_rows, min(d, (y + 1) *
// band_rows)) of out[:, i] = X[:, anc[i]], counted from X's and out's
// first row given. A thread takes kApplyParticles particles, kThreads
// apart (a warp's lanes still take consecutive particles), and has the
// loads of kApplyUnroll of its values in flight before their stores.
template <typename W>
__global__ void __launch_bounds__(kThreads)
roll_apply_band_kernel(const W* __restrict__ X, const int* __restrict__ anc,
                       W* __restrict__ out, long long n, int d,
                       int band_rows) {
  constexpr int kP = kApplyParticles;
  constexpr int kRowsAtOnce = kApplyUnroll / kP;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * (kThreads * kP) + threadIdx.x;
  const int r0 = static_cast<int>(blockIdx.y) * band_rows;
  const int r1 = min(d, r0 + band_rows);
  long long a[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const long long i = i0 + k * kThreads;
    a[k] = i < n ? static_cast<long long>(anc[i]) : -1;
  }
  for (int r = r0; r < r1; r += kRowsAtOnce) {
    W v[kRowsAtOnce][kP];
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        if (r + q < r1 && a[k] >= 0) {
          v[q][k] = X[static_cast<long long>(r + q) * n + a[k]];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        if (r + q < r1 && a[k] >= 0) {
          __stcs(out + static_cast<long long>(r + q) * n + i0 + k * kThreads,
                 v[q][k]);
        }
      }
    }
  }
}

template <typename W>
int launch(const float* w, const int* shifts, const float* u, const void* X,
           void* out, int* anc, long long n, int num_sweeps, int d,
           int band_rows, cudaStream_t s) {
  const W* x = static_cast<const W*>(X);
  W* o = static_cast<W*>(out);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem = sizeof(long long) * (num_sweeps > 0 ? num_sweeps : 1);
  const int rows0 = band_rows < d ? band_rows : d;
  roll_metropolis_kernel<W><<<blocks, kThreads, smem, s>>>(
      w, shifts, u, x, o, anc, n, num_sweeps, rows0);
  if (rows0 == d) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long skip = static_cast<long long>(rows0) * n;
  constexpr long long kTile = kThreads * kApplyParticles;
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>((d - rows0 + band_rows - 1) /
                                        band_rows));
  roll_apply_band_kernel<W><<<grid, kThreads, 0, s>>>(
      x + skip, anc, o + skip, n, d - rows0, band_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w [n] f32, shifts [B] int32, u [B, n] f32, X [d, n] (contiguous; f32, or
// bf16 when bf16 != 0) -> out [d, n] of X's type and anc [n] int32. With
// 0 < band_rows < d: band 0's rows in the walk's launch, then the other
// rows in bands of band_rows (two launches); otherwise one pass.
CUSMC_EXPORT int cusmc_roll_metropolis(const float* w, const int* shifts,
                                       const float* u, const void* X,
                                       void* out, int* anc, long long n,
                                       int num_sweeps, int d, int bf16,
                                       int band_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_rows < 1) band_rows = d;
  return bf16 ? launch<unsigned short>(w, shifts, u, X, out, anc, n,
                                       num_sweeps, d, band_rows, s)
              : launch<unsigned int>(w, shifts, u, X, out, anc, n,
                                     num_sweeps, d, band_rows, s);
}
