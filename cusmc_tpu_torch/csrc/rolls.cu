// Roll-Metropolis resample in exp space: B sweeps, the apply and the
// ancestors in one pass.
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
// are consecutive, so the B weight reads are coalesced and hit L2, and the
// state is read once at the winner.
//
// The state is float32 or, under mixed precision, bfloat16 (the element
// type T); the walk, the uniforms and the ancestors are float32 and int32
// either way, and the apply copies the winner's bits, so it is exact.
//
// Bound on the card: memory. Per particle it reads B uniforms (4B bytes),
// B + 1 weights (mostly L2), d state values at the winner, and writes d
// state values and one ancestor: 4B + 2 s d + 8 bytes of device traffic for
// s-byte state values, about 60 MB at N = 2^20, B = 10, d = 2, float32.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
roll_metropolis_kernel(const float* __restrict__ w,
                       const int* __restrict__ shifts,
                       const float* __restrict__ u,
                       const T* __restrict__ X, T* __restrict__ out,
                       int* __restrict__ anc, long long n, int num_sweeps,
                       int d) {
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
  for (int b = 0; b < num_sweeps; ++b) {
    long long j = i + shift_mod[b];
    if (j >= n) j -= n;
    const float w_cand = w[j];
    const float ub = u[static_cast<long long>(b) * n + i];
    if (__fmul_rn(ub, w_cur) < w_cand) {
      w_cur = w_cand;
      a = j;
    }
  }
  anc[i] = static_cast<int>(a);
  for (int r = 0; r < d; ++r) {
    const long long row = static_cast<long long>(r) * n;
    out[row + i] = X[row + a];
  }
}

}  // namespace

// w [n] f32, shifts [B] int32, u [B, n] f32, X [d, n] (contiguous; f32, or
// bf16 when bf16 != 0) -> out [d, n] of X's type and anc [n] int32.
CUSMC_EXPORT int cusmc_roll_metropolis(const float* w, const int* shifts,
                                       const float* u, const void* X,
                                       void* out, int* anc, long long n,
                                       int num_sweeps, int d, int bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem = sizeof(long long) * (num_sweeps > 0 ? num_sweeps : 1);
  if (bf16) {
    roll_metropolis_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        w, shifts, u, static_cast<const __nv_bfloat16*>(X),
        static_cast<__nv_bfloat16*>(out), anc, n, num_sweeps, d);
  } else {
    roll_metropolis_kernel<float><<<blocks, kThreads, smem, s>>>(
        w, shifts, u, static_cast<const float*>(X), static_cast<float*>(out),
        anc, n, num_sweeps, d);
  }
  return static_cast<int>(cudaGetLastError());
}
