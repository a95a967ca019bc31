// The branch-free forms of csrc/jacobi_pose.cuh against the IEEE
// intrinsics they stand for, to run on the card (chip_smoke.py) and on the
// host stand-in (tests/test_torch_k24_cluster_emulated.py). Not part of the
// port's path. Each entry counts into `out` (device memory, zeroed by the
// caller): [0] the operands whose forms differ from the intrinsic's bits,
// [1] the operands checked, [2] (quotients) those outside the proven range,
// which a solve sends to its IEEE rerun and which are not compared.
//
// - roots: fast_root(x) against __fsqrt_rn(x) for the floats whose bits
//   are first .. first + count - 1 (every float of [1, 2^128): first =
//   0x3f800000, count = 0x40000000);
// - reciprocals: fast_reciprocal(x) against __fdiv_rn(1, x), the same way
//   (every float of [1, 2^126]: count = 0x3f000001);
// - reciprocal roots: fast_rcp_root(x) against __fdiv_rn(1, __fsqrt_rn(x)),
//   the same way (every float of [1, 2]: count = 0x800001);
// - quotients: fast_quotient(a, b) against __fdiv_rn(a, b) on `count`
//   pairs drawn from a hash of (seed, i): signs, exponents of a and b in
//   [-130, 130] and mantissas uniform (the pairs out of range counted
//   apart); and on every exponent boundary: a, b each +-2^e and its two
//   neighbours for e in [-126, 126] (1,530^2 ordered pairs with signs);
// - solves: jacobi_pose (the fast forms, rerun on the IEEE ones where an
//   operand leaves their range) and jacobi_pose_ieee on n sets of (H [9],
//   cA [3], cB [3]), a thread a set: both poses, to compare bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../jacobi_pose.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t float_bits(float x) {
  return static_cast<uint32_t>(__float_as_int(x));
}

// mismatches and checks of a thread, added once a thread
__device__ __forceinline__ void count(unsigned long long* out,
                                      unsigned long long bad,
                                      unsigned long long seen,
                                      unsigned long long skipped) {
  if (bad) atomicAdd(out, bad);
  if (seen) atomicAdd(out + 1, seen);
  if (skipped) atomicAdd(out + 2, skipped);
}

// the form `kind` of x and the IEEE value it stands for
__device__ __forceinline__ bool form_differs(int kind, float x) {
  if (kind == 0) return float_bits(fast_root(x)) != float_bits(__fsqrt_rn(x));
  if (kind == 1)
    return float_bits(fast_reciprocal(x)) != float_bits(__fdiv_rn(1.f, x));
  return float_bits(fast_rcp_root(x)) !=
         float_bits(__fdiv_rn(1.f, __fsqrt_rn(x)));
}

// kind 0: roots, 1: reciprocals, 2: reciprocal roots
__global__ void __launch_bounds__(kThreads)
    sweep(int kind, uint32_t first, uint32_t n, unsigned long long* out) {
  unsigned long long bad = 0, seen = 0;
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    bad += form_differs(kind, __int_as_float(static_cast<int>(first + i)));
    ++seen;
  }
  count(out, bad, seen, 0);
}

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// a float of sign, exponent in [-130, 130] and mantissa from h
__device__ __forceinline__ float draw(uint64_t h) {
  const int e = static_cast<int>((h >> 24) % 261) - 130;
  const uint32_t m = static_cast<uint32_t>(h) & 0x7FFFFFu;
  const float x = ldexpf(__int_as_float(static_cast<int>(0x3F800000u | m)),
                         e);
  return (h >> 63) ? -x : x;
}

// +-2^e and its neighbours, e in [-126, 126]: k in [0, kEdge)
constexpr uint32_t kEdge = 6 * 253;
__device__ __forceinline__ float boundary(int k) {
  const int e = k / 6 - 126, side = k % 3, neg = (k / 3) & 1;
  float x = ldexpf(1.f, e);
  if (side == 1) x = nextafterf(x, 0.f);
  if (side == 2) x = nextafterf(x, 2.f * x);
  return neg ? -x : x;
}

__device__ __forceinline__ void compare(float a, float b,
                                        unsigned long long& bad,
                                        unsigned long long& seen,
                                        unsigned long long& skipped) {
  if (quotient_off(a, b)) {
    ++skipped;
    return;
  }
  ++seen;
  bad += float_bits(fast_quotient(a, b)) != float_bits(__fdiv_rn(a, b));
}

// n random pairs from `seed`, then (boundaries) every boundary pair
__global__ void __launch_bounds__(kThreads)
    quotients(uint64_t seed, uint32_t n, int boundaries,
              unsigned long long* out) {
  unsigned long long bad = 0, seen = 0, skipped = 0;
  const uint32_t stride = gridDim.x * kThreads;
  const uint32_t t0 = blockIdx.x * kThreads + threadIdx.x;
  for (uint32_t i = t0; i < n; i += stride) {
    const uint64_t h = mix(seed * 0x9E3779B97F4A7C15ull + i);
    compare(draw(h), draw(mix(h + 0x632BE59BD9B4E019ull)), bad, seen,
            skipped);
  }
  if (boundaries)
    for (uint32_t i = t0; i < kEdge * kEdge; i += stride)
      compare(boundary(i / kEdge), boundary(i % kEdge), bad, seen, skipped);
  count(out, bad, seen, skipped);
}

// sets [n][15]: H (9), cA (3), cB (3); poses [n][16] each way
__global__ void __launch_bounds__(kThreads)
    solves(const float* __restrict__ sets, int n, float* __restrict__ fast,
           float* __restrict__ ieee) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* s = sets + 15ll * i;
  jacobi_pose(s, s + 9, s + 12, fast + 16ll * i);
  jacobi_pose_ieee(s, s + 9, s + 12, ieee + 16ll * i);
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// kind 0: fast_root against __fsqrt_rn, 1: fast_reciprocal against
// __fdiv_rn(1, x), 2: fast_rcp_root against __fdiv_rn(1, __fsqrt_rn(x)), on
// the floats of bits [first, first + n).
extern "C" int eyoc_jacobi_forms_sweep(int kind, unsigned first, unsigned n,
                                       unsigned long long* out,
                                       cudaStream_t stream) {
  sweep<<<blocks_for(n), kThreads, 0, stream>>>(kind, first, n, out);
  return cudaGetLastError();
}

// fast_quotient against __fdiv_rn on n pairs drawn from `seed` and, with
// `boundaries`, every exponent boundary pair.
extern "C" int eyoc_jacobi_forms_quotients(unsigned long long seed,
                                           unsigned n, int boundaries,
                                           unsigned long long* out,
                                           cudaStream_t stream) {
  const long long work = boundaries ? (long long)n + kEdge * kEdge : n;
  quotients<<<blocks_for(work), kThreads, 0, stream>>>(seed, n, boundaries,
                                                       out);
  return cudaGetLastError();
}

// jacobi_pose and jacobi_pose_ieee on sets [n][15] -> fast, ieee [n][16].
extern "C" int eyoc_jacobi_forms_solves(const float* sets, int n, float* fast,
                                        float* ieee, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  solves<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(sets, n,
                                                                 fast, ieee);
  return cudaGetLastError();
}

// The solves that ran again on the IEEE forms, since the library was loaded.
extern "C" int eyoc_jacobi_forms_reruns(unsigned long long* out) {
  return jacobi_reruns_read(out);
}
