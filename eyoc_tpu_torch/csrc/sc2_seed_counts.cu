// K4 sc2_seed_counts: SC2-PCR's second-order compatibility on the seed rows,
// as exact integer counts.
//
// Replaces eyoc_tpu/registration/sc2pcr.py:sc2_pcr (:296-300), which builds
// the [N, N] bf16 masks `hard` and `hard_tight` and runs the
// [S, N] @ [N, N] product on the matrix unit:
//
//   SC2[s, j] = hard[seed_s, j] * sum_k tight[seed_s, k] * tight[k, j]
//   hard = valid pair & |dS - dT| < d,  tight = valid pair & |dS - dT| < d/2
//
// What bounds it: S * N * N binary multiply-adds (1000 x 5000 x 5000 =
// 25 G on the main path), i.e. operations.
// Design (bit-packing, chosen over an int8/bf16 tensor-core product): the
// tight matrix is packed once into [N, ceil(N/32)] uint32 rows (a warp
// evaluates 32 pairs and ballots them into one word, 3.1 MB at N = 5000);
// tight is symmetric, so column j of the product is row j of the packing,
// and each count is popc(row_seed & row_j) summed over 157 words. That is
// 32 binary products per AND+POPC, the [N, N] masks are never stored, and
// the counts are exact by construction with no float accumulation. A block
// stages 32 seed rows and 64 j rows, 32 words at a time, in shared memory;
// the `hard` factor is recomputed from the coordinates in the epilogue.
// Distances use the _rn intrinsics in the order sqrt((dx*dx + dy*dy) +
// dz*dz), so the threshold tests match the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeeds = 32;   // seed rows per block
constexpr int kCols = 64;    // j columns per block
constexpr int kWords = 32;   // words per shared-memory stage
constexpr int kThreads = 256;

__device__ __forceinline__ float dist3(const float* a, const float* b) {
  const float dx = __fsub_rn(a[0], b[0]);
  const float dy = __fsub_rn(a[1], b[1]);
  const float dz = __fsub_rn(a[2], b[2]);
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz)));
}

__device__ __forceinline__ float cross(const float* src, const float* tgt,
                                       int i, int j) {
  const float ds = dist3(src + 3 * i, src + 3 * j);
  const float dt = dist3(tgt + 3 * i, tgt + 3 * j);
  return fabsf(__fsub_rn(ds, dt));
}

// One warp per (row i, word w): lane b tests pair (i, 32 w + b).
__global__ void pack_tight(const float* __restrict__ src,
                           const float* __restrict__ tgt,
                           const uint8_t* __restrict__ valid, int n,
                           int words, float tight_thr,
                           uint32_t* __restrict__ bits) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)n * words) return;  // whole warps exit together
  const int i = (int)(warp / words);
  const int w = (int)(warp % words);
  const int j = w * 32 + lane;
  bool t = false;
  if (j < n && valid[i] && valid[j]) t = cross(src, tgt, i, j) < tight_thr;
  const uint32_t word = __ballot_sync(0xffffffffu, t);
  if (lane == 0) bits[(size_t)i * words + w] = word;
}

__global__ void __launch_bounds__(kThreads) seed_counts(
    const uint32_t* __restrict__ bits, int words,
    const int* __restrict__ seeds, int ns, const float* __restrict__ src,
    const float* __restrict__ tgt, const uint8_t* __restrict__ valid, int n,
    float hard_thr, float* __restrict__ out) {
  __shared__ uint32_t sb[kSeeds][kWords];
  __shared__ uint32_t jb[kCols][kWords + 1];
  __shared__ int srow[kSeeds];
  const int tx = threadIdx.x % kCols;       // column within the tile
  const int ty = threadIdx.x / kCols;       // 0..3: seed group
  const int j0 = blockIdx.x * kCols;
  const int s0 = blockIdx.y * kSeeds;
  constexpr int kPer = kSeeds / (kThreads / kCols);  // 8 seeds per thread
  if (threadIdx.x < kSeeds) {
    const int s = s0 + threadIdx.x;
    srow[threadIdx.x] = (s < ns) ? seeds[s] : -1;
  }
  __syncthreads();
  int cnt[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) cnt[k] = 0;

  for (int w0 = 0; w0 < words; w0 += kWords) {
    const int nw = min(kWords, words - w0);
    for (int e = threadIdx.x; e < kSeeds * kWords; e += kThreads) {
      const int r = e / kWords, c = e % kWords;
      const int row = srow[r];
      sb[r][c] = (row >= 0 && c < nw) ? bits[(size_t)row * words + w0 + c] : 0u;
    }
    for (int e = threadIdx.x; e < kCols * kWords; e += kThreads) {
      const int r = e / kWords, c = e % kWords;
      const int j = j0 + r;
      jb[r][c] = (j < n && c < nw) ? bits[(size_t)j * words + w0 + c] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < nw; ++c) {
      const uint32_t jw = jb[tx][c];
#pragma unroll
      for (int k = 0; k < kPer; ++k) cnt[k] += __popc(sb[ty * kPer + k][c] & jw);
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= n) return;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = s0 + ty * kPer + k;
    if (s >= ns) continue;
    const int i = srow[ty * kPer + k];
    bool hard = false;
    if (i >= 0 && i < n && valid[i] && valid[j])
      hard = cross(src, tgt, i, j) < hard_thr;
    out[(size_t)s * n + j] = hard ? (float)cnt[k] : 0.f;
  }
}

}  // namespace

// bits is [n, ceil(n/32)] uint32 scratch; out is [ns, n] f32.
extern "C" int eyoc_sc2_seed_counts(const void* src, const void* tgt,
                                    const void* valid, int n,
                                    const void* seeds, int ns, float hard_thr,
                                    float tight_thr, void* bits, void* out,
                                    void* stream) {
  if (n <= 0 || ns <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int words = (n + 31) / 32;
  const long warps = (long)n * words;
  const int threads = 256;
  const long blocks = (warps * 32 + threads - 1) / threads;
  auto* psrc = static_cast<const float*>(src);
  auto* ptgt = static_cast<const float*>(tgt);
  auto* pvalid = static_cast<const uint8_t*>(valid);
  auto* pbits = static_cast<uint32_t*>(bits);
  pack_tight<<<(unsigned)blocks, threads, 0, s>>>(psrc, ptgt, pvalid, n, words,
                                                  tight_thr, pbits);
  dim3 grid((n + kCols - 1) / kCols, (ns + kSeeds - 1) / kSeeds);
  seed_counts<<<grid, kThreads, 0, s>>>(pbits, words,
                                        static_cast<const int*>(seeds), ns,
                                        psrc, ptgt, pvalid, n, hard_thr,
                                        static_cast<float*>(out));
  return (int)cudaGetLastError();
}
