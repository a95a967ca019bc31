// K7 masked_channel_sums: per-channel sums over the rows a mask keeps, in
// one launch.
//
// Replaces the statistics of eyoc_tpu/sparse/norm.py masked_batch_norm_fb
// (:93-110) and, through JAX's transpose of them, the two reductions of
// its backward:
//
//   out[0]        = n      = number of rows r with mask[r]
//   out[1 + c]    = sum_r mask[r] * x[r, c]
//   out[1 + C + c] = sum_r mask[r] * x[r, c] * (y[r, c] - shift[c])
//
// The train forward calls it with y = x and no shift (the JAX formula:
// var = s2 / n - mean^2); the backward with x = dY, y = the BN input and
// shift = the batch mean, which gives sum dY and sum dY * (x - mean)
// without storing x - mean. x and y are [M, C] bf16 (the train forward's
// activations and their cotangents); sums are f32. The layout [n, s1, s2]
// is the JAX package's packed psum (norm.py:98-102).
//
// What bounds it: bytes (one read of x, of y when given, and of the mask;
// two flops per element). Design:
// - A block of 256 threads owns one chunk of rows. A thread reads 8
//   channels of a row with one 16-byte load; the L = C/8 (rounded up to a
//   power of two) neighbouring threads of a row read the whole row, so a
//   warp covers 32 / L whole rows. The mask is read once per row and
//   thread, beside the row's loads (not before them); eight rows a thread
//   are in flight at once, loaded without a branch.
// - In a block: a fixed xor-shuffle tree over the row lanes of a warp, then
//   the eight warps added in order; the chunk's partial is written
//   channel-major (partial e of chunk k at e * chunks + k).
// - The last block to finish (a ticket counter that the block resets) adds
//   the partials: a warp per output value (several values a warp at once,
//   so that each lane has 32 loads in flight), lane l adds chunks l, l +
//   32, ... in order, then a fixed xor-shuffle tree over the 32 lanes. One
//   launch per call, no float atomics, the same bits on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 8;            // rows in flight a thread
constexpr int kMaxC = 256;       // channels: 8 a thread, a row in one warp
constexpr int kMaxChunks = 256;  // chunks: 8 a lane in the final sum

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The last block's sum of the chunk partials part [width, chunks]: warp w
// takes values w * EB, w * EB + 1, ... (EB = 32 / KP at once), lane l adds
// chunks l, l + 32, ..., l + 32 (KP - 1) of each in order, then a fixed
// xor-shuffle tree over the 32 lanes gives the value.
template <int KP>
__device__ __forceinline__ void final_sum(const float* part, int chunks,
                                          int width, float* out) {
  constexpr int EB = 32 / KP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int e0 = warp * EB; e0 < width; e0 += kWarps * EB) {
    // every load first, then the adds: a load consumed by the next
    // instruction would hold the warp until it lands
    float t[EB][KP];
#pragma unroll
    for (int b = 0; b < EB; ++b) {
      const float* pe = part + (size_t)(e0 + b) * chunks;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int ch = lane + 32 * k;
        t[b][k] = (e0 + b < width && ch < chunks) ? __ldcg(pe + ch) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < EB; ++b) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < KP; ++k) v += t[b][k];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && e0 + b < width) out[e0 + b] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads) sums_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ shift, const uint8_t* __restrict__ mask, int m,
    int c, int lanes, int rows_per_chunk, float* __restrict__ part,
    int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float ws1[kWarps][kMaxC];
  __shared__ float ws2[kWarps][kMaxC];
  __shared__ float wn[kWarps];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = tid & (lanes - 1);  // channel group: channels 8g .. 8g+7
  const int rl = tid / lanes;       // row lane
  const int rows = kThreads / lanes;
  const bool gin = g * 8 < c;
  const int chunks = gridDim.x;
  const int width = 1 + 2 * c;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(m, r0 + rows_per_chunk);

  float sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    sh[i] = (shift != nullptr && gin) ? shift[g * 8 + i] : 0.f;
  float s1[8], s2[8], n = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;

  // rows past the chunk re-read its last row (masked out): every load of
  // a pass is unconditional, so all of them are in flight together
  const int gc = gin ? g * 8 : 0;
  for (int r = r0 + rl; r < r1; r += kU * rows) {
    uint4 xv[kU], yv[kU];
    bool mk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * rows;
      const int rc = min(rr, r1 - 1);
      const size_t at = (size_t)rc * c + gc;
      mk[u] = mask[rc] && rr < r1;
      xv[u] = __ldg(reinterpret_cast<const uint4*>(x + at));
      if (y != nullptr) yv[u] = __ldg(reinterpret_cast<const uint4*>(y + at));
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!mk[u]) continue;
      n += 1.f;
      if (!gin) continue;
      float xf[8], yf[8];
      unpack8(xv[u], xf);
      if (y != nullptr) unpack8(yv[u], yf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float yy = (y != nullptr) ? yf[i] - sh[i] : xf[i];
        s1[i] += xf[i];
        s2[i] = fmaf(xf[i], yy, s2[i]);
      }
    }
  }

  // the row lanes of a warp that share a channel group: a fixed tree
  for (int off = 16; off >= lanes; off >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, off);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  }
  if (lane < lanes && gin) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (g * 8 + i < c) {
        ws1[warp][g * 8 + i] = s1[i];
        ws2[warp][g * 8 + i] = s2[i];
      }
    }
  }
  if (lane == 0) wn[warp] = n;
  __syncthreads();
  for (int e = tid; e < width; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      v += e == 0 ? wn[w] : (e <= c ? ws1[w][e - 1] : ws2[w][e - 1 - c]);
    part[(size_t)e * chunks + blockIdx.x] = v;
  }

  // the last block adds the chunk partials
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1) == chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // lane l of a warp adds chunks l, l + 32, ... of a value; each lane has
  // 32 loads in flight: 32 / KP values at once, KP loads of each
  const int kp = (chunks + 31) / 32;
  if (kp == 1)
    final_sum<1>(part, chunks, width, out);
  else if (kp == 2)
    final_sum<2>(part, chunks, width, out);
  else if (kp <= 4)
    final_sum<4>(part, chunks, width, out);
  else
    final_sum<8>(part, chunks, width, out);
  if (tid == 0) *ticket = 0;
}

}  // namespace

// x, y: [m, c] bf16, 16-byte aligned, c a multiple of 8 up to 256 (y may
// be null: y = x, and then shift is not read; an empty y is null too);
// shift [c] f32 or null; mask [m] bool; part [1 + 2c, chunks] f32 scratch
// (1 <= chunks <= 256 blocks of rows_per_chunk rows, chosen by the caller,
// sparse/norm.py:k7_chunks); ticket: one int, zero between calls (the
// kernel leaves it at zero); out [1 + 2c] f32.
extern "C" int eyoc_masked_channel_sums(const void* x, const void* y,
                                        const void* shift, const void* mask,
                                        int m, int c, int chunks,
                                        int rows_per_chunk, void* part,
                                        void* ticket, void* out,
                                        void* stream) {
  if (c <= 0 || c % 8 != 0 || c > kMaxC || chunks < 1 ||
      chunks > kMaxChunks || rows_per_chunk < 1 ||
      (long)chunks * rows_per_chunk < m)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int lanes = 1;
  while (lanes < c / 8) lanes *= 2;
  sums_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(shift),
      static_cast<const uint8_t*>(mask), m, c, lanes, rows_per_chunk,
      static_cast<float*>(part), static_cast<int*>(ticket),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
