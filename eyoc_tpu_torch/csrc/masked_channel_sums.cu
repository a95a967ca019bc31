// K7 masked_channel_sums: per-channel sums over the rows a mask keeps.
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
// activations and their cotangents); sums are f32. The layout [n, s1, s2] is the JAX package's packed psum
// (norm.py:98-102).
//
// What bounds it: bytes (one read of x, of y when given, and of the mask;
// two flops per element). Design: a block of 32 x 8 threads owns 32
// channels and one chunk of rows; lane = channel, so a warp reads 32
// neighbouring channels of one row, and the 8 warps stride the chunk's
// rows. The 8 row lanes are summed in a fixed order in shared memory and
// each chunk writes its partial; a second kernel adds the chunks in chunk
// order. No atomics: the sums are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // channels per block
constexpr int kRowLanes = 8;  // row lanes per block

__global__ void __launch_bounds__(kLanes * kRowLanes) sums_partial(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ shift, const uint8_t* __restrict__ mask, int m,
    int c, int rows_per_chunk, float* __restrict__ part) {
  __shared__ float sh1[kRowLanes][kLanes];
  __shared__ float sh2[kRowLanes][kLanes];
  __shared__ float shn[kRowLanes][kLanes];
  const int lane = threadIdx.x;
  const int ly = threadIdx.y;
  const int ch = blockIdx.y * kLanes + lane;
  const bool in_c = ch < c;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(m, r0 + rows_per_chunk);
  const float sh = (shift != nullptr && in_c) ? shift[ch] : 0.f;

  float s1 = 0.f, s2 = 0.f, n = 0.f;
  for (int r = r0 + ly; r < r1; r += kRowLanes) {
    if (!mask[r]) continue;
    n += 1.f;
    if (in_c) {
      const float xv = __bfloat162float(x[(size_t)r * c + ch]);
      const float yv =
          (y == nullptr) ? xv : __bfloat162float(y[(size_t)r * c + ch]) - sh;
      s1 += xv;
      s2 = fmaf(xv, yv, s2);
    }
  }
  sh1[ly][lane] = s1;
  sh2[ly][lane] = s2;
  shn[ly][lane] = n;
  __syncthreads();
  if (ly != 0) return;
  float a = 0.f, b = 0.f, cnt = 0.f;
#pragma unroll
  for (int k = 0; k < kRowLanes; ++k) {
    a += sh1[k][lane];
    b += sh2[k][lane];
    cnt += shn[k][lane];
  }
  float* p = part + (size_t)blockIdx.x * (1 + 2 * c);
  if (in_c) {
    p[1 + ch] = a;
    p[1 + c + ch] = b;
  }
  if (blockIdx.y == 0 && lane == 0) p[0] = cnt;
}

// out[e] = sum over chunks k, in order, of part[k][e]
__global__ void sums_reduce(const float* __restrict__ part, int chunks,
                            int width, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * width + e];
  out[e] = s;
}

}  // namespace

// x, y: [m, c] bf16 (y may be null: y = x, and then shift must be null
// too); shift [c] f32 or null; mask [m] bool; part [chunks, 1 + 2c] f32
// scratch (chunks >= 1, chosen by the caller, sparse/norm.py:_chunks); out
// [1 + 2c] f32.
extern "C" int eyoc_masked_channel_sums(const void* x, const void* y,
                                        const void* shift, const void* mask,
                                        int m, int c, int chunks, void* part,
                                        void* out, void* stream) {
  if (c <= 0 || chunks < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int width = 1 + 2 * c;
  const int rows_per_chunk = m > 0 ? (m + chunks - 1) / chunks : 1;
  dim3 block(kLanes, kRowLanes);
  dim3 grid(chunks, (c + kLanes - 1) / kLanes);
  auto* pp = static_cast<float*>(part);
  sums_partial<<<grid, block, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(shift),
      static_cast<const uint8_t*>(mask), m, c, rows_per_chunk, pp);
  sums_reduce<<<(width + 255) / 256, 256, 0, s>>>(pp, chunks, width,
                                                  static_cast<float*>(out));
  return (int)cudaGetLastError();
}
