// K13 sc2_nms: SC2-PCR's NMS seed scores for B problems at once.
//
// Replaces eyoc_tpu/registration/sc2pcr.py:151 `_pick_seeds` together with
// the [N, N] masked distances it is fed (:291). For problem b and row i:
//
//   local[b, i] = score[b, i] * flag[b, i],
//   flag = 0 iff some j has valid[b, i] & valid[b, j],
//          !(score[b, i] >= score[b, j]) and !(|s_i - s_j| >= radius),
//
// which is the plain version's `scores * all(relation)` with the invalid
// pairs at an infinite distance, written as the same product so that the
// sort that follows (torch.sort in the wrapper) sees the same bits. The
// distance is sqrt((dx*dx + dy*dy) + dz*dz) with no fused multiply-add,
// as in K4 and the plain version (registration/sc2pcr.py:_norm3), so every
// radius test agrees with the plain version bit for bit. The square root
// is taken only where the squared distance lies within 2^-18 of radius^2:
// further from it the rounded root is on the same side of the radius.
//
// Two launches. `nms_flags`: one thread a row, 128 rows a block, the
// columns cut into `splits` ranges so that small problems still fill the
// card; a block stages its range's points in shared memory a tile at a
// time, a row stops at its first suppressor and the block once every row
// has one; each (split, row) writes its own byte, so no atomics and no
// initialisation. `nms_local`: one thread a row, ORs the splits' bytes and
// writes the product. Invalid rows scan nothing and are never suppressed.
// Grids are one dimension.
//
// What bounds it: operations (a radius test for each valid row against
// each valid row of larger score while the row has no suppressor); its
// bytes are a few per point. No floating-point reduction: the same bits on
// every call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// radius test of the plain version, !(|a - b| >= r), from the squared
// distance q: the root only where q is within 2^-18 of r^2
__device__ __forceinline__ bool within(float q, float lo, float hi,
                                       float r) {
  if (q < lo) return true;
  if (q > hi) return false;
  return !(__fsqrt_rn(q) >= r);
}

__global__ void __launch_bounds__(kThreads) nms_flags(
    const float* __restrict__ src, const bool* __restrict__ valid,
    const float* __restrict__ score, int N, int row_blocks, int splits,
    int span, float radius, uint8_t* __restrict__ flags) {
  __shared__ float tx[kThreads], ty[kThreads], tz[kThreads], ts[kThreads];
  __shared__ int tv[kThreads];
  __shared__ int any_open;
  const int rb = blockIdx.x % row_blocks;
  const int split = (blockIdx.x / row_blocks) % splits;
  const int b = blockIdx.x / (row_blocks * splits);
  const int i = rb * kThreads + threadIdx.x;
  const float* P = src + (long long)b * N * 3;
  const bool* V = valid + (long long)b * N;
  const float* Sc = score + (long long)b * N;
  const bool in = i < N;
  const float si = in ? Sc[i] : 0.f;
  const float xi = in ? P[3 * i] : 0.f, yi = in ? P[3 * i + 1] : 0.f,
              zi = in ? P[3 * i + 2] : 0.f;
  const float r2 = __fmul_rn(radius, radius);
  const float lo = __fmul_rn(r2, 1.f - 0x1p-18f);
  const float hi = __fmul_rn(r2, 1.f + 0x1p-18f);
  bool open = in && V[i];   // a valid row with no suppressor found yet
  bool suppressed = false;
  const int j_end = min(N, (split + 1) * span);
  for (int j0 = split * span; j0 < j_end; j0 += kThreads) {
    __syncthreads();       // the previous tile's reads are done
    const int j = j0 + threadIdx.x;
    if (j < j_end) {
      tx[threadIdx.x] = P[3 * j];
      ty[threadIdx.x] = P[3 * j + 1];
      tz[threadIdx.x] = P[3 * j + 2];
      ts[threadIdx.x] = Sc[j];
      tv[threadIdx.x] = V[j];
    }
    if (threadIdx.x == 0) any_open = 0;
    __syncthreads();
    if (open) {
      const int m = min(kThreads, j_end - j0);
      for (int k = 0; k < m; ++k) {
        if (!tv[k] || si >= ts[k]) continue;
        const float dx = __fsub_rn(xi, tx[k]), dy = __fsub_rn(yi, ty[k]),
                    dz = __fsub_rn(zi, tz[k]);
        const float q = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (within(q, lo, hi, radius)) {
          suppressed = true;
          open = false;
          break;
        }
      }
      if (open) any_open = 1;
    }
    __syncthreads();
    if (!any_open) break;
  }
  if (in) flags[((long long)b * splits + split) * N + i] = suppressed;
}

__global__ void __launch_bounds__(kThreads) nms_local(
    const float* __restrict__ score, const uint8_t* __restrict__ flags,
    int B, int N, int splits, float* __restrict__ local) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)B * N) return;
  const int b = (int)(e / N);
  const int i = (int)(e - (long long)b * N);
  bool suppressed = false;
  for (int s = 0; s < splits; ++s)
    suppressed |= flags[((long long)b * splits + s) * N + i] != 0;
  local[e] = __fmul_rn(score[e], suppressed ? 0.f : 1.f);
}

}  // namespace

// src [B, N, 3] f32, valid [B, N] bool, score [B, N] f32 -> local [B, N];
// flags: B * splits * N bytes of scratch.
extern "C" int eyoc_sc2_nms(const float* src, const bool* valid,
                            const float* score, int B, int N, float radius,
                            int splits, uint8_t* flags, float* local,
                            cudaStream_t stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  if (splits < 1) return cudaErrorInvalidValue;
  const int tiles = (N + kThreads - 1) / kThreads;   // row blocks too
  const int span = (tiles + splits - 1) / splits * kThreads;
  nms_flags<<<B * tiles * splits, kThreads, 0, stream>>>(
      src, valid, score, N, tiles, splits, span, radius, flags);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * N;
  nms_local<<<(int)((rows + kThreads - 1) / kThreads), kThreads, 0,
              stream>>>(score, flags, B, N, splits, local);
  return cudaGetLastError();
}
