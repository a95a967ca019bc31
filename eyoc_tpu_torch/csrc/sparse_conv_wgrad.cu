// K5 sparse_conv_wgrad: the weight gradient of K1's gathered convolution.
//
// Replaces the weight half of the backward that JAX derives for
// eyoc_tpu/sparse/brick_conv.py conv_same / conv_down / conv_up / conv1x1
// and fb_concat (:310-388): there the transpose of the halo matmul
// `H^T @ dY` followed by the transpose of the weight embedding. With the
// port's explicit gather maps the same gradient is, per tap t,
//
//   dW[t, k, n] = sum_o  in[map[o, t], k] * dY[o, n]
//
// in = concat(xa [M_in, Ca], xb [M_in, Cb]) along channels (xb optional, the
// decoder's skip concat), bf16; dY [M_out, Co] bf16; map [M_out, T] int32
// whose values outside [0, M_in) read a zero row; dW [T, Ca+Cb, Co] f32.
//
// What bounds it: at the train step's shapes (ResUNetBN2C at B = 8, 512-
// 131072 output rows, 27 or 125 taps, 1-256 in-channels, 32-256 out) a call
// moves a few MB to ~70 MB (the int32 map and dY at level 0) against up to
// ~7 GFLOP of tap products that hit a voxel: at the bf16 tensor-core peak
// that is bound by bytes. This first version runs f32 FMAs on the CUDA
// cores and gathers the tap's input rows once per (tap, channel tile).
// Design: a block owns one tap and one TI x TO tile of dW and walks a
// contiguous range of output rows (its split) in stages of 32 rows: it
// gathers the stage's input rows by the map and the matching dY rows into
// shared memory (as f32) and accumulates the 32 outer products in
// registers. A stage whose rows all read the sentinel is skipped. The rows
// are split over gridDim.z so that narrow convs still fill the card; each
// split writes its own partial [T, Ci, Co] and a second kernel sums the
// partials in split order. No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTR = 32;  // output rows per shared-memory stage
constexpr int kThreads = 256;

template <int TI, int TO>
__global__ void __launch_bounds__(kThreads) wgrad_partial(
    const __nv_bfloat16* __restrict__ xa, int ca,
    const __nv_bfloat16* __restrict__ xb, int cb, int m_in,
    const int* __restrict__ nmap, int taps, int m_out,
    const __nv_bfloat16* __restrict__ dy, int co, int rows_per_split,
    float* __restrict__ part) {
  constexpr int RI = TI / 16;  // in-channels per thread
  constexpr int RO = TO / 16;  // out-channels per thread
  __shared__ float As[kTR][TI];
  __shared__ float Bs[kTR][TO];
  __shared__ int rows[kTR];

  const int ci = ca + cb;
  const int tiles_o = (co + TO - 1) / TO;
  const int i0 = (blockIdx.x / tiles_o) * TI;
  const int n0 = (blockIdx.x % tiles_o) * TO;
  const int t = blockIdx.y;
  const int o_begin = blockIdx.z * rows_per_split;
  const int o_end = min(m_out, o_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[RI][RO];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.f;

  for (int o0 = o_begin; o0 < o_end; o0 += kTR) {
    int has = 0;
    if (tid < kTR) {
      const int o = o0 + tid;
      int r = (o < o_end) ? nmap[(size_t)o * taps + t] : -1;
      if (r < 0 || r >= m_in) r = -1;
      rows[tid] = r;
      has = r >= 0;
    }
    if (!__syncthreads_or(has)) continue;  // uniform: every row a sentinel

    for (int e = tid; e < kTR * TI; e += kThreads) {
      const int rr = e / TI;
      const int kk = e % TI;
      const int r = rows[rr];
      const int k = i0 + kk;
      float v = 0.f;
      if (r >= 0 && k < ci) {
        v = (k < ca) ? __bfloat162float(xa[(size_t)r * ca + k])
                     : __bfloat162float(xb[(size_t)r * cb + (k - ca)]);
      }
      As[rr][kk] = v;
    }
    for (int e = tid; e < kTR * TO; e += kThreads) {
      const int rr = e / TO;
      const int nn = e % TO;
      const int n = n0 + nn;
      Bs[rr][nn] = (rows[rr] >= 0 && n < co)
                       ? __bfloat162float(dy[(size_t)(o0 + rr) * co + n])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTR; ++rr) {
      float a[RI];
      float b[RO];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = As[rr][ty * RI + i];
#pragma unroll
      for (int j = 0; j < RO; ++j) b[j] = Bs[rr][tx * RO + j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RO; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* p = part + ((size_t)blockIdx.z * taps + t) * ci * co;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int k = i0 + ty * RI + i;
    if (k >= ci) continue;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int n = n0 + tx * RO + j;
      if (n < co) p[(size_t)k * co + n] = acc[i][j];
    }
  }
}

// out[e] = sum over splits s, in order, of part[s][e]
__global__ void wgrad_reduce(const float* __restrict__ part, int splits,
                             long size, float* __restrict__ out) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = part[e];
  for (int k = 1; k < splits; ++k) s += part[(long)k * size + e];
  out[e] = s;
}

template <int TI, int TO>
void launch(const __nv_bfloat16* xa, int ca, const __nv_bfloat16* xb,
            int cb, int m_in, const int* nmap, int taps, int m_out,
            const __nv_bfloat16* dy, int co, int splits, float* part,
            cudaStream_t stream) {
  const int rows_per_split = (m_out + splits - 1) / splits;
  dim3 grid(((ca + cb + TI - 1) / TI) * ((co + TO - 1) / TO), taps, splits);
  wgrad_partial<TI, TO><<<grid, kThreads, 0, stream>>>(
      xa, ca, xb, cb, m_in, nmap, taps, m_out, dy, co, rows_per_split, part);
}

}  // namespace

// part: [splits, T, Ca+Cb, Co] f32 scratch when splits > 1; with splits == 1
// the caller passes out itself as part. splits >= 1 is chosen by the caller
// (sparse/brick_conv.py:_wgrad_splits).
extern "C" int eyoc_sparse_conv_wgrad(const void* xa, int ca, const void* xb,
                                      int cb, int m_in, const void* nmap,
                                      int taps, int m_out, const void* dy,
                                      int co, int splits, void* part,
                                      void* out, void* stream) {
  const int ci = ca + cb;
  if (ci <= 0 || co <= 0 || taps <= 0 || splits < 1) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const long size = (long)taps * ci * co;
  if (m_out <= 0) return (int)cudaMemsetAsync(out, 0, size * sizeof(float), s);
  auto* pxa = static_cast<const __nv_bfloat16*>(xa);
  auto* pxb = static_cast<const __nv_bfloat16*>(xb);
  auto* pmap = static_cast<const int*>(nmap);
  auto* pdy = static_cast<const __nv_bfloat16*>(dy);
  auto* ppart = static_cast<float*>(splits > 1 ? part : out);
  // narrow operands take narrow tiles, so conv1 (one in-channel) does not
  // spend 64 lanes on zeros
  if (ci <= 16 && co <= 32)
    launch<16, 32>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pdy, co, splits,
                   ppart, s);
  else if (ci <= 16)
    launch<16, 64>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pdy, co, splits,
                   ppart, s);
  else if (ci <= 32 && co <= 32)
    launch<32, 32>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pdy, co, splits,
                   ppart, s);
  else if (ci <= 32)
    launch<32, 64>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pdy, co, splits,
                   ppart, s);
  else if (co <= 32)
    launch<64, 32>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pdy, co, splits,
                   ppart, s);
  else
    launch<64, 64>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pdy, co, splits,
                   ppart, s);
  if (splits > 1)
    wgrad_reduce<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part), splits, size,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}
