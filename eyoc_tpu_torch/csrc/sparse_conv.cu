// K1 sparse_conv: gathered sparse convolution with a fused epilogue.
//
// Replaces eyoc_tpu/sparse/brick_conv.py conv_same / conv_down / conv_up /
// conv1x1 (:310-378) and the decoder skip concat fb_concat (:381). The JAX
// package embeds the 27 taps into a dense 64-cell halo matmul to fit the
// TPU's matrix unit (2.37x the tap FLOPs); here each output row reads its
// inputs through an explicit gather map instead:
//
//   out[o, :] = epilogue( sum_t  in[map[o, t], :] @ W[t] )
//
// in = concat(xa [M_in, Ca], xb [M_in, Cb]) along channels (xb optional, the
// skip concat), bf16; W [T, Ca+Cb, Co] bf16; map [M_out, T] int32 where any
// value outside [0, M_in) reads a zero row (the sentinel is M_in). The sum
// accumulates in f32. Epilogue: + bias[Co] (folded BN, f32), * mask[o]
// (voxel validity), + residual[o, :] (bf16), ReLU, store bf16.
//
// What bounds it: at the main path's shapes (ResUNetBN2C, 32-256 channels
// over 512-16384 rows, 27 or 125 taps) a call moves 1-8 MB of unique bytes
// (the int32 map [M_out, T] is the largest input at the fine levels, W at
// the coarse ones) against at most ~0.7 GFLOP of taps that hit a voxel, so
// at the bf16 tensor-core peak it is bound by bytes. This first version
// runs its products in f32 on the CUDA cores and is far from that bound;
// the gathered rows are re-read once per tap, from L2.
// Design: a block owns a TM x TN output tile and loops over the taps; for
// each tap it gathers the tap's input rows by the map into shared memory in
// TK-channel slices (converted to f32), loads the matching W[t] slice, and
// runs a register-blocked f32 FMA product. A tap whose rows are all
// sentinels in this tile is skipped (__syncthreads_or). Tensor cores
// (mma.sync / wgmma) are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 32;
constexpr int kThreads = 256;

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads) sparse_conv_kernel(
    const __nv_bfloat16* __restrict__ xa, int ca,
    const __nv_bfloat16* __restrict__ xb, int cb, int m_in,
    const int* __restrict__ nmap, int taps, int m_out,
    const __nv_bfloat16* __restrict__ w, int co,
    const float* __restrict__ bias, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ residual, int relu,
    __nv_bfloat16* __restrict__ out) {
  constexpr int RM = TM / 16;  // rows per thread
  constexpr int RN = TN / 16;  // cols per thread
  __shared__ float As[kTK][TM + 1];
  __shared__ float Bs[kTK][TN];
  __shared__ int rows[TM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int ci = ca + cb;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < taps; ++t) {
    int has = 0;
    if (tid < TM) {
      const int m = m0 + tid;
      int r = (m < m_out) ? nmap[(size_t)m * taps + t] : -1;
      if (r < 0 || r >= m_in) r = -1;
      rows[tid] = r;
      has = r >= 0;
    }
    if (!__syncthreads_or(has)) continue;  // uniform: every row a sentinel

    for (int k0 = 0; k0 < ci; k0 += kTK) {
      for (int e = tid; e < TM * kTK; e += kThreads) {
        const int mm = e / kTK;
        const int kk = e % kTK;
        const int r = rows[mm];
        const int k = k0 + kk;
        float v = 0.f;
        if (r >= 0 && k < ci) {
          v = (k < ca) ? __bfloat162float(xa[(size_t)r * ca + k])
                       : __bfloat162float(xb[(size_t)r * cb + (k - ca)]);
        }
        As[kk][mm] = v;
      }
      for (int e = tid; e < kTK * TN; e += kThreads) {
        const int kk = e / TN;
        const int nn = e % TN;
        const int k = k0 + kk;
        const int n = n0 + nn;
        Bs[kk][nn] = (k < ci && n < co)
                         ? __bfloat162float(w[((size_t)t * ci + k) * co + n])
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) {
        float a[RM];
        float b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = Bs[kk][tx * RN + j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= m_out) continue;
    const float mk = (mask == nullptr || mask[m]) ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j;
      if (n >= co) continue;
      float y = acc[i][j];
      if (bias != nullptr) y += bias[n];
      y *= mk;
      if (residual != nullptr)
        y += __bfloat162float(residual[(size_t)m * co + n]);
      if (relu) y = fmaxf(y, 0.f);
      out[(size_t)m * co + n] = __float2bfloat16(y);
    }
  }
}

template <int TM, int TN>
void launch(const __nv_bfloat16* xa, int ca, const __nv_bfloat16* xb, int cb,
            int m_in, const int* nmap, int taps, int m_out,
            const __nv_bfloat16* w, int co, const float* bias,
            const uint8_t* mask, const __nv_bfloat16* residual, int relu,
            __nv_bfloat16* out, cudaStream_t stream) {
  dim3 grid((m_out + TM - 1) / TM, (co + TN - 1) / TN);
  sparse_conv_kernel<TM, TN><<<grid, kThreads, 0, stream>>>(
      xa, ca, xb, cb, m_in, nmap, taps, m_out, w, co, bias, mask, residual,
      relu, out);
}

}  // namespace

extern "C" int eyoc_sparse_conv(const void* xa, int ca, const void* xb,
                                int cb, int m_in, const void* nmap, int taps,
                                int m_out, const void* w, int co,
                                const void* bias, const void* mask,
                                const void* residual, int relu, void* out,
                                void* stream) {
  if (m_out <= 0 || co <= 0) return 0;
  auto* pxa = static_cast<const __nv_bfloat16*>(xa);
  auto* pxb = static_cast<const __nv_bfloat16*>(xb);
  auto* pmap = static_cast<const int*>(nmap);
  auto* pw = static_cast<const __nv_bfloat16*>(w);
  auto* pbias = static_cast<const float*>(bias);
  auto* pmask = static_cast<const uint8_t*>(mask);
  auto* pres = static_cast<const __nv_bfloat16*>(residual);
  auto* pout = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // narrow outputs take 32-wide column tiles; few rows take 32-row tiles so
  // that the grid still covers the card's 132 SMs about twice
  const bool narrow = co <= 32;
  const int tn = narrow ? 32 : 64;
  const long blocks64 = (long)((m_out + 63) / 64) * ((co + tn - 1) / tn);
  const bool short_rows = blocks64 < 264;
  if (narrow && short_rows)
    launch<32, 32>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pw, co, pbias,
                   pmask, pres, relu, pout, s);
  else if (narrow)
    launch<64, 32>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pw, co, pbias,
                   pmask, pres, relu, pout, s);
  else if (short_rows)
    launch<32, 64>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pw, co, pbias,
                   pmask, pres, relu, pout, s);
  else
    launch<64, 64>(pxa, ca, pxb, cb, m_in, pmap, taps, m_out, pw, co, pbias,
                   pmask, pres, relu, pout, s);
  return (int)cudaGetLastError();
}
