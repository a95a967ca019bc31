// K20 masked_instance_norm: the per-cloud masked instance norm of the
// instance-norm models' eval forward, in two launches.
//
// Replaces eyoc_tpu/sparse/norm.py:masked_instance_norm_fb (:119-148) in
// the voxel-row layout: the rows of cloud s are the contiguous range [s
// cap, (s + 1) cap) of the level's rows (cap = rows / clouds), so a row's
// segment comes from its index. Per (cloud s, channel c), over the rows r
// of s with mask[r]:
//
//   n = max(count, 1), mean = sum x / n, var = max(sum x^2 / n - mean^2, 0)
//   g = rsqrt(var + eps) * scale[c], off = bias[c] - mean * g
//
// (JAX's formula, not Welford, in f32 from the bf16 activations), then
// y0 = bf16((x g + off) * mask). The apply may go on as the residual
// block does next (eyoc_tpu/models/unet.py:_block, :218-231): relu(y0),
// or with a residual bf16(relu(y0 + residual) * mask); and it may also
// write y0 itself (SimpleNet's pre-relu skip beside the relu'd output).
//
// What bounds it: bytes (x read twice, once a launch, the residual read
// and the output written once; a few flops an element). Design:
// - `stats`: K7's chunked masked sums (csrc/masked_channel_sums.cu) with a
//   segment axis and a channel-slab axis: a block of 256 threads owns a
//   chunk of one cloud's rows and a slab of at most 256 channels; a thread
//   reads 8 channels of a row with one 16-byte load, the slab's L threads
//   of a row (L = slab / 8 rounded up to a power of two) read the row's
//   slab; eight rows a thread in flight. In a block: a fixed xor-shuffle
//   tree over a warp's row lanes, then the eight warps in order, the
//   chunk's partial written value-major. The last block of a cloud (a
//   ticket word a cloud, which that block resets) adds the cloud's chunk
//   partials as K7's last block does (lane l adds chunks l, l + 32, ... in
//   order, then a fixed tree) and turns them into g and off. No float
//   atomics: the same bits on every call.
// - `apply`: a thread an 8-channel group of a row, 16-byte loads and
//   stores, the row's cloud's g and off.
// Every operation of the statistics and the apply is rounded apart and
// the divisions and roots are IEEE, as the plain version's torch ops are.
//
// The train forward also asks the last block of a cloud for the cloud's
// mean, rstd = 1 / sqrt(var + eps) and live = var_raw > 0 a channel, which
// the backward (K21, csrc/norm_backward.cu) reads: g / scale would fail at
// a zero scale.
//
// K22 masked_norm_apply is `apply` alone, given the segments' g and off:
// the batch norm's apply of eyoc_tpu/sparse/norm.py:masked_batch_norm_fb
// (:113-115; one segment, its statistics K7's) with the same fused tails.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 8;            // rows in flight a thread
constexpr int kSlab = 256;       // channels a block: 8 a thread, one warp
constexpr int kMaxC = 512;       // channels: two slabs
constexpr int kMaxChunks = 256;  // chunks a cloud: 8 a lane in the final sum

__device__ __forceinline__ void unpack8(const int4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ int4 pack8(const float (&f)[8]) {
  int4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// The last block's sum of a cloud's chunk partials part [width, chunks]
// into out[width]: warp w takes values w EB, w EB + 1, ... (EB = 32 / KP at
// once), lane l adds chunks l, l + 32, ..., l + 32 (KP - 1) of each in
// order, then a fixed xor-shuffle tree over the 32 lanes (K7's final sum).
template <int KP>
__device__ __forceinline__ void final_sum(const float* part, int chunks,
                                          int width, float* out) {
  constexpr int EB = 32 / KP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int e0 = warp * EB; e0 < width; e0 += kWarps * EB) {
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

// Block (s, k, q) = blockIdx.x = (s chunks + k) slabs + q: chunk k of cloud
// s's rows, channel slab q. part: [clouds, 1 + 2c, chunks]; gof: [clouds,
// 2c] (g, then off); ticket: a word a cloud; stats_out (or null): [clouds,
// 3c] (mean, rstd, live).
__global__ void __launch_bounds__(kThreads) stats(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float eps, int cap, int c, int chunks, int rows_per_chunk, int slabs,
    float* __restrict__ part, int* __restrict__ ticket,
    float* __restrict__ gof, float* __restrict__ stats_out) {
  __shared__ float ws1[kWarps][kSlab];
  __shared__ float ws2[kWarps][kSlab];
  __shared__ float wn[kWarps];
  __shared__ float fin[1 + 2 * kMaxC];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = blockIdx.x % slabs;
  const int k = blockIdx.x / slabs % chunks;
  const int s = blockIdx.x / slabs / chunks;
  const int c0 = q * kSlab;
  const int cw = min(kSlab, c - c0);
  int lanes = 1;
  while (lanes < cw / 8) lanes *= 2;
  const int g = tid & (lanes - 1);  // channel group: slab channels 8g .. 8g+7
  const int rl = tid / lanes;       // row lane
  const int rows = kThreads / lanes;
  const bool gin = g * 8 < cw;
  const int width = 1 + 2 * c;
  const long long base = (long long)s * cap;
  const int r0 = k * rows_per_chunk;
  const int r1 = min(cap, r0 + rows_per_chunk);

  float s1[8], s2[8], n = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
  // rows past the chunk re-read its last row (masked out): every load of
  // a pass is unconditional, so all of them are in flight together
  const int gc = c0 + (gin ? g * 8 : 0);
  for (int r = r0 + rl; r < r1; r += kU * rows) {
    int4 xv[kU];
    bool mk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * rows;
      const long long rc = base + min(rr, r1 - 1);
      mk[u] = mask[rc] && rr < r1;
      xv[u] = __ldg(reinterpret_cast<const int4*>(x + rc * c + gc));
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!mk[u]) continue;
      n += 1.f;
      if (!gin) continue;
      float xf[8];
      unpack8(xv[u], xf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1[i] = __fadd_rn(s1[i], xf[i]);
        s2[i] = __fadd_rn(s2[i], __fmul_rn(xf[i], xf[i]));
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
      if (g * 8 + i < cw) {
        ws1[warp][g * 8 + i] = s1[i];
        ws2[warp][g * 8 + i] = s2[i];
      }
    }
  }
  if (lane == 0) wn[warp] = n;
  __syncthreads();
  float* cpart = part + (size_t)s * width * chunks;
  // the slab's values of this chunk (the count by slab 0 only)
  for (int e = tid; e < 1 + 2 * cw; e += kThreads) {
    if (e == 0 && q != 0) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      v += e == 0 ? wn[w] : (e <= cw ? ws1[w][e - 1] : ws2[w][e - 1 - cw]);
    const int at = e == 0 ? 0 : (e <= cw ? 1 + c0 + e - 1
                                         : 1 + c + c0 + e - 1 - cw);
    cpart[(size_t)at * chunks + k] = v;
  }

  // the cloud's last block adds its partials and makes g and off
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + s, 1) == chunks * slabs - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int kp = (chunks + 31) / 32;
  if (kp == 1)
    final_sum<1>(cpart, chunks, width, fin);
  else if (kp == 2)
    final_sum<2>(cpart, chunks, width, fin);
  else if (kp <= 4)
    final_sum<4>(cpart, chunks, width, fin);
  else
    final_sum<8>(cpart, chunks, width, fin);
  __syncthreads();
  const float cnt = fmaxf(fin[0], 1.f);
  for (int ch = tid; ch < c; ch += kThreads) {
    const float mean = __fdiv_rn(fin[1 + ch], cnt);
    const float var_raw =
        __fsub_rn(__fdiv_rn(fin[1 + c + ch], cnt), __fmul_rn(mean, mean));
    const float rstd =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(fmaxf(var_raw, 0.f), eps)));
    const float gg = __fmul_rn(rstd, scale[ch]);
    gof[(size_t)s * 2 * c + ch] = gg;
    gof[(size_t)s * 2 * c + c + ch] = __fsub_rn(bias[ch], __fmul_rn(mean, gg));
    if (stats_out != nullptr) {
      float* so = stats_out + (size_t)s * 3 * c;
      so[ch] = mean;
      so[c + ch] = rstd;
      so[2 * c + ch] = var_raw > 0.f ? 1.f : 0.f;
    }
  }
  if (tid == 0) ticket[s] = 0;
}

// A thread an 8-channel group of a row: y0 = bf16(x g + off) at a masked
// row (0 elsewhere); y = y0, relu(y0), or with a residual bf16(relu(y0 +
// residual)) at a masked row (0 elsewhere); pre = y0 where asked.
__global__ void __launch_bounds__(kThreads) apply(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ gof, const __nv_bfloat16* __restrict__ res,
    long long items, int cap, int c, int relu,
    __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ pre) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int groups = c / 8;
  const long long row = i / groups;
  const int ch = (int)(i % groups) * 8;
  const long long at = row * c + ch;
  const bool m = mask[row];
  const float* gs = gof + (row / cap) * 2 * c;
  float xf[8], y0[8], out[8];
  unpack8(__ldg(reinterpret_cast<const int4*>(x + at)), xf);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    y0[j] = m ? __fadd_rn(__fmul_rn(xf[j], gs[ch + j]), gs[c + ch + j]) : 0.f;
  const int4 y0b = pack8(y0);
  if (pre != nullptr) *reinterpret_cast<int4*>(pre + at) = y0b;
  if (res == nullptr && !relu) {
    *reinterpret_cast<int4*>(y + at) = y0b;
    return;
  }
  unpack8(y0b, y0);                 // the stored y0, as the plain version
  if (res != nullptr) {
    float rf[8];
    unpack8(__ldg(reinterpret_cast<const int4*>(res + at)), rf);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = m ? fmaxf(__fadd_rn(y0[j], rf[j]), 0.f) : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = fmaxf(y0[j], 0.f);
  }
  *reinterpret_cast<int4*>(y + at) = pack8(out);
}

}  // namespace

// x, residual, y, pre: [rows, c] bf16, 16-byte aligned, c a multiple of 8
// up to 512, rows = clouds * cap; residual and pre may be null; mask [rows]
// bool; scale, bias [c] f32; part [clouds, 1 + 2c, chunks] f32 scratch
// (1 <= chunks <= 256 blocks of rows_per_chunk rows of a cloud, chosen by
// the caller, sparse/norm.py:k20_chunks); ticket: a word a cloud, zero
// between calls (the kernel leaves them at zero); gof [clouds, 2c] f32
// (the clouds' g and off); stats_out (or null) [clouds, 3c] f32 (mean,
// rstd, live, for the backward). relu applies where there is no residual.
// Two launches.
extern "C" int eyoc_masked_instance_norm(
    const void* x, const void* mask, const void* scale, const void* bias,
    float eps, const void* residual, int clouds, int cap, int c, int chunks,
    int rows_per_chunk, int relu, void* part, void* ticket, void* gof,
    void* stats_out, void* y, void* pre, void* stream) {
  if (clouds <= 0 || cap <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % 8 != 0 || c > kMaxC || chunks < 1 ||
      chunks > kMaxChunks || rows_per_chunk < 1 ||
      (long)chunks * rows_per_chunk < cap)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)residual | (uintptr_t)y | (uintptr_t)pre) %
          16 != 0)
    return (int)cudaErrorInvalidValue;        // 16-byte loads and stores
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slabs = (c + kSlab - 1) / kSlab;
  stats<<<clouds * chunks * slabs, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(scale),
      static_cast<const float*>(bias), eps, cap, c, chunks, rows_per_chunk,
      slabs, static_cast<float*>(part), static_cast<int*>(ticket),
      static_cast<float*>(gof), static_cast<float*>(stats_out));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)clouds * cap * (c / 8);
  apply<<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(gof),
      static_cast<const __nv_bfloat16*>(residual), items, cap, c, relu,
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(pre));
  return (int)cudaGetLastError();
}

// K22: x, residual, y, pre: [segments * cap, c] bf16, 16-byte aligned, c a
// multiple of 8 up to 512; residual and pre may be null; mask [rows] bool;
// gof [segments, 2c] f32 (each segment's g, then off). relu applies where
// there is no residual. One launch.
extern "C" int eyoc_masked_norm_apply(const void* x, const void* mask,
                                      const void* gof, const void* residual,
                                      int segments, int cap, int c, int relu,
                                      void* y, void* pre, void* stream) {
  if (segments <= 0 || cap <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % 8 != 0 || c > kMaxC) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)residual | (uintptr_t)y | (uintptr_t)pre) %
          16 != 0)
    return (int)cudaErrorInvalidValue;        // 16-byte loads and stores
  const long long items = (long long)segments * cap * (c / 8);
  apply<<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(gof),
      static_cast<const __nv_bfloat16*>(residual), items, cap, c, relu,
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(pre));
  return (int)cudaGetLastError();
}
