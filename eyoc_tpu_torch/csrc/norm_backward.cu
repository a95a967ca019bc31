// K21 masked_norm_backward: the backward of a masked norm over S segments
// of equal row count and of the tail fused after it, in two launches.
//
// Replaces the backward of eyoc_tpu/sparse/norm.py masked_batch_norm_fb
// (:72-116, S = 1: the statistics are the whole batch's) and of
// masked_instance_norm_fb (:119-148, S = the clouds: a row's cloud is its
// index / cap), which JAX derives by autodiff. The forward (K7 sums + K22
// apply, or K20) gave per (segment s, channel c), over the rows r of s with
// mask[r]: n = max(count, 1), mean, rstd = 1 / sqrt(max(var_raw, 0) + eps)
// and live = var_raw > 0, then
//
//   y0 = bf16((x scale rstd + bias - mean scale rstd) * mask)
//   y  = y0, relu(y0), or bf16(relu(y0 + residual) * mask)
//   pre = y0 (SimpleNet's pre-relu skip, when its gradient dpre is given)
//
// From dy (the gradient at y) and dpre, per row and channel
//
//   dy0 = dy * (y > 0 with a ReLU or residual) * mask, + dpre rounded to
//         bf16 (two cotangents of one bf16 tensor meet in bf16)
//
// and per (s, c) over the masked rows: sdy = sum dy0, sdyxc = sum dy0 (x -
// mean); sdyxh = sdyxc rstd, coef = sdyxh / n where live and 0 where not
// (the gradient of jnp.maximum(var, 0) is 0 where the variance was
// clamped), then
//
//   dx = (scale rstd) ((dy0 - sdy / n) - xhat coef) * mask,  xhat = (x -
//        mean) rstd
//   dresidual = bf16(dy0) (with a residual)
//   dscale[c] = sum_s sdyxh[s, c], dbias[c] = sum_s sdy[s, c] (segments
//               added in order)
//
// What bounds it: bytes (x, dy and y read twice, once a launch; dx and
// dresidual written once; a few flops an element). Design:
// - `sums`: K20's statistics layout (csrc/instance_norm.cu): a block of
//   256 threads owns a chunk of one segment's rows and a slab of at most
//   256 channels, a thread 8 channels of a row by 16-byte loads of x, dy,
//   y and dpre, four rows a thread in flight. In a block: a fixed
//   xor-shuffle tree over a warp's row lanes, then the warps in order. The
//   last block of a segment (a ticket word a segment, which that block
//   resets) adds the segment's chunk partials (lane l adds chunks l, l +
//   32, ... in order, then a fixed tree) and writes the segment's scale
//   rstd, sdy / n, coef, sdyxh and sdy. No float atomics: the same bits on
//   every call.
// - `dx`: a thread an 8-channel group of a row, 16-byte loads and stores;
//   block 0 also adds the segments' sdyxh and sdy in order into dscale
//   and dbias (the first launch has ended when it runs).
// Every operation is rounded apart (no contraction) and the division is
// IEEE, as the plain version's torch ops are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;            // rows in flight a thread
constexpr int kSlab = 256;       // channels a block: 8 a thread, one warp
constexpr int kMaxC = 512;       // channels: two slabs
constexpr int kMaxChunks = 256;  // chunks a segment: 8 a lane in the sum

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// dy0 of a row's 8 channels at a masked row: dy, zero where y <= 0 (with a
// tail), plus dpre rounded to bf16 (where given).
__device__ __forceinline__ void grad_at_norm(const int4& dyv, const int4& yv,
                                             const int4& dpv, bool tail,
                                             bool has_pre, float (&d)[8]) {
  unpack8(dyv, d);
  if (tail) {
    float yf[8];
    unpack8(yv, yf);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (!(yf[i] > 0.f)) d[i] = 0.f;
  }
  if (has_pre) {
    float pf[8];
    unpack8(dpv, pf);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = round_bf16(__fadd_rn(d[i], pf[i]));
  }
}

// The last block's sum of a segment's chunk partials part [width, chunks]
// into out[width] (K7's and K20's final sum): warp w takes values w EB,
// w EB + 1, ... (EB = 32 / KP at once), lane l adds chunks l, l + 32, ...,
// l + 32 (KP - 1) of each in order, then a fixed xor-shuffle tree.
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

// Block (s, k, q) = blockIdx.x = (s chunks + k) slabs + q: chunk k of
// segment s's rows, channel slab q. stats: [segments, 3c] (mean, rstd,
// live); part: [segments, 1 + 2c, chunks]; coefs: [segments, 5c] (scale
// rstd, sdy / n, coef, sdyxh, sdy); ticket: a word a segment.
__global__ void __launch_bounds__(kThreads) sums(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ dpre,
    const uint8_t* __restrict__ mask, const float* __restrict__ scale,
    const float* __restrict__ stats, int cap, int c, int chunks,
    int rows_per_chunk, int slabs, float* __restrict__ part,
    int* __restrict__ ticket, float* __restrict__ coefs) {
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
  const bool tail = y != nullptr;
  const bool has_pre = dpre != nullptr;
  const int gc = c0 + (gin ? g * 8 : 0);

  float mean[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = stats[(size_t)s * 3 * c + gc + i];
  float s1[8], s2[8], n = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
  // rows past the chunk re-read its last row (masked out): every load of
  // a pass is unconditional, so all of them are in flight together
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int r = r0 + rl; r < r1; r += kU * rows) {
    int4 xv[kU], dv[kU], yv[kU], pv[kU];
    bool mk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * rows;
      const long long at = (base + min(rr, r1 - 1)) * c + gc;
      mk[u] = mask[base + min(rr, r1 - 1)] && rr < r1;
      xv[u] = __ldg(reinterpret_cast<const int4*>(x + at));
      dv[u] = __ldg(reinterpret_cast<const int4*>(dy + at));
      yv[u] = tail ? __ldg(reinterpret_cast<const int4*>(y + at)) : zero;
      pv[u] = has_pre ? __ldg(reinterpret_cast<const int4*>(dpre + at))
                      : zero;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!mk[u]) continue;
      n += 1.f;
      if (!gin) continue;
      float d[8], xf[8];
      grad_at_norm(dv[u], yv[u], pv[u], tail, has_pre, d);
      unpack8(xv[u], xf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1[i] = __fadd_rn(s1[i], d[i]);
        s2[i] = __fadd_rn(s2[i], __fmul_rn(d[i], __fsub_rn(xf[i], mean[i])));
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
  float* spart = part + (size_t)s * width * chunks;
  // the slab's values of this chunk (the count by slab 0 only)
  for (int e = tid; e < 1 + 2 * cw; e += kThreads) {
    if (e == 0 && q != 0) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      v += e == 0 ? wn[w] : (e <= cw ? ws1[w][e - 1] : ws2[w][e - 1 - cw]);
    const int at = e == 0 ? 0 : (e <= cw ? 1 + c0 + e - 1
                                         : 1 + c + c0 + e - 1 - cw);
    spart[(size_t)at * chunks + k] = v;
  }

  // the segment's last block adds its partials and makes its coefficients
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + s, 1) == chunks * slabs - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int kp = (chunks + 31) / 32;
  if (kp == 1)
    final_sum<1>(spart, chunks, width, fin);
  else if (kp == 2)
    final_sum<2>(spart, chunks, width, fin);
  else if (kp <= 4)
    final_sum<4>(spart, chunks, width, fin);
  else
    final_sum<8>(spart, chunks, width, fin);
  __syncthreads();
  const float cnt = fmaxf(fin[0], 1.f);
  const float* st = stats + (size_t)s * 3 * c;
  float* co = coefs + (size_t)s * 5 * c;
  for (int ch = tid; ch < c; ch += kThreads) {
    const float rstd = st[c + ch];
    const float sdy = fin[1 + ch];
    const float sdyxh = __fmul_rn(fin[1 + c + ch], rstd);
    co[ch] = __fmul_rn(scale[ch], rstd);
    co[c + ch] = __fdiv_rn(sdy, cnt);
    co[2 * c + ch] = st[2 * c + ch] != 0.f ? __fdiv_rn(sdyxh, cnt) : 0.f;
    co[3 * c + ch] = sdyxh;
    co[4 * c + ch] = sdy;
  }
  if (tid == 0) ticket[s] = 0;
}

// A thread an 8-channel group of a row: dx = a ((dy0 - b) - xhat coef) *
// mask with the row's segment's a = scale rstd, b = sdy / n and coef, and
// dres = bf16(dy0) where asked. Block 0 also writes dscale and dbias.
__global__ void __launch_bounds__(kThreads) dx_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ dpre,
    const uint8_t* __restrict__ mask, const float* __restrict__ stats,
    const float* __restrict__ coefs, long long items, int segments, int cap,
    int c, __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dres,
    float* __restrict__ dscale, float* __restrict__ dbias) {
  if (blockIdx.x == 0) {
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float ds = coefs[3 * c + ch], db = coefs[4 * c + ch];
      for (int s = 1; s < segments; ++s) {
        ds = __fadd_rn(ds, coefs[(size_t)s * 5 * c + 3 * c + ch]);
        db = __fadd_rn(db, coefs[(size_t)s * 5 * c + 4 * c + ch]);
      }
      dscale[ch] = ds;
      dbias[ch] = db;
    }
  }
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int groups = c / 8;
  const long long row = i / groups;
  const int ch = (int)(i % groups) * 8;
  const long long at = row * c + ch;
  const float m = mask[row] ? 1.f : 0.f;
  const long long seg = row / cap;
  const float* st = stats + seg * 3 * c;
  const float* co = coefs + seg * 5 * c;
  const int4 zero = make_int4(0, 0, 0, 0);
  float d[8], xf[8], out[8];
  grad_at_norm(__ldg(reinterpret_cast<const int4*>(dy + at)),
               y != nullptr ? __ldg(reinterpret_cast<const int4*>(y + at))
                            : zero,
               dpre != nullptr
                   ? __ldg(reinterpret_cast<const int4*>(dpre + at))
                   : zero,
               y != nullptr, dpre != nullptr, d);
  unpack8(__ldg(reinterpret_cast<const int4*>(x + at)), xf);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    d[j] = __fmul_rn(d[j], m);
    const float xhat = __fmul_rn(__fsub_rn(xf[j], st[ch + j]), st[c + ch + j]);
    const float t = __fsub_rn(__fsub_rn(d[j], co[c + ch + j]),
                              __fmul_rn(xhat, co[2 * c + ch + j]));
    out[j] = __fmul_rn(__fmul_rn(co[ch + j], t), m);
  }
  *reinterpret_cast<int4*>(dx + at) = pack8(out);
  if (dres != nullptr) *reinterpret_cast<int4*>(dres + at) = pack8(d);
}

}  // namespace

// x, dy, y, dpre, dx, dres: [segments * cap, c] bf16, 16-byte aligned, c a
// multiple of 8 up to 512; y (with a ReLU or a residual tail: the forward's
// output), dpre (the pre-relu output's gradient) and dres (with a residual)
// may be null; mask [rows] bool; scale [c] f32; stats [segments, 3c] f32
// (the forward's mean, rstd and live flag); part [segments, 1 + 2c, chunks]
// and coefs [segments, 5c] f32 scratch (1 <= chunks <= 256 blocks of
// rows_per_chunk rows of a segment, chosen by the caller,
// sparse/norm.py:k20_chunks); ticket: a word a segment, zero between calls
// (the kernel leaves them at zero); dscale, dbias [c] f32. Two launches.
extern "C" int eyoc_masked_norm_backward(
    const void* x, const void* dy, const void* y, const void* dpre,
    const void* mask, const void* scale, const void* stats, int segments,
    int cap, int c, int chunks, int rows_per_chunk, void* part, void* ticket,
    void* coefs, void* dx, void* dres, void* dscale, void* dbias,
    void* stream) {
  if (segments <= 0 || cap <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % 8 != 0 || c > kMaxC || chunks < 1 ||
      chunks > kMaxChunks || rows_per_chunk < 1 ||
      (long)chunks * rows_per_chunk < cap)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)y | (uintptr_t)dpre |
       (uintptr_t)dx | (uintptr_t)dres) % 16 != 0)
    return (int)cudaErrorInvalidValue;        // 16-byte loads and stores
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slabs = (c + kSlab - 1) / kSlab;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(dpre);
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* sb = static_cast<const float*>(stats);
  float* cb = static_cast<float*>(coefs);
  sums<<<segments * chunks * slabs, kThreads, 0, st>>>(
      xb, dyb, yb, pb, mb, static_cast<const float*>(scale), sb, cap, c,
      chunks, rows_per_chunk, slabs, static_cast<float*>(part),
      static_cast<int*>(ticket), cb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)segments * cap * (c / 8);
  dx_kernel<<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0,
              st>>>(xb, dyb, yb, pb, mb, sb, cb, items, segments, cap, c,
                    static_cast<__nv_bfloat16*>(dx),
                    static_cast<__nv_bfloat16*>(dres),
                    static_cast<float*>(dscale), static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
