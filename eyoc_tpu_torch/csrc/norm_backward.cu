// K21 masked_norm_backward: the backward of a masked norm over S segments
// of equal row count and of the tail fused after it, in one cooperative
// launch.
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
// What bounds it: bytes (x, dy, y and dpre read once, dx and dresidual
// written once; a few flops an element). Design:
// - One persistent grid of `blocks` (at most the blocks the card holds at
//   once, sparse/norm.py:k21_grid) of 256 threads, launched with
//   cudaLaunchCooperativeKernel. The rows of all segments are split
//   evenly: block b owns rows [b R, (b + 1) R), whatever the channels or
//   the segments, so every SM works at S = 1 too; a block that straddles
//   a segment boundary keeps a partial for each segment it touches (the
//   piece (b, s) at slot b + s of `part`: the pieces in row order have
//   strictly increasing b + s).
// - Phase 1, each input read once from device memory: a thread 8 channels
//   of a row by 16-byte loads of x, dy, y and dpre, four rows in flight;
//   it makes dy0 (exact in bf16) and adds sdy and sdy (x - mean) of its
//   rows; the block's first `cache_rows` rows of x and dy0 (bf16) and
//   their mask bytes stay in dynamic shared memory (up to
//   EYOC_NORM_CACHE_BYTES a block). In a block: a fixed xor-shuffle tree
//   over a warp's row lanes, then the warps in order; the piece's (n, sdy,
//   sdyxc) goes to `part`. A grid barrier.
// - Phase 2: a warp a (segment, channel) of the grid's: lane l adds the
//   segment's pieces l, l + 32, ... in block order, then a fixed
//   xor-shuffle tree (K7's final sum), and lane 0 writes the coefficients
//   (scale rstd, sdy / n, coef, sdyxh, sdy). A second grid barrier.
// - Phase 3: dx and dresidual of the block's rows, the segment's
//   coefficients staged in shared memory, four items a thread in flight,
//   x, dy0 and the mask from the cache (rows past it read again from
//   device memory, where L2 holds most of them); block 0 adds the
//   segments' sdyxh and sdy into dscale and dbias in order.
// No float atomics and no ticket words: the same bits on every call at a
// given grid. Every operation is rounded apart (no contraction) and the
// division is IEEE, as the plain version's torch ops are.
//
// Sync-BN's two-launch form (data parallelism: the batch norm's segment
// spans every rank's rows, and a collective must add the ranks' sums
// between phase 2 and phase 3, which no launch can wait for):
// - `eyoc_masked_norm_backward_sums`: backward_coop<true>, phases 1 and 2
//   on the same grid (no row cache), phase 2 writing each segment's raw
//   sums (n, sdy, sdyxc) [segments, 1 + 2c] in place of the coefficients;
// - the caller's all_reduce of those sums;
// - `eyoc_masked_norm_backward_finish`: a plain launch on the same grid,
//   each block making its segments' coefficients from the sums by phase
//   2's arithmetic, then phase 3 with every row read from device memory;
//   block 0 dscale and dbias from the rank's own sums (the sums pass's
//   output before the all_reduce: a replicated parameter's gradient on
//   one rank, which the data-parallel step averages).
// At one rank its outputs are the one-launch form's bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef EYOC_NORM_CACHE_BYTES
#define EYOC_NORM_CACHE_BYTES (190 * 1024)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;            // rows in flight a thread (phase 1)
constexpr int kU3 = 4;           // items in flight a thread (phase 3)
constexpr int kSpan = 256;       // channels a warp covers: 8 a lane
constexpr int kMaxC = 512;       // channels
// shared memory: the warps' partials [kWarps][2][kSpan] and counts, which
// phase 3 reuses for a segment's coefficients (a, b, coef, mean, rstd: 5C
// floats); then the row cache (x and dy0 a row), then the cached rows'
// mask bytes
constexpr int kRedFloats = kWarps * 2 * kSpan + kWarps;
constexpr int kRedBytes = (kRedFloats * 4 + 15) / 16 * 16;
constexpr int kCacheBytes = EYOC_NORM_CACHE_BYTES;
static_assert(5 * kMaxC <= kRedFloats, "the coefficients fit");

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

// A thread's channel group and row lane when L = C / 8 (rounded up to a
// power of two) threads read a row of C channels, 8 a thread.
struct Lanes {
  int groups, lanes, g, rl, rows, wspan, wgrp;
  __device__ Lanes(int c, int threads) {
    groups = c / 8;
    lanes = 1;
    while (lanes < groups) lanes *= 2;
    g = threadIdx.x & (lanes - 1);   // channel group: channels 8g .. 8g+7
    rl = threadIdx.x / lanes;        // row lane
    rows = threads / lanes;          // rows a pass
    wspan = lanes < 32 ? lanes : 32;  // groups a warp's lanes hold
    wgrp = lanes > 32 ? lanes / 32 : 1;  // warps a row spans
  }
};

// The block's piece (n, s1[c], s2[c]) from each thread's sums of its rows
// (n counted by the threads of channel group 0): a fixed xor-shuffle tree
// over a warp's row lanes, then the warps that cover a channel in order,
// into pp[0 .. 1 + 2c). ws: [kWarps][2][kSpan] floats, wn: [kWarps].
template <int kWarps>
__device__ __forceinline__ void write_piece(const Lanes& ln, float n,
                                            float (&s1)[8], float (&s2)[8],
                                            int c, float* ws, float* wn,
                                            float* pp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off >= ln.lanes; off >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, off);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  }
  if (lane < ln.wspan) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ws[(warp * 2) * kSpan + lane * 8 + i] = s1[i];
      ws[(warp * 2 + 1) * kSpan + lane * 8 + i] = s2[i];
    }
  }
  if (lane == 0) wn[warp] = n;
  __syncthreads();
  for (int el = threadIdx.x; el < 1 + 2 * c; el += kWarps * 32) {
    float v = 0.f;
    if (el == 0) {
      for (int w = 0; w < kWarps; ++w) v += wn[w];
    } else {
      const int ch = el <= c ? el - 1 : el - 1 - c;
      const int k = el <= c ? 0 : 1;
      const int grp = (ch >> 3) / ln.wspan;     // which warp of a row
      const int at = ((ch >> 3) % ln.wspan) * 8 + (ch & 7);
      for (int w = 0; w < kWarps; ++w)
        if (w % ln.wgrp == grp) v += ws[(w * 2 + k) * kSpan + at];
    }
    pp[el] = v;
  }
  __syncthreads();
}

// The sums of values e[0 .. K) of segment s over its pieces, in K7's final
// order, by one warp: lane l adds the pieces l, l + 32, ... in block order,
// then a fixed xor-shuffle tree; every lane returns lane 0's sums.
template <int K>
__device__ __forceinline__ void warp_segment_sums(const float* part,
                                                  int width, int s, int cap,
                                                  int rows_per_block,
                                                  const int (&e)[K],
                                                  float (&v)[K]) {
  const int lane = threadIdx.x & 31;
  const int b0 = (int)((long long)s * cap / rows_per_block);
  const int nb =
      (int)((((long long)s + 1) * cap - 1) / rows_per_block) - b0 + 1;
  const float* p0 = part + (size_t)(b0 + s) * width;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  for (int j = lane; j < nb; j += 32) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __ldcg(p0 + (size_t)j * width + e[k]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __shfl_sync(0xffffffffu, v[k], 0);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// dy0 of a row's 8 channels: dy, zero where y <= 0 (with a tail), plus
// dpre rounded to bf16 (where given).
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

// bytes of the row cache and its mask bytes for cache_rows rows of c
// channels (x and dy0 in bf16, then a byte a row)
__host__ __device__ __forceinline__ int cache_bytes(int cache_rows, int c) {
  return cache_rows * 4 * c + (cache_rows + 15) / 16 * 16;
}

// Phase 3 over rows [a, e) of one segment: dx and dres, the segment's
// coefficients in sc (scale rstd, sdy / n, coef, then mean and rstd: 5c
// floats); kU3 items a thread at once, the block's first crows rows (from
// r0) from the cache (x, dy0, the mask), the others' x, dy, y, dpre and
// mask from device memory.
__device__ __forceinline__ void finish_rows(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ dpre,
    const uint8_t* __restrict__ mask, const float* sc, int c, int groups,
    long long a, long long e, long long r0, int crows, const int4* cache,
    const uint8_t* mcache, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dres) {
  const int tid = threadIdx.x;
  const bool tail = y != nullptr;
  const bool has_pre = dpre != nullptr;
  const int4 zero = make_int4(0, 0, 0, 0);
  const long long items = (e - a) * groups;
  for (long long i0 = tid; i0 < items; i0 += (long long)kThreads * kU3) {
    int4 xv[kU3], dv[kU3], yv[kU3], pv[kU3];
    bool mk[kU3], cached[kU3];
#pragma unroll
    for (int u = 0; u < kU3; ++u) {
      const long long i = min(i0 + (long long)u * kThreads, items - 1);
      const long long row = a + i / groups;
      const int gg = (int)(i % groups);
      cached[u] = row - r0 < crows;
      if (cached[u]) {
        const int4* cr = cache + (size_t)(row - r0) * 2 * groups;
        xv[u] = cr[gg];
        dv[u] = cr[groups + gg];
        mk[u] = mcache[row - r0] != 0;
        yv[u] = pv[u] = zero;
      } else {
        const long long at = row * c + gg * 8;
        xv[u] = __ldg(reinterpret_cast<const int4*>(x + at));
        dv[u] = __ldg(reinterpret_cast<const int4*>(dy + at));
        yv[u] = tail ? __ldg(reinterpret_cast<const int4*>(y + at)) : zero;
        pv[u] = has_pre ? __ldg(reinterpret_cast<const int4*>(dpre + at))
                        : zero;
        mk[u] = mask[row] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kU3; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i >= items) continue;
      const long long row = a + i / groups;
      const int ch = (int)(i % groups) * 8;
      const long long at = row * c + ch;
      const float m = mk[u] ? 1.f : 0.f;
      float d[8], xf[8], out[8];
      if (cached[u])
        unpack8(dv[u], d);
      else
        grad_at_norm(dv[u], yv[u], pv[u], tail, has_pre, d);
      unpack8(xv[u], xf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[j] = __fmul_rn(d[j], m);
        const float xhat = __fmul_rn(__fsub_rn(xf[j], sc[3 * c + ch + j]),
                                     sc[4 * c + ch + j]);
        const float t = __fsub_rn(__fsub_rn(d[j], sc[c + ch + j]),
                                  __fmul_rn(xhat, sc[2 * c + ch + j]));
        out[j] = __fmul_rn(__fmul_rn(sc[ch + j], t), m);
      }
      *reinterpret_cast<int4*>(dx + at) = pack8(out);
      if (dres != nullptr) *reinterpret_cast<int4*>(dres + at) = pack8(d);
    }
  }
}

// x, dy, y, dpre, dx, dres: [segments * cap, c]; part: [blocks + segments
// - 1, 1 + 2c] (the pieces' n, sdy, sdyxc); coefs: [segments, 5c] (scale
// rstd, sdy / n, coef, sdyxh, sdy). kSumsOnly (sync-BN's sums pass): coefs
// is [segments, 1 + 2c], each segment's raw (n, sdy, sdyxc), and the
// kernel ends after phase 2 (scale, dx, dres, dscale, dbias unused).
template <bool kSumsOnly>
__global__ void __launch_bounds__(kThreads, 1) backward_coop(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ dpre,
    const uint8_t* __restrict__ mask, const float* __restrict__ scale,
    const float* __restrict__ stats, int segments, int cap, int c,
    int rows_per_block, int cache_rows, float* __restrict__ part,
    float* __restrict__ coefs, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dres, float* __restrict__ dscale,
    float* __restrict__ dbias) {
  extern __shared__ int4 smem[];
  float* ws = reinterpret_cast<float*>(smem);          // [kWarps][2][kSpan]
  float* wn = ws + kWarps * 2 * kSpan;                 // [kWarps]
  float* sc = reinterpret_cast<float*>(smem);          // [5][c]
  int4* cache = smem + kRedBytes / 16;                 // [rows][2][groups]
  uint8_t* mcache = reinterpret_cast<uint8_t*>(cache) +
                    (size_t)cache_rows * 4 * c;        // [rows]
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const Lanes ln(c, kThreads);
  const int groups = ln.groups, g = ln.g;
  const bool gin = g < groups;
  const int gc = gin ? g * 8 : 0;
  const int width = 1 + 2 * c;
  const long long total = (long long)segments * cap;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(total, r0 + rows_per_block);
  const int s_lo = (int)(r0 / cap), s_hi = (int)((r1 - 1) / cap);
  const bool tail = y != nullptr;
  const bool has_pre = dpre != nullptr;
  const int4 zero = make_int4(0, 0, 0, 0);

  // ---- phase 1: each piece's sums; x, dy0 and the mask into the cache
  const int crows = (int)min((long long)cache_rows, r1 - r0);
  for (int s = s_lo; s <= s_hi; ++s) {
    const long long a = max(r0, (long long)s * cap);
    const long long e = min(r1, (long long)(s + 1) * cap);
    float mean[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mean[i] = stats[(size_t)s * 3 * c + gc + i];
    float s1[8], s2[8], n = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
    // rows past the piece re-read its last row (masked out): every load
    // of a pass is unconditional, so all of them are in flight together
    for (long long r = a + ln.rl; r < e; r += kU * ln.rows) {
      int4 xv[kU], dv[kU], yv[kU], pv[kU];
      bool mk[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long rr = r + u * ln.rows;
        const long long rc = min(rr, e - 1);
        const long long at = rc * c + gc;
        mk[u] = mask[rc] && rr < e;
        xv[u] = __ldg(reinterpret_cast<const int4*>(x + at));
        dv[u] = __ldg(reinterpret_cast<const int4*>(dy + at));
        yv[u] = tail ? __ldg(reinterpret_cast<const int4*>(y + at)) : zero;
        pv[u] = has_pre ? __ldg(reinterpret_cast<const int4*>(dpre + at))
                        : zero;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long rr = r + u * ln.rows;
        if (rr >= e || !gin) continue;
        float d[8], xf[8];
        grad_at_norm(dv[u], yv[u], pv[u], tail, has_pre, d);
        if (rr - r0 < crows) {
          int4* row = cache + (size_t)(rr - r0) * 2 * groups;
          row[g] = xv[u];
          row[groups + g] = pack8(d);
          if (g == 0) mcache[rr - r0] = mk[u];
        }
        if (!mk[u]) continue;
        if (g == 0) n += 1.f;
        unpack8(xv[u], xf);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s1[i] = __fadd_rn(s1[i], d[i]);
          s2[i] =
              __fadd_rn(s2[i], __fmul_rn(d[i], __fsub_rn(xf[i], mean[i])));
        }
      }
    }
    write_piece<kWarps>(ln, n, s1, s2, c, ws, wn,
                        part + (size_t)(blockIdx.x + s) * width);
  }
  grid.sync();

  // ---- phase 2: a warp a (segment, channel) of the grid's: the segment's
  // sums over its pieces, then its coefficients
  const int warp = tid >> 5, lane = tid & 31;
  for (int task = blockIdx.x * kWarps + warp; task < segments * c;
       task += gridDim.x * kWarps) {
    const int s = task / c, ch = task % c;
    const int e[3] = {0, 1 + ch, 1 + c + ch};
    float v[3];
    warp_segment_sums<3>(part, width, s, cap, rows_per_block, e, v);
    if constexpr (kSumsOnly) {
      if (lane == 0) {
        float* so = coefs + (size_t)s * width;
        if (ch == 0) so[0] = v[0];
        so[1 + ch] = v[1];
        so[1 + c + ch] = v[2];
      }
      continue;
    }
    const float* st = stats + (size_t)s * 3 * c;
    const float rstd = st[c + ch], live = st[2 * c + ch], sca = scale[ch];
    if (lane == 0) {
      const float cnt = fmaxf(v[0], 1.f);
      float* co = coefs + (size_t)s * 5 * c;
      const float sdyxh = __fmul_rn(v[2], rstd);
      co[ch] = __fmul_rn(sca, rstd);
      co[c + ch] = __fdiv_rn(v[1], cnt);
      co[2 * c + ch] = live != 0.f ? __fdiv_rn(sdyxh, cnt) : 0.f;
      co[3 * c + ch] = sdyxh;
      co[4 * c + ch] = v[1];
    }
  }
  if constexpr (kSumsOnly) return;
  grid.sync();

  // ---- phase 3: dx and dres of the block's rows, segment by segment;
  // block 0 adds the segments' sdyxh and sdy into dscale and dbias in order
  if (blockIdx.x == 0) {
    for (int ch = tid; ch < c; ch += kThreads) {
      float ds = __ldcg(coefs + 3 * c + ch), db = __ldcg(coefs + 4 * c + ch);
      for (int s = 1; s < segments; ++s) {
        ds = __fadd_rn(ds, __ldcg(coefs + (size_t)s * 5 * c + 3 * c + ch));
        db = __fadd_rn(db, __ldcg(coefs + (size_t)s * 5 * c + 4 * c + ch));
      }
      dscale[ch] = ds;
      dbias[ch] = db;
    }
  }
  for (int s = s_lo; s <= s_hi; ++s) {
    for (int i = tid; i < 3 * c; i += kThreads)
      sc[i] = __ldcg(coefs + (size_t)s * 5 * c + i);
    for (int i = tid; i < 2 * c; i += kThreads)
      sc[3 * c + i] = stats[(size_t)s * 3 * c + i];
    __syncthreads();
    const long long a = max(r0, (long long)s * cap);
    const long long e = min(r1, (long long)(s + 1) * cap);
    finish_rows(x, dy, y, dpre, mask, sc, c, groups, a, e, r0, crows, cache,
                mcache, dx, dres);
    __syncthreads();
  }
}

// Sync-BN's finish pass: K21's phase 3 from the segments' sums [segments,
// 1 + 2c] (every rank's, added), on the sums pass's grid, a plain launch.
// Each block makes the coefficients of the segments its rows touch by
// phase 2's arithmetic (so one rank's sums give the one-launch form's
// bits); block 0 adds the segments' sdyxh and sdy in order.
__global__ void __launch_bounds__(kThreads) backward_finish(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ dpre,
    const uint8_t* __restrict__ mask, const float* __restrict__ scale,
    const float* __restrict__ stats, const float* __restrict__ sums,
    const float* __restrict__ own, int segments, int cap, int c,
    int rows_per_block, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dres, float* __restrict__ dscale,
    float* __restrict__ dbias) {
  extern __shared__ int4 smem[];
  float* sc = reinterpret_cast<float*>(smem);          // [5][c]
  const int tid = threadIdx.x;
  const int width = 1 + 2 * c;
  const int groups = c / 8;
  const long long total = (long long)segments * cap;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(total, r0 + rows_per_block);
  const int s_lo = (int)(r0 / cap), s_hi = (int)((r1 - 1) / cap);
  if (blockIdx.x == 0) {
    for (int ch = tid; ch < c; ch += kThreads) {
      float ds = __fmul_rn(own[1 + c + ch], stats[c + ch]);
      float db = own[1 + ch];
      for (int s = 1; s < segments; ++s) {
        const float* v = own + (size_t)s * width;
        ds = __fadd_rn(ds, __fmul_rn(v[1 + c + ch],
                                     stats[(size_t)s * 3 * c + c + ch]));
        db = __fadd_rn(db, v[1 + ch]);
      }
      dscale[ch] = ds;
      dbias[ch] = db;
    }
  }
  for (int s = s_lo; s <= s_hi; ++s) {
    const float* v = sums + (size_t)s * width;
    const float* st = stats + (size_t)s * 3 * c;
    const float cnt = fmaxf(v[0], 1.f);
    for (int ch = tid; ch < c; ch += kThreads) {
      const float rstd = st[c + ch];
      const float sdyxh = __fmul_rn(v[1 + c + ch], rstd);
      sc[ch] = __fmul_rn(scale[ch], rstd);
      sc[c + ch] = __fdiv_rn(v[1 + ch], cnt);
      sc[2 * c + ch] = st[2 * c + ch] != 0.f ? __fdiv_rn(sdyxh, cnt) : 0.f;
    }
    for (int i = tid; i < 2 * c; i += kThreads) sc[3 * c + i] = st[i];
    __syncthreads();
    const long long a = max(r0, (long long)s * cap);
    const long long e = min(r1, (long long)(s + 1) * cap);
    finish_rows(x, dy, y, dpre, mask, sc, c, groups, a, e, r0, 0, nullptr,
                nullptr, dx, dres);
    __syncthreads();
  }
}

// bytes of dynamic shared memory a block asks for
int smem_bytes(int cache_rows, int c) {
  return kRedBytes + cache_bytes(cache_rows, c);
}

// the rows of c channels whose x, dy0 and mask fit the cache
int fit_rows(int c) {
  int rows = kCacheBytes / (4 * c + 1);
  while (rows > 0 && cache_bytes(rows, c) > kCacheBytes) --rows;
  return rows;
}

int resident_blocks(int device) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && cached[device] > 0)
    return cached[device];
  const int bytes = kRedBytes + kCacheBytes;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(backward_coop<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    backward_coop<false>,
                                                    kThreads, bytes) !=
          cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  if (device >= 0 && device < kMaxDevices) cached[device] = blocks;
  return blocks;
}

}  // namespace

// Blocks of the kernel that the current device holds at once (occupancy at
// the largest cache x SMs; 0 on an error), for the caller's grid
// (sparse/norm.py:k21_grid).
extern "C" int eyoc_masked_norm_backward_resident(void) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  return resident_blocks(device);
}

// x, dy, y, dpre, dx, dres: [segments * cap, c] bf16, 16-byte aligned, c a
// multiple of 8 up to 512; y (with a ReLU or a residual tail: the forward's
// output), dpre (the pre-relu output's gradient) and dres (with a residual)
// may be null; mask [rows] bool; scale [c] f32; stats [segments, 3c] f32
// (the forward's mean, rstd and live flag); part [blocks + segments - 1,
// 1 + 2c] and coefs [segments, 5c] f32 scratch; blocks (at most the resident blocks) of
// rows_per_block rows each cover the rows, the last one not empty
// (sparse/norm.py:k21_grid); dscale, dbias [c] f32. One cooperative
// launch; a refused one returns its error.
extern "C" int eyoc_masked_norm_backward(
    const void* x, const void* dy, const void* y, const void* dpre,
    const void* mask, const void* scale, const void* stats, int segments,
    int cap, int c, int blocks, int rows_per_block, void* part, void* coefs,
    void* dx, void* dres, void* dscale, void* dbias, void* stream) {
  if (segments <= 0 || cap <= 0) return (int)cudaSuccess;
  const long long total = (long long)segments * cap;
  if (c <= 0 || c % 8 != 0 || c > kMaxC || blocks < 1 ||
      rows_per_block < 1 || (long long)blocks * rows_per_block < total ||
      (long long)(blocks - 1) * rows_per_block >= total)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)y | (uintptr_t)dpre |
       (uintptr_t)dx | (uintptr_t)dres) % 16 != 0)
    return (int)cudaErrorInvalidValue;        // 16-byte loads and stores
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int resident = resident_blocks(device);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int fit = fit_rows(c);
  int cache_rows = rows_per_block < fit ? rows_per_block : fit;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(dpre);
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* scb = static_cast<const float*>(scale);
  const float* sb = static_cast<const float*>(stats);
  float* pp = static_cast<float*>(part);
  float* cb = static_cast<float*>(coefs);
  __nv_bfloat16* dxb = static_cast<__nv_bfloat16*>(dx);
  __nv_bfloat16* drb = static_cast<__nv_bfloat16*>(dres);
  float* dsb = static_cast<float*>(dscale);
  float* dbb = static_cast<float*>(dbias);
  void* args[] = {(void*)&xb,  (void*)&dyb, (void*)&yb,  (void*)&pb,
                  (void*)&mb,  (void*)&scb, (void*)&sb,  (void*)&segments,
                  (void*)&cap, (void*)&c,   (void*)&rows_per_block,
                  (void*)&cache_rows,       (void*)&pp,  (void*)&cb,
                  (void*)&dxb, (void*)&drb, (void*)&dsb, (void*)&dbb};
  err = cudaLaunchCooperativeKernel(
      backward_coop<false>, dim3(blocks), dim3(kThreads), args,
      (size_t)smem_bytes(cache_rows, c), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Sync-BN's sums pass: x, dy, y, dpre, mask, stats and the grid as
// eyoc_masked_norm_backward's (the same blocks, so the same pieces and
// sums); part [blocks + segments - 1, 1 + 2c] f32 scratch; sums [segments,
// 1 + 2c] f32, each segment's (n, sum dy0, sum dy0 (x - mean)). One
// cooperative launch (no row cache); a refused one returns its error.
extern "C" int eyoc_masked_norm_backward_sums(
    const void* x, const void* dy, const void* y, const void* dpre,
    const void* mask, const void* stats, int segments, int cap, int c,
    int blocks, int rows_per_block, void* part, void* sums, void* stream) {
  if (segments <= 0 || cap <= 0) return (int)cudaSuccess;
  const long long total = (long long)segments * cap;
  if (c <= 0 || c % 8 != 0 || c > kMaxC || blocks < 1 ||
      rows_per_block < 1 || (long long)blocks * rows_per_block < total ||
      (long long)(blocks - 1) * rows_per_block >= total)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)y | (uintptr_t)dpre) % 16 !=
      0)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = smem_bytes(0, c);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, backward_coop<true>, kThreads, bytes)) != cudaSuccess)
    return (int)err;
  if (blocks > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  int cache_rows = 0;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  const __nv_bfloat16* yb = static_cast<const __nv_bfloat16*>(y);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(dpre);
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const float* scb = nullptr;
  const float* sb = static_cast<const float*>(stats);
  float* pp = static_cast<float*>(part);
  float* so = static_cast<float*>(sums);
  __nv_bfloat16* dxb = nullptr;
  __nv_bfloat16* drb = nullptr;
  float* dsb = nullptr;
  float* dbb = nullptr;
  void* args[] = {(void*)&xb,  (void*)&dyb, (void*)&yb,  (void*)&pb,
                  (void*)&mb,  (void*)&scb, (void*)&sb,  (void*)&segments,
                  (void*)&cap, (void*)&c,   (void*)&rows_per_block,
                  (void*)&cache_rows,       (void*)&pp,  (void*)&so,
                  (void*)&dxb, (void*)&drb, (void*)&dsb, (void*)&dbb};
  err = cudaLaunchCooperativeKernel(backward_coop<true>, dim3(blocks),
                                    dim3(kThreads), args, (size_t)bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Sync-BN's finish pass: x, dy, y, dpre, mask, scale, stats, dx, dres,
// dscale, dbias as eyoc_masked_norm_backward's; sums [segments, 1 + 2c]
// f32 (the sums pass's, added over the ranks), own the same of this rank
// alone (dscale and dbias come from it); the blocks are the rows' split by
// rows_per_block, the sums pass's grid. One plain launch.
extern "C" int eyoc_masked_norm_backward_finish(
    const void* x, const void* dy, const void* y, const void* dpre,
    const void* mask, const void* scale, const void* stats, const void* sums,
    const void* own, int segments, int cap, int c, int rows_per_block,
    void* dx, void* dres, void* dscale, void* dbias, void* stream) {
  if (segments <= 0 || cap <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % 8 != 0 || c > kMaxC || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)y | (uintptr_t)dpre |
       (uintptr_t)dx | (uintptr_t)dres) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)segments * cap;
  const int blocks = (int)((total + rows_per_block - 1) / rows_per_block);
  backward_finish<<<blocks, kThreads, (size_t)5 * c * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(dpre),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(scale),
      static_cast<const float*>(stats), static_cast<const float*>(sums),
      static_cast<const float*>(own), segments, cap, c, rows_per_block,
      static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(dres), static_cast<float*>(dscale),
      static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
