// K13 sc2_nms: SC2-PCR's NMS seeds for B problems at once.
//
// Replaces eyoc_tpu/registration/sc2pcr.py:151 `_pick_seeds` together with
// the [N, N] masked distances it is fed (:291). For problem b and row i:
//
//   local[b, i] = score[b, i] * flag[b, i],
//   flag = 0 iff some j has valid[b, i] & valid[b, j],
//          !(score[b, i] >= score[b, j]) and !(|s_i - s_j| >= radius),
//
// which is the plain version's `scores * all(relation)` with the invalid
// pairs at an infinite distance; then the top S local scores (ties to the
// lowest index: stable torch.sort's order, and lax.top_k's but for -0.0,
// which lax.top_k puts after +0.0) and seed_ok = local > 0 there. The
// distance is sqrt((dx*dx + dy*dy) + dz*dz) with no fused multiply-add, as
// in K4 and the plain version (registration/sc2pcr.py:_norm3), so every
// radius test agrees with the plain version bit for bit. The square root is
// taken only where the squared distance lies within 2^-18 of radius^2:
// further from it the rounded root is on the same side of the radius.
// Scores are finite (an invalid row's score is read as NaN, which neither
// suppresses nor is suppressed).
//
// Two launches, no library call and no [B, N] score array.
// `nms_flags`: one block a (problem, tile pair I <= J) of 128-row tiles,
// each pair of rows tested once: thread t holds row I*128 + t, tile J sits
// in shared memory as (x, y, z, score) and each row walks its 128 columns;
// a pair within the radius suppresses its lower score, the row in a
// register, the column in a shared word. A suppressed row's flag word is
// set to the call's epoch (every writer stores the same value, so the
// result does not depend on their order); a word that holds an older epoch
// reads as not suppressed, so the words are never cleared (the wrapper
// keeps them per device, zeroed once). A block whose two tiles hold no
// valid row returns at once.
// `nms_rank`: kRankBlocks / B blocks a problem (at least one). Each block
// stages the problem's local scores (score * flag) as keys in shared
// memory, read coalesced, compacts the nonzero ones in index order (a
// thread a contiguous range of rows, placed by block scans), and takes
// groups of kGroup of them by blockIdx: kLaneEntries entries a lane, the
// block's warps splitting the list, an entry p's rank = the entries q
// with local_q > local_p or equal with q < p, plus the zero rows where
// local_p < 0. A zero row's rank is the number of positive entries plus
// the zero rows before it (the first block writes those). Each row whose
// rank is below S writes its slot: the ranks of a problem's N rows are
// 0..N-1, so every slot is written once. Local scores compare as ordered
// integers (the float's bits, negatives flipped): a NaN ranks first, as
// in torch.sort.
//
// What bounds it: operations (a radius test for each pair of valid rows,
// the M^2 comparisons of the M nonzero local scores); its bytes are a few
// per point. No floating-point reduction: the same bits on every call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;        // nms_flags: rows a tile, threads a block
constexpr int kRankThreads = 512;  // nms_rank: threads a block
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankBlocks = 256;   // nms_rank: the blocks of all problems
constexpr int kLaneEntries = 2;    // nms_rank: entries a lane ranks at once
constexpr int kGroup = 32 * kLaneEntries;
// nms_rank holds a problem's keys (twice) and rows in shared memory: 12 N
// bytes, with its 4 KB of counts within the 227 KB a block may opt into
constexpr int kMaxRows = 17920;

// radius test of the plain version, !(|a - b| >= r), from the squared
// distance q: the root only where q is within 2^-18 of r^2
__device__ __forceinline__ bool within(float q, float lo, float hi,
                                       float r) {
  if (q < lo) return true;
  if (q > hi) return false;
  return !(__fsqrt_rn(q) >= r);
}

// |a - b|^2 as ((dx*dx + dy*dy) + dz*dz), unfused
__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kTile) nms_flags(
    const float* __restrict__ src, const bool* __restrict__ valid,
    const float* __restrict__ score, int N, int tiles, int pairs,
    float radius, int epoch, int* __restrict__ flags) {
  __shared__ float4 col[kTile];
  __shared__ int col_flag[kTile];
  __shared__ int any_row, any_col;
  const int t = threadIdx.x;
  const int b = blockIdx.x / pairs;
  // the tile pair (I, J), I <= J, of this block: row I holds tiles - I
  int p = blockIdx.x - b * pairs, I = 0;
  while (p >= tiles - I) {
    p -= tiles - I;
    ++I;
  }
  const int J = I + p;
  const float* P = src + (long long)b * N * 3;
  const bool* V = valid + (long long)b * N;
  const float* Sc = score + (long long)b * N;
  if (t == 0) any_row = any_col = 0;
  __syncthreads();
  const int i = I * kTile + t, j = J * kTile + t;
  const bool vi = i < N && V[i], vj = j < N && V[j];
  const float nan = __int_as_float(0x7FC00000);
  float xi = 0.f, yi = 0.f, zi = 0.f, si = nan;
  if (vi) {
    xi = P[3 * i];
    yi = P[3 * i + 1];
    zi = P[3 * i + 2];
    si = Sc[i];
    any_row = 1;
  }
  col[t] = vj ? make_float4(P[3 * j], P[3 * j + 1], P[3 * j + 2], Sc[j])
              : make_float4(0.f, 0.f, 0.f, nan);
  col_flag[t] = 0;
  if (vj) any_col = 1;
  __syncthreads();
  if (!(any_row && any_col)) return;
  const float r2 = __fmul_rn(radius, radius);
  const float lo = __fmul_rn(r2, 1.f - 0x1p-18f);
  const float hi = __fmul_rn(r2, 1.f + 0x1p-18f);
  // the fused square sum lies within 2^-22 of the unfused one (three
  // roundings of nonnegative terms): above far, the unfused one is above hi
  const float far = __fmul_rn(hi, 1.f + 0x1p-20f);
  bool suppressed = false;
  if (vi) {
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 c = col[k];
      const float dx = __fsub_rn(xi, c.x), dy = __fsub_rn(yi, c.y),
                  dz = __fsub_rn(zi, c.z);
      if (fmaf(dz, dz, fmaf(dy, dy, __fmul_rn(dx, dx))) > far) continue;
      const float q = dist2(xi, yi, zi, c.x, c.y, c.z);
      if (q <= hi && within(q, lo, hi, radius)) {
        if (c.w > si) suppressed = true;
        else if (si > c.w && I != J) col_flag[k] = 1;
      }
    }
  }
  __syncthreads();
  if (suppressed) flags[(long long)b * N + i] = epoch;
  if (col_flag[t]) flags[(long long)b * N + j] = epoch;
}

// the local score's order as an int: the float's bits, negatives flipped,
// every NaN the largest
__device__ __forceinline__ int order_key(float v) {
  if (v != v) return 0x7FC00000;
  const int bits = __float_as_int(v);
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

// The exclusive prefix of v over the block in thread order (a xor-shuffle
// scan in the warp, then the warps before it); `total` gets the sum. One
// barrier; `part` is kRankWarps ints of shared memory.
__device__ __forceinline__ int block_scan(int v, int* part, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v, group = v;            // group: the sum over lane's 2^k lanes
  for (int off = 1; off < 32; off <<= 1) {
    const int other = __shfl_xor_sync(0xFFFFFFFFu, group, off);
    if (lane & off) incl += other;
    group += other;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kRankWarps; ++w) {
    before += w < warp ? part[w] : 0;
    total += part[w];
  }
  return before + incl - v;
}

// c[e] += #{q in [a, b): keys[q] > thr[e]} for a lane's kLaneEntries
// entries, four keys a shared-memory load (the keys 16-byte aligned)
__device__ __forceinline__ void count_above(const int* keys, int a, int b,
                                            const int (&thr)[kLaneEntries],
                                            int (&c)[kLaneEntries]) {
  int q = a;
  for (; q < b && (q & 3); ++q)
#pragma unroll
    for (int e = 0; e < kLaneEntries; ++e) c[e] += keys[q] > thr[e];
#pragma unroll 2
  for (; q + 4 <= b; q += 4) {
    const int4 k = *reinterpret_cast<const int4*>(keys + q);
#pragma unroll
    for (int e = 0; e < kLaneEntries; ++e)
      c[e] += ((k.x > thr[e]) + (k.y > thr[e])) +
              ((k.z > thr[e]) + (k.w > thr[e]));
  }
  for (; q < b; ++q)
#pragma unroll
    for (int e = 0; e < kLaneEntries; ++e) c[e] += keys[q] > thr[e];
}

__global__ void __launch_bounds__(kRankThreads) nms_rank(
    const float* __restrict__ score, const int* __restrict__ flags, int N,
    int S, int blocks, int epoch, int* __restrict__ seeds,
    bool* __restrict__ seed_ok) {
  // every row's key, then the nonzero ones' keys and rows in index order
  extern __shared__ __align__(16) int stage[];   // 16-byte aligned parts
  __shared__ int part[2][kRankWarps];
  __shared__ int count[kRankWarps][kGroup];
  const int N4 = (N + 3) & ~3;
  int* keys = stage + N4;
  int* rows = keys + N4;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / blocks, r = blockIdx.x - b * blocks;
  const float* Sc = score + (long long)b * N;
  const int* F = flags + (long long)b * N;
  int* out = seeds + (long long)b * S;
  bool* ok = seed_ok + (long long)b * S;
  // the local scores' keys, read coalesced; a zero row's key is 0 (+0.0)
  // or -1 (-0.0), no other score's
#pragma unroll 4
  for (int n = t; n < N; n += kRankThreads)
    stage[n] = order_key(__fmul_rn(Sc[n], F[n] == epoch ? 0.f : 1.f));
  __syncthreads();
  // thread t's contiguous range of rows: its nonzero, zero and positive
  // local scores counted, then placed by block scans
  const int per = (N + kRankThreads - 1) / kRankThreads;
  const int n0 = min(N, t * per), n1 = min(N, n0 + per);
  int nz = 0, zero = 0, pos = 0;
  for (int n = n0; n < n1; ++n) {
    const int k = stage[n];
    if (k == 0 || k == -1) {
      ++zero;
    } else {
      ++nz;
      pos += k > 0;                             // positive, or NaN
    }
  }
  int M, Z, P;
  int at = block_scan(nz, part[0], M);
  int zat = block_scan(zero, part[1], Z);
  // part[0] again: every read of it preceded the second scan's barrier
  block_scan(pos, part[0], P);
  for (int n = n0; n < n1; ++n) {
    const int k = stage[n];
    if (k != 0 && k != -1) {
      keys[at] = k;
      rows[at++] = n;
    } else {
      const int rank = P + zat++;
      if (r == 0 && rank < S) {
        out[rank] = n;
        ok[rank] = false;
      }
    }
  }
  __syncthreads();
  // groups of kGroup entries, entry g0 + lane + 32 e in lane's e-th slot;
  // warp w compares them with the list's w-th part: the entries before the
  // group's (q < p) count where key_q >= key_p, those after it where
  // key_q > key_p, the group's own by the rule itself
  const int chunk = (M + kRankWarps - 1) / kRankWarps;
  const int q0 = min(M, warp * chunk), q1 = min(M, q0 + chunk);
  for (int g = r; g * kGroup < M; g += blocks) {
    const int g0 = g * kGroup, g1 = min(M, g0 + kGroup);
    int kp[kLaneEntries], below[kLaneEntries], c[kLaneEntries];
#pragma unroll
    for (int e = 0; e < kLaneEntries; ++e) {
      const int p = g0 + lane + 32 * e;
      kp[e] = p < M ? keys[p] : 0;
      below[e] = kp[e] - 1;                     // key_q >= key_p
      c[e] = 0;
    }
    count_above(keys, q0, min(q1, g0), below, c);
    count_above(keys, max(q0, g1), q1, kp, c);
    for (int q = max(q0, g0); q < min(q1, g1); ++q) {
      const int kq = keys[q];
#pragma unroll
      for (int e = 0; e < kLaneEntries; ++e)
        c[e] += kq > kp[e] || (kq == kp[e] && q < g0 + lane + 32 * e);
    }
#pragma unroll
    for (int e = 0; e < kLaneEntries; ++e) count[warp][lane + 32 * e] = c[e];
    __syncthreads();
    const int p = g0 + t;
    if (t < kGroup && p < M) {
      int rank = 0;
      for (int w = 0; w < kRankWarps; ++w) rank += count[w][t];
      const int k = keys[p];
      if (k < 0) rank += Z;                     // a negative local score
      if (rank < S) {
        out[rank] = rows[p];
        ok[rank] = k > 0 && k <= 0x7F800000;    // > 0: not NaN
      }
    }
    __syncthreads();
  }
}

}  // namespace

// src [B, N, 3] f32, valid [B, N] bool, score [B, N] f32 -> seeds [B, S]
// int32, seed_ok [B, S] bool (S <= N <= kMaxRows). flags: B * N int32
// words that hold no value of `epoch` (the wrapper passes a new epoch each
// call on words it zeroed once).
extern "C" int eyoc_sc2_nms(const float* src, const bool* valid,
                            const float* score, int B, int N, float radius,
                            int S, int epoch, int* flags, int* seeds,
                            bool* seed_ok, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || S <= 0) return cudaSuccess;
  if (S > N || N > kMaxRows || epoch <= 0) return cudaErrorInvalidValue;
  const int tiles = (N + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  nms_flags<<<B * pairs, kTile, 0, stream>>>(src, valid, score, N, tiles,
                                             pairs, radius, epoch, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = 3 * ((N + 3) & ~3) * (int)sizeof(int);
  err = cudaFuncSetAttribute(nms_rank,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int blocks = kRankBlocks / B;
  blocks = blocks < 1 ? 1 : blocks;
  const int groups = (N + kGroup - 1) / kGroup;
  blocks = blocks < groups ? blocks : groups;
  nms_rank<<<B * blocks, kRankThreads, smem, stream>>>(
      score, flags, N, S, blocks, epoch, seeds, seed_ok);
  return cudaGetLastError();
}
