// Two variants of K2 (masked_argmin.cu) at feature widths 32, 64, 128 and
// 256, in one source (any width up to 256: the caller pads the features
// with zero columns to the next of these, ops/knn.py:knn_width, which
// adds an exact +0 to every product and norm):
//
// K8 masked_knn2: the two nearest valid refs of every valid query, squared
// L2, for a batch of independent problems in one launch. Replaces
// eyoc_tpu/ops/knn.py masked_knn with k=2 (:58-65): the first minimum of
// the Gram-form distance row (metrics.py pdist2: (|q|^2 - 2 q.r) + |r|^2,
// clamped at 0) plus a +1e30 bias at masked refs, then that column set to
// 1e30 and the argmin again. Semantics kept: the pair is the top two under
// the (distance, index) order, so the lowest index wins a tie and an
// equal-distance ref with a higher index comes second; an invalid query
// returns (1e30, 0) in both places; a place that no valid ref fills reads
// (1e30, 0), which is what JAX returns there (every masked distance reads
// 1e30 in f32, and the lowest index at 1e30 is 0). Its main-path call is
// the labeling's mutual matching with feature_filter="Lowe": both
// directions of every pair, 2B problems of 16384 x 16384 x 32 at the
// published batch.
//
// K9 masked_argmin_excl: K2 with a spatial exclusion, for the
// hardest-negative mining with safe_radius > 0 (eyoc_tpu/training/
// loss.py:97-111): the nearest candidate feature of each anchor among the
// candidates whose coordinates lie at least r from the anchor's partner
// (squared distance >= r^2). Returns that index and its distance, or
// (1e30, 0) and a flag when every candidate was excluded (JAX's argmin over
// an all-1e9 row gives 0). The exclusion test is the direct form here
// (unfused: one bit pattern a test, which ops/knn.py's
// masked_argmin_excl_gram_split_plain repeats), the Gram form (pdist2) in
// JAX and the plain version, so the two can differ where |d^2 - r^2| is
// within rounding; chip_smoke.py counts such tests.
//
// What bounds them: 2 Nq Nr 32 flops per problem against a few MB of
// inputs (K8: 16 x 16384^2 x 32 on the labeling path; K9: 8192 x 2048 x 32
// and an exclusion test for a pair that wins): operations.
//
// K8 (`knn2_tc`) runs the cross term q.r on the tensor cores at f32
// accuracy by a 3xTF32 split: hi = tf32(a) (cvt.rna), lo = tf32(a - hi),
// q.r ~ lo_q hi_r + hi_q lo_r + hi_q hi_r accumulated in f32 by
// mma.sync m16n8k8 .tf32 (a single TF32 or bf16 product loses rank
// fidelity at Lowe-ratio ties of unit-norm features: eyoc_tpu/geometry/
// metrics.py:22-29); each norm is computed once per staged row in f32.
// - A block takes a query tile (every qtiles-th query, 512 of them, so each
//   block gets its share of the valid prefix), compacts its valid queries
//   in index order (a ballot a warp), stages their rows with 16-byte
//   cp.async and keeps them in registers as A fragments, hi and lo: warp w
//   holds the compacted queries 32 w .. 32 w + 31 (two m16 tiles).
// - The refs of the block's split (every splits-th window of 256) come in
//   windows: a window's valid refs compacted in index order, staged by
//   cp.async while the previous window is swept, then converted once into
//   B fragments (hi and lo, in each lane's order) with their norms and
//   indices by all 16 warps (those without queries too); windows with no
//   valid ref are skipped sixteen at a time. One block of 16 warps an SM,
//   rather than two of 8, converts and stages each window once for twice
//   the queries: the staging's L2 traffic and its barriers, not the MMAs,
//   are most of the kernel's time (the MMAs alone, at profile_k4_mma.py's
//   mma.sync tf32 rate, are about a third).
// - The epilogue takes each accumulator fragment's distances straight into
//   a running top 2 per row: a lane holds 2 rows x 2 columns of each 16 x 8
//   tile, its columns in increasing index order, so a strict compare keeps
//   the lowest index on ties; a tile where no lane's distance beats its
//   row's second place (most of them, once the lists fill) costs one vote
//   and no branch a lane; the four lanes of a row (a quad) then merge
//   their lists under the (distance, index) order by shuffles, and the
//   splits' lists are merged by the last block of a query tile (a ticket
//   counter from kernels.ticket, which it resets) under the same order:
//   the same bits on every call.
// - The [Nq, Nr] matrix never exists.
// - Wider features (KC = D / 32 column chunks of 32, D = 64, 128, 256): the
//   A fragments of all KC chunks would take 64 KC registers a lane, past
//   the 128 that 512 threads an SM leave. So the block's queries stay in
//   shared memory as rows (a tile of 512 / KC queries: its warps 0 ..
//   16 / KC - 1 sweep, the others stage and convert), and each n8 tile's
//   product loops over the chunks, the chunk's A fragments loaded from
//   shared memory and split again (more m16n8k8 k steps a window); a
//   window holds 256 / KC refs, so its B fragments stay 64 KB. The D = 32
//   instance (KC = 1) is the code above, unchanged.
//
// K9 (`excl_tc`) is K8's design with a running (min, argmin) per anchor:
// a block takes 512 consecutive anchors (all valid), read from device
// memory as float4 straight into A fragments, hi and lo (the features in
// pairs a k step: convert<true>), while the first window's cp.async copies
// fly; their partners' coordinates wait in shared memory. The candidates
// of its split come in K8's windows of 256, each with its coordinates;
// each distance is the Gram form on the 3xTF32 products, and only one that
// beats its row's minimum (the lane's, and the quad's shared after a tile
// where one did) is tested for exclusion: the outcome is the same as
// testing every pair, and a tile where no lane's distance wins costs one
// vote. Quads merge by shuffles and the splits in split order at the last
// block of an anchor tile. At the gated step's 8192 x 2048 that is 16
// anchor tiles x 8 splits (one window each): 128 blocks of 16 warps on
// the 132 SMs. Most of its time is the sweep's latency a tile (the chain
// of MMAs, then a winning candidate's exclusion test), with the tensor
// pipe ~40% busy (profiles in PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;                 // feature width of a chunk
constexpr float kBig = 1e30f;

// Slots of the valid entries among the N entries at(e), e < cnt, in order
// of e (mask == nullptr: all valid), over a block of T threads: a ballot a
// warp, the warps' counts added in order. pos[e] is the slot of entry e, or
// -1; returns the count.
template <int N, int T, typename At>
__device__ __forceinline__ int compact(const uint8_t* mask, At at, int cnt,
                                       int* s_warp, int* pos) {
  constexpr int P = (N + T - 1) / T;
  const int lane = threadIdx.x & 31;
  unsigned m[P];
  bool ok[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int e = u * T + threadIdx.x;
    ok[u] = e < cnt && (mask == nullptr || mask[at(e)] != 0);
    m[u] = __ballot_sync(0xffffffffu, ok[u]);
    if (lane == 0 && e < N) s_warp[e >> 5] = __popc(m[u]);
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < N / 32; ++w) total += s_warp[w];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int e = u * T + threadIdx.x;
    if (e < N) {
      int base = 0;
      for (int w = 0; w < (e >> 5); ++w) base += s_warp[w];
      pos[e] = ok[u] ? base + __popc(m[u] & ((1u << lane) - 1u)) : -1;
    }
  }
  return total;
}

// compact() of the entries e = threadIdx.x < N whose flag `ok` is set
template <int N>
__device__ __forceinline__ int compact_flags(bool ok, int* s_warp, int* pos) {
  const int lane = threadIdx.x & 31, e = threadIdx.x;
  const unsigned m = __ballot_sync(0xffffffffu, ok);
  if (lane == 0 && e < N) s_warp[e >> 5] = __popc(m);
  __syncthreads();
  int total = 0, base = 0;
#pragma unroll
  for (int w = 0; w < N / 32; ++w) {
    total += s_warp[w];
    base += w < (e >> 5) ? s_warp[w] : 0;
  }
  if (e < N) pos[e] = ok ? base + __popc(m & ((1u << lane) - 1u)) : -1;
  return total;
}

// (da, ia) before (db, ib) in the (distance, index) order
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// ----------------------------------------------------------------- K8

constexpr int kT8 = 512;               // threads: 16 warps, one block an SM
constexpr int kQ8 = 512;               // queries a tile: 32 a warp
constexpr int kW8 = 256;               // refs a window
constexpr int kRow = 36;               // a staged row's stride in floats:
                                       // fragment reads free of conflicts
constexpr int kSkip = kT8 / 32;        // empty windows tested at once

// The tiles of the instance of KC column chunks (feature width 32 KC):
// queries a tile, refs a window, a staged row's stride in floats.
template <int KC>
struct Tiles {
  static constexpr int kDim = kD * KC;
  static constexpr int kQ = kQ8 / KC;
  static constexpr int kW = kW8 / KC;
  static constexpr int kRowW = kDim + 4;
};

template <int KC>
struct K8Smem {
  using T = Tiles<KC>;
  float raw[(KC == 1 ? T::kQ : T::kW) * T::kRowW];
                                       // staged rows: (KC = 1) the queries,
                                       // then each window's refs
  float4 frag[T::kW / 8][4 * KC][32];  // [n8 tile][k step][lane]: hi b0,
                                       // hi b1, lo b0, lo b1
  float rn[T::kW];                     // |r|^2 of a slot, inf past the refs
  int ridx[T::kW];                     // the ref index of a slot
  int cidx[T::kW];                     // the staged window's ref indices
  int rpos[T::kW];
  int rwarp[T::kW / 32];
  int qpos[T::kQ];
  int qidx[T::kQ];
  int qwarp[T::kQ / 32];
  int ccount;                          // the staged window's valid refs
  int flag[kSkip];
  bool last;
  alignas(16) float qraw[KC == 1 ? 1 : T::kQ * T::kRowW];
                                       // KC > 1: the queries' rows (16-byte
                                       // cp.async targets)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b, a 16 x 8 (row) and b 8 x 8 (col) tf32 tile, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a candidate that comes after every index in the list, its distance
// clamped at 0 only here (the list's are >= 0, so an unclamped d that does
// not pass d < bd[1] would not pass clamped): strict compares
__device__ __forceinline__ void insert2(float d, int j, float (&bd)[2],
                                        int (&bi)[2]) {
  if (d < bd[1]) {
    d = fmaxf(d, 0.f);
    if (!(d < bd[1])) return;
    if (d < bd[0]) {
      bd[1] = bd[0];
      bi[1] = bi[0];
      bd[0] = d;
      bi[0] = j;
    } else {
      bd[1] = d;
      bi[1] = j;
    }
  }
}

// the top two of two sorted lists of disjoint indices, (distance, index)
__device__ __forceinline__ void merge2(float (&ad)[2], int (&ai)[2],
                                       float b0, int j0, float b1, int j1) {
  if (before(b0, j0, ad[0], ai[0])) {
    if (!before(b1, j1, ad[0], ai[0])) {
      b1 = ad[0];
      j1 = ai[0];
    }
    ad[0] = b0;
    ai[0] = j0;
    ad[1] = b1;
    ai[1] = j1;
  } else if (before(b0, j0, ad[1], ai[1])) {
    ad[1] = b0;
    ai[1] = j0;
  }
}

// a candidate into a sorted top-2 list under the (distance, index) order
__device__ __forceinline__ void merge_in2(float d, int i, float (&bd)[2],
                                         int (&bi)[2]) {
  if (before(d, i, bd[0], bi[0])) {
    bd[1] = bd[0];
    bi[1] = bi[0];
    bd[0] = d;
    bi[0] = i;
  } else if (before(d, i, bd[1], bi[1])) {
    bd[1] = d;
    bi[1] = i;
  }
}

// The refs of the block's split: windows w = 0, 1, ... of kW refs from
// (split + splits w) kW.
template <int KC>
struct Windows {
  static constexpr int kW = Tiles<KC>::kW, kDim = Tiles<KC>::kDim,
                       kRowW = Tiles<KC>::kRowW;
  const float* r;
  const uint8_t* rmask;
  int nr, split, splits, count;

  __device__ int start(int w) const { return (split + splits * w) * kW; }

  // this thread's entry of window w is a valid ref
  __device__ bool valid(int w) const {
    const int j = start(w) + (int)threadIdx.x;
    return threadIdx.x < kW && j < nr && (rmask == nullptr || rmask[j] != 0);
  }

  // the first window at or after w with a valid ref (count if none): each
  // warp tests one window of the next kSkip, kW / 32 refs a lane
  __device__ int next_valid(int w, K8Smem<KC>& sm) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (; w < count; w += kSkip) {
      const int ww = w + warp;
      bool any = false;
      if (ww < count) {
        const int j0 = start(ww);
#pragma unroll
        for (int i = 0; i < kW / 32; ++i) {
          const int j = j0 + kW / 32 * lane + i;
          any |= j < nr && (rmask == nullptr || rmask[j] != 0);
        }
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) sm.flag[warp] = any;
      __syncthreads();
      int first = kSkip;
      for (int k = kSkip - 1; k >= 0; --k)
        if (sm.flag[k]) first = k;
      __syncthreads();
      if (first < kSkip) return w + first;
    }
    return count;
  }

  // window w's valid refs (`ok`: this thread's entry is one, read ahead
  // by the caller) compacted into sm.raw by cp.async (rows of kRowW
  // floats), their indices into sm.cidx and their count into sm.ccount;
  // returns the window staged (a later one where w has no valid ref)
  __device__ int stage(int w, bool ok, K8Smem<KC>& sm) const {
    constexpr int kF4 = kDim / 4;          // 16-byte copies a row
    int n = 0, j0 = 0, cnt = 0;
    for (;;) {
      j0 = start(w);
      cnt = min(kW, nr - j0);
      n = compact_flags<kW>(ok, sm.rwarp, sm.rpos);
      __syncthreads();                     // every rpos before it is read
      if (n > 0) break;
      w = next_valid(w + 1, sm);
      if (w >= count) break;
      ok = valid(w);
    }
    if (w < count) {
      for (int e = threadIdx.x; e < cnt; e += kT8)
        if (sm.rpos[e] >= 0) sm.cidx[sm.rpos[e]] = j0 + e;
      for (int e = threadIdx.x; e < cnt * kF4; e += kT8) {
        const int at = sm.rpos[e / kF4];
        if (at >= 0)
          cp_async16(sm.raw + at * kRowW + 4 * (e % kF4),
                     r + (size_t)(j0 + e / kF4) * kDim + 4 * (e % kF4));
      }
      cp_async_commit();
    }
    if (threadIdx.x == 0) sm.ccount = n;
    return w;
  }
};

// The staged window (sm.ccount refs in sm.raw) as B fragments, norms and
// indices; slots past the refs, up to a multiple of 8, are zero rows at an
// infinite norm (they never enter a list). Returns the n8 tiles. kPaired:
// k step kk of quad lane t takes features 8 t + 2 kk and 8 t + 2 kk + 1
// (K9's order, whose A rows load as float4), else 8 kk + t and 8 kk + t + 4;
// k step kk of a wider instance is step kk % 4 of chunk kk / 4 (features
// 32 (kk / 4) on).
template <int KC, bool kPaired = false>
__device__ __forceinline__ int convert(K8Smem<KC>& sm) {
  constexpr int kRowW = Tiles<KC>::kRowW, kSteps = 4 * KC;
  const int n = sm.ccount, tiles = (n + 7) >> 3;
  // a thread a fragment: lane L of n8 tile nt, k step kk holds b0 = row 8
  // nt + L / 4 at its first feature, and b1 at its second
  for (int i = threadIdx.x; i < tiles * 32 * kSteps; i += kT8) {
    const int L = i & 31, kk = (i >> 5) % kSteps, nt = (i >> 5) / kSteps;
    const int s = 8 * nt + (L >> 2);
    const int k4 = kk & 3;
    const int k = 32 * (kk >> 2) +
                  (kPaired ? 8 * (L & 3) + 2 * k4 : 8 * k4 + (L & 3));
    float v0 = 0.f, v1 = 0.f;
    if (s < n) {
      v0 = sm.raw[s * kRowW + k];
      v1 = sm.raw[s * kRowW + k + (kPaired ? 1 : 4)];
    }
    uint32_t h0, l0, h1, l1;
    split(v0, h0, l0);
    split(v1, h1, l1);
    sm.frag[nt][kk][L] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                     __uint_as_float(l0), __uint_as_float(l1));
  }
  // the norms: 8 consecutive threads a row, a float4 of each chunk each
  for (int e = threadIdx.x; e < tiles * 64; e += kT8) {
    const int s = e >> 3, c = e & 7;
    float sq = 0.f;
#pragma unroll
    for (int cc = 0; cc < KC; ++cc) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < n)
        v = *reinterpret_cast<const float4*>(sm.raw + s * kRowW + 32 * cc +
                                             4 * c);
      sq = fmaf(v.x, v.x, sq);
      sq = fmaf(v.y, v.y, sq);
      sq = fmaf(v.z, v.z, sq);
      sq = fmaf(v.w, v.w, sq);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    if (c == 0) {
      sm.rn[s] = s < n ? sq : INFINITY;
      sm.ridx[s] = s < n ? sm.cidx[s] : 0;
    }
  }
  return tiles;
}

// One warp's MT m16 tiles of queries against n8 tile nt of the window:
// the 3xTF32 products (lo_q hi_r + hi_q lo_r + hi_q hi_r) into acc. They
// are 2 MT chains of 6 MMAs (each m16 tile's k steps 0-1 and 2-3 in two
// accumulators, added after): an MMA's result comes ~24 cycles after it
// issues (profile_k4_mma.py), so shorter chains wait less.
template <int MT>
__device__ __forceinline__ void tile_dot(const K8Smem<1>& sm, int nt,
                                         const uint32_t (&ah)[2][4][4],
                                         const uint32_t (&al)[2][4][4],
                                         float (&acc)[MT][4]) {
  const int lane = threadIdx.x & 31;
  float4 f[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) f[kk] = sm.frag[nt][kk][lane];
  float acc2[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = acc2[mt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t h0 = __float_as_uint(f[kk].x),
                   h1 = __float_as_uint(f[kk].y),
                   l0 = __float_as_uint(f[kk].z),
                   l1 = __float_as_uint(f[kk].w);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float(&c)[4] = kk < 2 ? acc[mt] : acc2[mt];
      mma(c, al[mt][kk], h0, h1);
      mma(c, ah[mt][kk], l0, l1);
      mma(c, ah[mt][kk], h0, h1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = __fadd_rn(acc[mt][i],
                                                       acc2[mt][i]);
}

// A warp's 32 staged rows (from qs: row g of the warp's first m16 tile) as
// A fragments, hi and lo (a0: row g, k t4; a1: row g + 8; a2, a3: k t4 +
// 4), and their squared norms.
__device__ __forceinline__ void load_a(const float* qs,
                                       uint32_t (&ah)[2][4][4],
                                       uint32_t (&al)[2][4][4],
                                       float (&qn)[2][2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(qs[(16 * mt + 8 * (i & 1)) * kRow + 8 * kk + t4 + 4 * (i >> 1)],
              ah[mt][kk][i], al[mt][kk][i]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* row = qs + (16 * mt + 8 * h) * kRow + 8 * t4;
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) sq = fmaf(row[k], row[k], sq);
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
      qn[mt][h] = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
    }
}

// A wider instance's A fragments of chunk cc of a warp's 32 rows staged in
// shared memory (qs: row g of the warp's first m16 tile, rows kRowW
// floats apart), hi and lo, in convert<KC, kPaired>'s feature order.
template <int KC, bool kPaired>
__device__ __forceinline__ void load_a_chunk(const float* qs, int cc,
                                             uint32_t (&ah)[2][4][4],
                                             uint32_t (&al)[2][4][4]) {
  constexpr int kRowW = Tiles<KC>::kRowW;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 32 * cc + (kPaired ? 8 * t4 + 2 * kk + (i >> 1)
                                         : 8 * kk + t4 + 4 * (i >> 1));
        split(qs[(16 * mt + 8 * (i & 1)) * kRowW + k], ah[mt][kk][i],
              al[mt][kk][i]);
      }
}

// The squared norms of a warp's 32 staged rows (a wider instance): lane t4
// of a quad adds features 32 cc + 8 t4 .. + 7 of each chunk in order, then
// the quad's by shuffles.
template <int KC>
__device__ __forceinline__ void norms_wide(const float* qs,
                                           float (&qn)[2][2]) {
  constexpr int kRowW = Tiles<KC>::kRowW;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* row = qs + (16 * mt + 8 * h) * kRowW + 8 * t4;
      float sq = 0.f;
#pragma unroll
      for (int cc = 0; cc < KC; ++cc)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          sq = fmaf(row[32 * cc + k], row[32 * cc + k], sq);
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
      qn[mt][h] = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
    }
}

// A wider instance's products of a warp's MT m16 tiles (rows staged at qs)
// against n8 tile nt: each chunk's A fragments from shared memory, then
// its 4 k steps' 3xTF32 MMAs (steps 0-1 and 2-3 of a chunk in two
// accumulators, added after).
template <int MT, int KC, bool kPaired>
__device__ __forceinline__ void tile_dot_wide(const K8Smem<KC>& sm, int nt,
                                              const float* qs,
                                              float (&acc)[MT][4]) {
  const int lane = threadIdx.x & 31;
  float acc2[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = acc2[mt][i] = 0.f;
#pragma unroll 1
  for (int cc = 0; cc < KC; ++cc) {
    uint32_t ah[2][4][4], al[2][4][4];
    load_a_chunk<KC, kPaired>(qs, cc, ah, al);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 f = sm.frag[nt][4 * cc + kk][lane];
      const uint32_t h0 = __float_as_uint(f.x), h1 = __float_as_uint(f.y),
                     l0 = __float_as_uint(f.z), l1 = __float_as_uint(f.w);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float(&c)[4] = kk < 2 ? acc[mt] : acc2[mt];
        mma(c, al[mt][kk], h0, h1);
        mma(c, ah[mt][kk], l0, l1);
        mma(c, ah[mt][kk], h0, h1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = __fadd_rn(acc[mt][i],
                                                       acc2[mt][i]);
}

// The products of n8 tile nt: KC = 1 from the A fragments in registers,
// a wider instance from the rows at qs.
template <int MT, int KC, bool kPaired>
__device__ __forceinline__ void products(const K8Smem<KC>& sm, int nt,
                                         const uint32_t (&ah)[2][4][4],
                                         const uint32_t (&al)[2][4][4],
                                         const float* qs,
                                         float (&acc)[MT][4]) {
  if constexpr (KC == 1)
    tile_dot<MT>(sm, nt, ah, al, acc);
  else
    tile_dot_wide<MT, KC, kPaired>(sm, nt, qs, acc);
}

// One warp's MT m16 tiles of queries against the window's n8 tiles: the
// products (tile_dot), then each distance into the running top 2 of its
// row.
template <int MT, int KC>
__device__ __forceinline__ void sweep(const K8Smem<KC>& sm, int tiles,
                                      const uint32_t (&ah)[2][4][4],
                                      const uint32_t (&al)[2][4][4],
                                      const float* qs,
                                      const float (&qn)[2][2],
                                      float (&bd)[2][2][2],
                                      int (&bi)[2][2][2]) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
#pragma unroll 1
  for (int nt = 0; nt < tiles; ++nt) {
    float acc[MT][4];
    products<MT, KC, false>(sm, nt, ah, al, qs, acc);
    const float2 rn = *reinterpret_cast<const float2*>(sm.rn + 8 * nt +
                                                       2 * t4);
    const int2 j = *reinterpret_cast<const int2*>(sm.ridx + 8 * nt + 2 * t4);
    float d[MT][2][2];
    bool any = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // rows g and g + 8
        d[mt][h][0] =
            __fadd_rn(__fmaf_rn(-2.f, acc[mt][2 * h], qn[mt][h]), rn.x);
        d[mt][h][1] =
            __fadd_rn(__fmaf_rn(-2.f, acc[mt][2 * h + 1], qn[mt][h]), rn.y);
        any |= d[mt][h][0] < bd[mt][h][1] || d[mt][h][1] < bd[mt][h][1];
      }
    }
    if (__any_sync(0xffffffffu, any)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          insert2(d[mt][h][0], j.x, bd[mt][h], bi[mt][h]);
          insert2(d[mt][h][1], j.y, bd[mt][h], bi[mt][h]);
        }
      }
    }
  }
}

// q [batch, nq, 32 KC], r [batch, nr, 32 KC]; out_d / out_i [batch, nq, 2]
template <int KC>
__global__ void __launch_bounds__(kT8, 1) knn2_tc(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ r, const uint8_t* __restrict__ rmask, int nq,
    int nr, float* __restrict__ part_d, int* __restrict__ part_i,
    int* __restrict__ ticket, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  constexpr int kQ = Tiles<KC>::kQ, kW = Tiles<KC>::kW,
                kDim = Tiles<KC>::kDim, kRowW = Tiles<KC>::kRowW,
                kF4 = kDim / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  K8Smem<KC>& sm = *reinterpret_cast<K8Smem<KC>*>(smem);
  const int b = blockIdx.z, splits = gridDim.y, qtiles = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  q += (size_t)b * nq * kDim;
  r += (size_t)b * nr * kDim;
  if (qmask != nullptr) qmask += (size_t)b * nq;
  if (rmask != nullptr) rmask += (size_t)b * nr;
  out_d += (size_t)b * nq * 2;
  out_i += (size_t)b * nq * 2;
  part_d += (size_t)b * splits * nq * 2;
  part_i += (size_t)b * splits * nq * 2;
  // this tile's queries: x, x + qtiles, x + 2 qtiles, ...
  const int x = blockIdx.x;
  const int in_tile = nq > x ? min(kQ, (nq - x + qtiles - 1) / qtiles) : 0;
  const int nv = compact<kQ, kT8>(
      qmask, [x, qtiles](int m) { return x + qtiles * m; }, in_tile,
      sm.qwarp, sm.qpos);
  for (int m = tid; m < in_tile; m += kT8)
    if (sm.qpos[m] >= 0) sm.qidx[sm.qpos[m]] = x + qtiles * m;
  __syncthreads();
  // the valid queries' rows, zero rows up to a warp's 32 (KC > 1: in
  // sm.qraw, where they stay)
  float* const qrows = KC == 1 ? sm.raw : sm.qraw;
  for (int e = tid; e < ((nv + 31) & ~31) * kF4; e += kT8) {
    float* dst = qrows + (e / kF4) * kRowW + 4 * (e % kF4);
    if (e / kF4 < nv)
      cp_async16(dst, q + (size_t)sm.qidx[e / kF4] * kDim + 4 * (e % kF4));
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // warp w: compacted queries 32 w + 16 mt + g (+ 8) as A fragments (KC
  // = 1; a wider instance reads them from qs a tile) and their norms
  const int rows = min(32, nv - 32 * warp);
  const float* qs = qrows + (32 * warp + g) * kRowW;
  uint32_t ah[2][4][4], al[2][4][4];
  float qn[2][2];
  float bd[2][2][2];
  int bi[2][2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qn[mt][h] = 0.f;
      bd[mt][h][0] = bd[mt][h][1] = INFINITY;
      bi[mt][h][0] = bi[mt][h][1] = 0;
    }
  if (rows > 0) {
    if constexpr (KC == 1)
      load_a(qs, ah, al, qn);
    else
      norms_wide<KC>(qs, qn);
  }
  __syncthreads();                         // sm.raw is the refs' from here

  Windows<KC> win{r, rmask, nr, (int)blockIdx.y, splits, 0};
  const int blocks_r = (nr + kW - 1) / kW;
  win.count = blocks_r > win.split
                  ? (blocks_r - win.split + splits - 1) / splits
                  : 0;
  int w = win.count > 0 ? win.stage(0, win.valid(0), sm) : 0;
  while (w < win.count) {
    // the next window's mask, read while this one is converted
    const bool ok = w + 1 < win.count && win.valid(w + 1);
    cp_async_wait_all();
    __syncthreads();
    const int tiles = convert<KC>(sm);
    __syncthreads();
    const int next =
        w + 1 < win.count ? win.stage(w + 1, ok, sm) : win.count;
    if (rows > 16)
      sweep<2, KC>(sm, tiles, ah, al, qs, qn, bd, bi);
    else if (rows > 0)
      sweep<1, KC>(sm, tiles, ah, al, qs, qn, bd, bi);
    w = next;
    __syncthreads();
  }

  // the four lanes of a row merge their lists
  if (rows > 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float d0 = __shfl_xor_sync(0xffffffffu, bd[mt][h][0], off);
          const float d1 = __shfl_xor_sync(0xffffffffu, bd[mt][h][1], off);
          const int j0 = __shfl_xor_sync(0xffffffffu, bi[mt][h][0], off);
          const int j1 = __shfl_xor_sync(0xffffffffu, bi[mt][h][1], off);
          merge2(bd[mt][h], bi[mt][h], d0, j0, d1, j1);
        }
  }
  // lane t4 = 0 of each quad writes its rows' lists
  if (t4 == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = 32 * warp + 16 * mt + 8 * h + g;
        if (slot >= nv) continue;
        const size_t qi = sm.qidx[slot];
        if (splits > 1) {
          const size_t at = ((size_t)blockIdx.y * nq + qi) * 2;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            part_d[at + s] = bd[mt][h][s];
            part_i[at + s] = bi[mt][h][s];
          }
        } else {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const bool found = bd[mt][h][s] < INFINITY;
            out_d[qi * 2 + s] = found ? bd[mt][h][s] : kBig;
            out_i[qi * 2 + s] = found ? bi[mt][h][s] : 0;
          }
        }
      }
  }

  if (splits > 1) {
    // the last block of this query tile merges the splits, in split order
    int* tk = ticket + (size_t)b * qtiles + x;
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(tk, 1) == splits - 1;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    if (tid < nv) {                        // kT8 >= kQ: a slot a thread
      const size_t qi = sm.qidx[tid];
      float md[2] = {INFINITY, INFINITY};
      int mi[2] = {0, 0};
      for (int sp = 0; sp < splits; ++sp) {
        const size_t at = ((size_t)sp * nq + qi) * 2;
#pragma unroll
        for (int s = 0; s < 2; ++s)
          merge_in2(__ldcg(part_d + at + s), __ldcg(part_i + at + s), md,
                    mi);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool found = md[s] < INFINITY;
        out_d[qi * 2 + s] = found ? md[s] : kBig;
        out_i[qi * 2 + s] = found ? mi[s] : 0;
      }
    }
    if (tid == 0) *tk = 0;
  }
  // the tile's invalid queries read (1e30, 0)
  for (int m = tid; m < in_tile; m += kT8) {
    if (sm.qpos[m] < 0) {
      const size_t qi = x + (size_t)qtiles * m;
      for (int s = 0; s < 2; ++s) {
        out_d[qi * 2 + s] = kBig;
        out_i[qi * 2 + s] = 0;
      }
    }
  }
}

// ----------------------------------------------------------------- K9

template <int KC>
struct K9Smem {
  K8Smem<KC> k8;                       // each window's candidates, as K8's
                                       // refs (raw's first kW rows: at KC
                                       // = 1 the anchors stay in
                                       // registers, else in k8.qraw)
  float craw[3 * Tiles<KC>::kW];       // the staged window's coordinates
  float4 cxyz[Tiles<KC>::kW];          // a slot's coordinates (x, y, z, 0)
  float4 pxyz[Tiles<KC>::kQ];          // an anchor's partner's (x, y, z, 0)
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Window w's candidates (every one valid: a slot is its place in the
// window) staged as K8's refs, and their cnt x 3 coordinates flat into
// craw: 16-byte copies where the window's first one is 16-byte aligned (a
// window starts at a multiple of 256 rows), 4-byte ones for the rest.
template <int KC>
__device__ __forceinline__ int stage_window(const Windows<KC>& win, int w,
                                            bool ok, const float* rxyz,
                                            K9Smem<KC>& sm) {
  w = win.stage(w, ok, sm.k8);
  if (w < win.count) {
    const int j0 = win.start(w), nf = 3 * min(Tiles<KC>::kW, win.nr - j0);
    const float* g = rxyz + 3ll * j0;
    const int n16 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? nf / 4 : 0;
    for (int e = threadIdx.x; e < n16; e += kT8)
      cp_async16(sm.craw + 4 * e, g + 4 * e);
    for (int e = 4 * n16 + threadIdx.x; e < nf; e += kT8)
      cp_async4(sm.craw + e, g + e);
    cp_async_commit();
  }
  return w;
}

// |p - c|^2 < r2 in the direct form, unfused: (dx dx + dy dy) + dz dz
__device__ __forceinline__ bool excluded(float4 p, float4 c, float r2) {
  const float dx = __fsub_rn(p.x, c.x), dy = __fsub_rn(p.y, c.y),
              dz = __fsub_rn(p.z, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz)) < r2;
}

// a candidate that comes after every index the lane's running (min,
// argmin) has seen: a candidate above th, a minimum that its row's quad
// holds already, is never the row's; else it is taken where its distance,
// clamped at 0, is smaller than the lane's and it is not excluded (tested
// only then: the outcome is the same)
__device__ __forceinline__ bool wins(float d, float bd, float th) {
  return d < bd && d <= th;
}

__device__ __forceinline__ void take1(float d, int j, float4 c,
                                      const float4* p, float r2, float th,
                                      float& bd, int& bi) {
  if (wins(d, bd, th)) {
    d = fmaxf(d, 0.f);
    if (d < bd && !excluded(*p, c, r2)) {
      bd = d;
      bi = j;
    }
  }
}

// A warp's 32 anchors (rows 32 w + 16 mt + g (+ 8) of the tile, q0 on; 0
// past nv) as A fragments straight from device memory, in convert<true>'s
// feature order: lane (g, t) reads features 8 t .. 8 t + 7 of each of its
// rows as two float4, and k step kk takes 8 t + 2 kk (a0: row g, a1: row
// g + 8) and 8 t + 2 kk + 1 (a2, a3); hi and lo, and the squared norms
// (each lane's 8 features of a row, then the quad's by shuffles).
__device__ __forceinline__ void load_a_rows(const float* q, int q0, int nv,
                                            uint32_t (&ah)[2][4][4],
                                            uint32_t (&al)[2][4][4],
                                            float (&qn)[2][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  float v[2][2][8];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 32 * warp + 16 * mt + 8 * h + g;
      const float4* p =
          reinterpret_cast<const float4*>(q + (size_t)(q0 + row) * kD) +
          2 * t4;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 f = row < nv ? p[c] : make_float4(0.f, 0.f, 0.f, 0.f);
        v[mt][h][4 * c] = f.x;
        v[mt][h][4 * c + 1] = f.y;
        v[mt][h][4 * c + 2] = f.z;
        v[mt][h][4 * c + 3] = f.w;
      }
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(v[mt][i & 1][2 * kk + (i >> 1)], ah[mt][kk][i], al[mt][kk][i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) sq = fmaf(v[mt][h][k], v[mt][h][k], sq);
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
      qn[mt][h] = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
    }
  }
}

// One warp's MT m16 tiles of anchors against the window's n8 tiles: K8's
// 3xTF32 products, then each distance into its row's running (min,
// argmin) over the candidates not excluded. A tile where no lane's
// distance wins costs one vote and no exclusion test; after a tile where
// one did, the quads' minima are shared again (th).
template <int MT, int KC>
__device__ __forceinline__ void sweep_excl(const K9Smem<KC>& sm, int tiles,
                                           const uint32_t (&ah)[2][4][4],
                                           const uint32_t (&al)[2][4][4],
                                           const float* qs,
                                           const float (&qn)[2][2],
                                           const float4* px, float r2,
                                           float (&bd)[2][2],
                                           int (&bi)[2][2],
                                           float (&th)[2][2]) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
#pragma unroll 1
  for (int nt = 0; nt < tiles; ++nt) {
    float acc[MT][4];
    products<MT, KC, true>(sm.k8, nt, ah, al, qs, acc);
    const float2 rn =
        *reinterpret_cast<const float2*>(sm.k8.rn + 8 * nt + 2 * t4);
    const int2 j =
        *reinterpret_cast<const int2*>(sm.k8.ridx + 8 * nt + 2 * t4);
    float d[MT][2][2];
    bool any = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // rows g and g + 8
        d[mt][h][0] =
            __fadd_rn(__fmaf_rn(-2.f, acc[mt][2 * h], qn[mt][h]), rn.x);
        d[mt][h][1] =
            __fadd_rn(__fmaf_rn(-2.f, acc[mt][2 * h + 1], qn[mt][h]), rn.y);
        any |= wins(d[mt][h][0], bd[mt][h], th[mt][h]) ||
               wins(d[mt][h][1], bd[mt][h], th[mt][h]);
      }
    }
    if (__any_sync(0xffffffffu, any)) {
      const float4 c0 = sm.cxyz[8 * nt + 2 * t4],
                   c1 = sm.cxyz[8 * nt + 2 * t4 + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* p = px + 16 * mt + 8 * h;
          take1(d[mt][h][0], j.x, c0, p, r2, th[mt][h], bd[mt][h], bi[mt][h]);
          take1(d[mt][h][1], j.y, c1, p, r2, th[mt][h], bd[mt][h], bi[mt][h]);
          float m = fminf(bd[mt][h], __shfl_xor_sync(0xffffffffu,
                                                     bd[mt][h], 1));
          th[mt][h] = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        }
      }
    }
  }
}

// anchors q [nq, 32 KC] with partner coordinates qxyz [nq, 3], candidates
// r [nr, 32 KC] with coordinates rxyz [nr, 3]; out_d / out_i / out_flag
// [nq]. Block (x, y): anchors x kQ .. x kQ + kQ - 1 against the windows of
// split y; K8's layout (16 warps, 32 anchors a warp: at KC = 1 as A
// fragments, read from device memory while the first window's copies are
// in flight; wider, staged in shared memory as K8's queries).
template <int KC>
__global__ void __launch_bounds__(kT8, 1) excl_tc(
    const float* __restrict__ q, const float* __restrict__ r,
    const float* __restrict__ qxyz, const float* __restrict__ rxyz, float r2,
    int nq, int nr, float* __restrict__ part_d, int* __restrict__ part_i,
    int* __restrict__ ticket, float* __restrict__ out_d,
    int* __restrict__ out_i, uint8_t* __restrict__ out_flag) {
  constexpr int kQ = Tiles<KC>::kQ, kW = Tiles<KC>::kW,
                kDim = Tiles<KC>::kDim, kRowW = Tiles<KC>::kRowW,
                kF4 = kDim / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  K9Smem<KC>& sm = *reinterpret_cast<K9Smem<KC>*>(smem);
  const int splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kQ, nv = min(kQ, nq - q0);
  Windows<KC> win{r, nullptr, nr, (int)blockIdx.y, splits, 0};
  const int blocks_r = (nr + kW - 1) / kW;
  win.count = blocks_r > win.split
                  ? (blocks_r - win.split + splits - 1) / splits
                  : 0;
  // the first window's copies go out before the anchors are read
  int w = win.count > 0 ? stage_window(win, 0, win.valid(0), rxyz, sm) : 0;

  // the partners' coordinates in shared memory (read by a winning
  // candidate's exclusion test); warp w: anchors 32 w + 16 mt + g (+ 8) as
  // A fragments and their norms
  if (tid < nv)
    sm.pxyz[tid] = make_float4(qxyz[3ll * (q0 + tid)],
                               qxyz[3ll * (q0 + tid) + 1],
                               qxyz[3ll * (q0 + tid) + 2], 0.f);
  const int rows = min(32, nv - 32 * warp);
  uint32_t ah[2][4][4], al[2][4][4];
  float qn[2][2], bd[2][2], th[2][2];
  int bi[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qn[mt][h] = 0.f;
      bd[mt][h] = th[mt][h] = INFINITY;
      bi[mt][h] = 0;
    }
  // KC > 1: the anchors' rows into k8.qraw (zero rows up to a warp's
  // 32), then their norms
  const float* qs = sm.k8.qraw + (32 * warp + g) * kRowW;
  if constexpr (KC == 1) {
    if (rows > 0) load_a_rows(q, q0, nv, ah, al, qn);
  } else {
    for (int e = tid; e < ((nv + 31) & ~31) * kF4; e += kT8) {
      float* dst = sm.k8.qraw + (e / kF4) * kRowW + 4 * (e % kF4);
      if (e / kF4 < nv)
        cp_async16(dst, q + (size_t)(q0 + e / kF4) * kDim + 4 * (e % kF4));
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (rows > 0) norms_wide<KC>(qs, qn);
  }
  const float4* px = sm.pxyz + 32 * warp + g;

  while (w < win.count) {
    // the next window's flags, read while this one is converted
    const bool ok = w + 1 < win.count && win.valid(w + 1);
    cp_async_wait_all();
    __syncthreads();
    const int tiles = convert<KC, true>(sm.k8);
    for (int s = tid; s < tiles * 8; s += kT8)
      sm.cxyz[s] = s < sm.k8.ccount
                       ? make_float4(sm.craw[3 * s], sm.craw[3 * s + 1],
                                     sm.craw[3 * s + 2], 0.f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int next = w + 1 < win.count ? stage_window(win, w + 1, ok, rxyz, sm)
                                       : win.count;
    if (rows > 16)
      sweep_excl<2, KC>(sm, tiles, ah, al, qs, qn, px, r2, bd, bi, th);
    else if (rows > 0)
      sweep_excl<1, KC>(sm, tiles, ah, al, qs, qn, px, r2, bd, bi, th);
    w = next;
    __syncthreads();
  }

  // the four lanes of a row merge their minima under (distance, index)
  if (rows > 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, bd[mt][h], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[mt][h], off);
          if (before(od, oi, bd[mt][h], bi[mt][h])) {
            bd[mt][h] = od;
            bi[mt][h] = oi;
          }
        }
  }
  // lane t4 = 0 of each quad writes its rows' minima
  if (t4 == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = 32 * warp + 16 * mt + 8 * h + g;
        if (slot >= nv) continue;
        const size_t qi = q0 + slot;
        if (splits > 1) {
          part_d[(size_t)blockIdx.y * nq + qi] = bd[mt][h];
          part_i[(size_t)blockIdx.y * nq + qi] = bi[mt][h];
        } else {
          const bool found = bd[mt][h] < INFINITY;
          out_d[qi] = found ? bd[mt][h] : kBig;
          out_i[qi] = found ? bi[mt][h] : 0;
          out_flag[qi] = found ? 0 : 1;
        }
      }
  }

  if (splits > 1) {
    // the last block of this anchor tile merges the splits, in split order
    int* tk = ticket + blockIdx.x;
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.k8.last = atomicAdd(tk, 1) == splits - 1;
    __syncthreads();
    if (!sm.k8.last) return;
    __threadfence();
    if (tid < nv) {                        // kT8 >= kQ: an anchor a thread
      const size_t qi = q0 + tid;
      float md = INFINITY;
      int mi = 0;
      for (int sp = 0; sp < splits; ++sp) {
        const float d = __ldcg(part_d + (size_t)sp * nq + qi);
        const int i = __ldcg(part_i + (size_t)sp * nq + qi);
        if (before(d, i, md, mi)) {
          md = d;
          mi = i;
        }
      }
      const bool found = md < INFINITY;
      out_d[qi] = found ? md : kBig;
      out_i[qi] = found ? mi : 0;
      out_flag[qi] = found ? 0 : 1;
    }
    if (tid == 0) *tk = 0;
  }
}

int resident(const void* kernel, int threads, int smem) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// A kernel's shared memory opt-in, once per device
template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, int bytes, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && done[device])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

template <int KC>
cudaError_t k8_smem_attr() {
  static bool done[64] = {};
  return smem_attr(knn2_tc<KC>, (int)sizeof(K8Smem<KC>), done);
}

template <int KC>
cudaError_t k9_smem_attr() {
  static bool done[64] = {};
  return smem_attr(excl_tc<KC>, (int)sizeof(K9Smem<KC>), done);
}

template <int KC>
int resident_kc(int excl) {
  if (excl) {
    if (k9_smem_attr<KC>() != cudaSuccess) return 0;
    return resident((const void*)excl_tc<KC>, kT8, (int)sizeof(K9Smem<KC>));
  }
  if (k8_smem_attr<KC>() != cudaSuccess) return 0;
  return resident((const void*)knn2_tc<KC>, kT8, (int)sizeof(K8Smem<KC>));
}

template <int KC>
int launch_knn2(const void* q, const void* qmask, const void* r,
                const void* rmask, int batch, int nq, int nr, int splits,
                void* part, void* ticket, void* out_d, void* out_i,
                cudaStream_t stream) {
  const cudaError_t err = k8_smem_attr<KC>();
  if (err != cudaSuccess) return (int)err;
  constexpr int kQ = Tiles<KC>::kQ;
  const int qtiles = (nq + kQ - 1) / kQ;
  const size_t np = (size_t)batch * splits * nq * 2;
  dim3 grid(qtiles, splits, batch);
  knn2_tc<KC><<<grid, kT8, sizeof(K8Smem<KC>), stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(qmask),
      static_cast<const float*>(r), static_cast<const uint8_t*>(rmask), nq,
      nr, static_cast<float*>(part), static_cast<int*>(part) + np,
      static_cast<int*>(ticket), static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

template <int KC>
int launch_excl(const void* q, const void* r, const void* qxyz,
                const void* rxyz, float r2, int nq, int nr, int splits,
                void* part, void* ticket, void* out_d, void* out_i,
                void* out_flag, cudaStream_t stream) {
  const cudaError_t err = k9_smem_attr<KC>();
  if (err != cudaSuccess) return (int)err;
  constexpr int kQ = Tiles<KC>::kQ;
  const int qtiles = (nq + kQ - 1) / kQ;
  const size_t np = (size_t)splits * nq;
  dim3 grid(qtiles, splits, 1);
  excl_tc<KC><<<grid, kT8, sizeof(K9Smem<KC>), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<const float*>(qxyz), static_cast<const float*>(rxyz), r2,
      nq, nr, static_cast<float*>(part), static_cast<int*>(part) + np,
      static_cast<int*>(ticket), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<uint8_t*>(out_flag));
  return (int)cudaGetLastError();
}

}  // namespace

// blocks of K8 (excl = 0) or K9 (excl = 1) at feature width dim (32, 64,
// 128 or 256) that the current device holds at once (occupancy x SMs),
// for the caller's choice of splits; 0 on an error
extern "C" int eyoc_masked_knn2_resident(int excl, int dim) {
  switch (dim) {
    case 32: return resident_kc<1>(excl);
    case 64: return resident_kc<2>(excl);
    case 128: return resident_kc<4>(excl);
    case 256: return resident_kc<8>(excl);
    default: return 0;
  }
}

// K8. q [batch, nq, dim], r [batch, nr, dim] f32, 16-byte aligned, dim 32,
// 64, 128 or 256; masks bool [batch, nq] / [batch, nr]. part: 4 * batch *
// splits * nq words of scratch (the split lists' distances, then their
// indices; unused when splits == 1); ticket: batch * ceil(nq / (512 /
// (dim / 32))) ints, zero between calls (the kernel leaves them at zero);
// splits from ops/knn.py:k2_plan. out_d [batch, nq, 2] f32, out_i [batch,
// nq, 2] int32.
extern "C" int eyoc_masked_knn2(const void* q, const void* qmask,
                                const void* r, const void* rmask, int batch,
                                int nq, int nr, int dim, int splits,
                                void* part, void* ticket, void* out_d,
                                void* out_i, void* stream) {
  if (batch <= 0 || nq <= 0) return 0;
  if (splits < 1 || nr < 0 || batch > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)r) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 32:
      return launch_knn2<1>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                            ticket, out_d, out_i, st);
    case 64:
      return launch_knn2<2>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                            ticket, out_d, out_i, st);
    case 128:
      return launch_knn2<4>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                            ticket, out_d, out_i, st);
    case 256:
      return launch_knn2<8>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                            ticket, out_d, out_i, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K9. anchors q [nq, dim] with partner coordinates qxyz [nq, 3], candidates
// r [nr, dim] with coordinates rxyz [nr, 3], f32, every row valid, dim 32,
// 64, 128 or 256; q and r 16-byte aligned; r2 the squared exclusion
// radius. part: 2 * splits * nq words of scratch (unused when splits ==
// 1); ticket: ceil(nq / (512 / (dim / 32))) ints, zero between calls (the
// kernel leaves them at zero); splits from ops/knn.py:k2_plan at K8's
// tiles. out_d [nq] f32 (the squared feature distance, or 1e30 when every
// candidate was excluded), out_i [nq] int32 (0 then), out_flag [nq] bool
// (every candidate was excluded).
extern "C" int eyoc_masked_argmin_excl(const void* q, const void* r,
                                       const void* qxyz, const void* rxyz,
                                       float r2, int nq, int nr, int dim,
                                       int splits, void* part, void* ticket,
                                       void* out_d, void* out_i,
                                       void* out_flag, void* stream) {
  if (nq <= 0) return 0;
  if (splits < 1 || nr < 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)r) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 32:
      return launch_excl<1>(q, r, qxyz, rxyz, r2, nq, nr, splits, part,
                            ticket, out_d, out_i, out_flag, st);
    case 64:
      return launch_excl<2>(q, r, qxyz, rxyz, r2, nq, nr, splits, part,
                            ticket, out_d, out_i, out_flag, st);
    case 128:
      return launch_excl<4>(q, r, qxyz, rxyz, r2, nq, nr, splits, part,
                            ticket, out_d, out_i, out_flag, st);
    case 256:
      return launch_excl<8>(q, r, qxyz, rxyz, r2, nq, nr, splits, part,
                            ticket, out_d, out_i, out_flag, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
