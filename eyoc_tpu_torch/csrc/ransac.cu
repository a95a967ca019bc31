// K16 ransac_hypotheses, K17 ransac_verify and K18 (ransac_polish,
// icp_solve): RANSAC's test path and ICP's solve on the card, with nothing
// read back by the host in between.
//
// K16 replaces eyoc_tpu/registration/ransac.py:55 `_sample_triplets`, :61
// `_edge_ok`, :119 `kabsch(s3, t3)`, the coarse `_count_inliers` of :132
// and the `lax.top_k` of :136 with its gathers. `prep` (one block) counts
// the valid rows, gathers the subset rows (u * count) of the valid prefix
// into scratch and zeroes the control words of the launches after it. A
// hypothesis is its triplet (u * count truncated, in f32), Open3D's
// edge-length check (three unfused norms, |s| / (|t| + 1e-9) inside (lo,
// hi)), the Jacobi Kabsch of the three points with unit weights (so the
// centroids divide by 3 + 1e-6), and its count of the subset rows with
// |R s + t - t'|^2 < thr^2; -1 where the edge check fails.
// Two entries:
// - two-stage (`ransac_hypotheses_topk`, the eval path's): `edge`, one
//   thread a hypothesis, runs the edge check alone, writes -1 for a
//   failure and compacts the survivors into a list in hypothesis order (a
//   block scan, then a decoupled look-back over tiles taken in ticket
//   order); `solve_count`, a persistent grid over that list (its length
//   read on the card), one thread a survivor, solves its pose and counts
//   the subset rows staged in shared memory, and adds the count to a
//   histogram of S + 1 bins; `select_top` finds the threshold count of the
//   top k in the histogram and keeps every survivor above it and the
//   lowest-index survivors at it (a look-back scan of the ties); `sort_top`
//   (one block) adds the lowest-index failing hypotheses where fewer than k
//   survive and sorts the k composite keys (count descending, index
//   ascending: `lax.top_k`'s order) in shared memory;
//   `kept_poses` writes the k kept poses, one thread each, from a cache of
//   the first C survivors' poses, or solved again past it. No [H, 4,
//   4] pose array and no sort over H elements.
// - single-stage (`ransac_hypotheses`): `hypotheses`, one thread a
//   hypothesis, writes every pose and its count (the edge flag alone
//   without a subset).
// K17 replaces the full verification of :140-145 (`_count_inliers`, queue
// item 11): `verify`, one launch of (pose group) x (row split) blocks. A
// group is kVerifyGroup kept hypotheses; a block compacts the group's live
// ones (edge flag coarse >= 0, read through keep on the card) in index
// order and holds two poses a thread in registers; the block's split of
// the rows is staged in shared memory by 16-byte loads, four rows a
// thread, the invalid rows dropped (the first tile's loads and the poses'
// go out together, before the first barrier); every (pose, row) test is
// residual2 < thr2, so each gives the bits of a one-pose-at-a-time count.
// A split's counts are added to integer sums (any order gives the same
// sum); the last block of a group at its ticket writes the group's counts
// as f32 (-1 where the edge check failed) and its first largest count, and
// the last group at the final ticket takes the first argmax over the
// groups in group order and writes the row of trans it names.
// K18 replaces the polish of :148-160 (`ransac_polish`: one block reads
// best on the card, copies the valid rows once into shared memory, runs
// the rounds from there -- warp, |d| < thr, the weighted Jacobi Kabsch, the
// old pose kept where fewer than 3 rows are inliers -- then the final
// inlier count; past kPolishMaxRows rows the same rounds on a cluster of
// kPolishCluster CTAs, each holding the valid rows of its share of the
// input in its shared memory, the CTAs' sums added in rank order through
// distributed shared memory; at most kPolishCluster kPolishMaxRows rows)
// and the solve of
// eyoc_tpu/registration/icp.py:41-46 (`icp_solve`: w = mask & (d2 < r^2)
// from K2's nearest neighbours, the weighted Jacobi Kabsch of the source on
// its matches, and the source warped by the new pose for the next round's
// K2). icp_solve is spread over a fixed grid of G blocks, each owning a
// contiguous chunk of rows, in three launches chained on the stream with
// nothing read back: `icp_moments` (each block's weight and sums to a
// partial row; the last block to take a ticket adds the G partials in
// block order and writes the centroids), `icp_cross` (each block's centred
// cross-covariance; the last block adds them and its thread 0 runs the one
// Jacobi solve) and `icp_warp`. No grid barrier: a block never waits on
// another.
//
// `jacobi_pose`, shared by all three, is the Jacobi Kabsch of
// jacobi_pose.cuh (which K23 and K24 of csrc/sc2_refine.cu solve by too);
// moments in the block kernels are taken in two centred passes (K15's
// form).
//
// Every float reduction runs in a fixed order (a thread's rows in order,
// then a fixed shared-memory tree, or in the polish a fixed xor-shuffle
// tree over each warp and then over the warps' partials), and every list
// is built by scans in index order, so each kernel gives the same bits on
// every call. Divisions and square roots are IEEE (no --use_fast_math).
//
// What bounds them: K16 is operations, ~60 flops for each hypothesis's
// edge check, ~4300 a Jacobi solve and ~27 for each (survivor, subset row);
// only the survivors (~4% on the eval path) are solved and counted. K17 is
// operations, ~27 flops for each (kept hypothesis, valid row), unfused, so
// twice the flop bound at the FMA rate: the groups and splits put four
// blocks on every SM at the eval path's 2048 x 5000 and each row is read
// from shared memory once for two poses; what is left beside the tests is
// the chain of the loads, barriers and tickets (PERF.md); K18's polish
// is one block, a chain of dependent passes and solves: latency, far above
// its bytes and operations (the polish's 5 solves, a chain of 144 IEEE
// divisions and 96 roots each, are most of its time: profile_k18_polish.py).
// icp_solve is latency too: its one solve (~12.8 us) and the two combines
// behind the tickets; the passes over the rows take the whole card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jacobi_pose.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHypThreads = 128;     // hypotheses: one thread a hypothesis
constexpr int kSubTile = 512;        // subset rows staged at a time
constexpr int kPrepThreads = 256;
constexpr int kScanThreads = 256;    // edge, select: a tile of 4 items each
constexpr int kItems = 4;
constexpr int kTile = kScanThreads * kItems;
constexpr int kCountThreads = 64;    // solve_count: one thread a survivor
constexpr int kCountBlocks = 2112;   // its persistent grid, at most
constexpr int kSelectBlocks = 264;   // select_top's persistent grid, at most
constexpr int kSortThreads = 1024;   // sort_top: one block
constexpr int kPoseThreads = 64;     // kept_poses: one thread a kept pose
constexpr int kMaxBins = 2049;       // coarse counts 0..S, S <= 2048
constexpr int kMaxTop = 4096;        // k, sorted in one block's shared memory
// the control words of the two-stage entry (int32, zeroed by prep), then
// the histogram [S + 1] and the two look-back status arrays [tiles]
constexpr int kEdgeTicket = 0, kSelectTicket = 1, kKept = 2,
              kSurvivors = 3, kHist = 4;
// a look-back status word: flag (aggregate, inclusive prefix) | value
constexpr unsigned kAggregate = 1u << 30, kInclusive = 2u << 30,
                   kValue = kAggregate - 1;
constexpr int kWindow = 32;          // status words a look-back round reads
constexpr int kVerifyThreads = 128;  // verify: a block a (group, split)
constexpr int kVerifyWarps = kVerifyThreads / 32;
constexpr int kVerifyPoses = 2;      // kept poses a thread holds
constexpr int kVerifyGroup = kVerifyThreads * kVerifyPoses;
constexpr int kVerifyTile = 4 * kVerifyThreads;  // rows staged: 4 a thread
constexpr int kVerifyMinRows = 32;   // a split's rows, at least
#ifndef EYOC_VERIFY_BLOCKS_PER_SM
#define EYOC_VERIFY_BLOCKS_PER_SM 4
#endif
// the blocks a launch puts on each SM where the pose groups are fewer (a
// host build may set 0: one split a group, several row tiles a block)
constexpr int kVerifyBlocksPerSm = EYOC_VERIFY_BLOCKS_PER_SM;
constexpr int kIcpThreads = 256;     // icp_solve: each launch's blocks
#ifndef EYOC_ICP_BLOCKS
#define EYOC_ICP_BLOCKS 128
#endif
// icp_solve's fixed grid (a host build may set a smaller one); the last
// block stages the G partials of a pass in its n x kIcpThreads sums
constexpr int kIcpBlocks = EYOC_ICP_BLOCKS;
static_assert(kIcpBlocks > 0 && kIcpBlocks <= kIcpThreads, "icp grid");
constexpr int kIcpPart = 16;         // a block's partial row: 7 + 9 sums
constexpr int kPolishThreads = 512;  // polish: a block, or a cluster's CTA
constexpr int kPolishWarps = kPolishThreads / 32;
// polish's rows in shared memory, 6 floats a row: 192 KB of the 227 KB a
// block may opt into (and at most 32 rows a thread: an inlier bit a row);
// past them the wide route spreads the rows over a cluster of
// kPolishCluster CTAs (the portable cluster size), kPolishMaxRows each
constexpr int kPolishMaxRows = 8192;
constexpr int kPolishCluster = 8;

// |a - b| as sqrt((dx*dx + dy*dy) + dz*dz), unfused.
__device__ __forceinline__ float norm3(float dx, float dy, float dz) {
  return __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
}

// R s + t with the row-major 4x4 T: ((R0 x + R1 y) + R2 z) + t, unfused.
__device__ __forceinline__ void warp_point(const float* T, float x, float y,
                                           float z, float* o) {
  for (int r = 0; r < 3; ++r)
    o[r] = add(add(add(mul(T[4 * r], x), mul(T[4 * r + 1], y)),
                   mul(T[4 * r + 2], z)),
               T[4 * r + 3]);
}

// |R s + t - t'|^2 as ((dx*dx + dy*dy) + dz*dz).
__device__ __forceinline__ float residual2(const float* T, float x, float y,
                                           float z, float u, float v,
                                           float w) {
  float o[3];
  warp_point(T, x, y, z, o);
  const float dx = sub(o[0], u), dy = sub(o[1], v), dz = sub(o[2], w);
  return add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
}

// Exclusive prefix sum of v over the block (kThreads threads) in shared
// memory; `total` gets the block's sum.
template <int kThreads>
__device__ int block_exclusive_scan(int v, int* sh, int& total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += add;
    __syncthreads();
  }
  total = sh[kThreads - 1];
  const int incl = sh[t];
  __syncthreads();
  return incl - v;
}

// The decoupled look-back, by the whole block: thread 0 publishes the
// tile's aggregate; each round the first kWindow threads read the status
// words of the kWindow tiles before the round's start, and thread 0 adds
// them from the nearest back: an aggregate adds and goes on, an inclusive
// prefix adds and ends, an unpublished word ends the round (read again
// from there). Thread 0 then publishes the inclusive prefix; every thread
// gets the exclusive one. Tiles are taken in ticket order, so every
// predecessor is running or done. `win` and `st` are shared memory.
__device__ int look_back(unsigned* status, int tile, int agg, unsigned* win,
                         int* st) {
  const int t = threadIdx.x;
  if (t == 0) {
    atomicExch(status + tile, (tile == 0 ? kInclusive : kAggregate) |
                                  (unsigned)agg);
    st[0] = 0;                                   // the exclusive prefix
    st[1] = tile - 1;                            // the next tile to read
  }
  __syncthreads();
  while (st[1] >= 0) {
    const int j = st[1];
    if (t < kWindow)
      win[t] = j - t >= 0
                   ? (unsigned)*reinterpret_cast<volatile unsigned*>(
                         status + j - t)
                   : (unsigned)kInclusive;
    __syncthreads();
    if (t == 0) {
      int i = 0;
      for (; i < kWindow; ++i) {
        const unsigned s = win[i];
        if ((s & ~kValue) == 0) break;            // not published yet
        st[0] += (int)(s & kValue);
        if (s & kInclusive) {
          i = j + 1;                             // done: st[1] becomes -1
          break;
        }
      }
      st[1] = j - i;
    }
    __syncthreads();
  }
  const int excl = st[0];
  if (t == 0 && tile > 0)
    atomicExch(status + tile, kInclusive | (unsigned)(excl + agg));
  __syncthreads();
  return excl;
}

// The triplet of a hypothesis: rows (u * count) truncated, of the valid
// prefix.
__device__ __forceinline__ void load_triplet(
    const float* __restrict__ src, const float* __restrict__ tgt, int N,
    const float* __restrict__ u, float countf, float (&a)[3][3],
    float (&b)[3][3]) {
  for (int k = 0; k < 3; ++k) {
    const int j = min((int)mul(u[k], countf), N - 1);
    for (int c = 0; c < 3; ++c) {
      a[k][c] = src[3 * j + c];
      b[k][c] = tgt[3 * j + c];
    }
  }
}

// Open3D's edge-length check: edges (0,1), (1,2), (2,0).
__device__ __forceinline__ bool edge_ok(const float (&a)[3][3],
                                        const float (&b)[3][3], float lo,
                                        float hi) {
  bool ok = true;
  for (int k = 0; k < 3; ++k) {
    const int l = k == 2 ? 0 : k + 1;
    const float es = norm3(sub(a[k][0], a[l][0]), sub(a[k][1], a[l][1]),
                           sub(a[k][2], a[l][2]));
    const float et = norm3(sub(b[k][0], b[l][0]), sub(b[k][1], b[l][1]),
                           sub(b[k][2], b[l][2]));
    const float ratio = __fdiv_rn(es, add(et, 1e-9f));
    ok = ok && ratio > lo && ratio < hi;
  }
  return ok;
}

// The Jacobi Kabsch of the triplet with unit weights: the centroids divide
// by 3 + 1e-6 (svd3.py:301).
__device__ __forceinline__ void triplet_pose(const float (&a)[3][3],
                                             const float (&b)[3][3],
                                             float* pose) {
  const float wsum = add(3.f, 1e-6f);
  float cA[3], cB[3];
  for (int c = 0; c < 3; ++c) {
    cA[c] = __fdiv_rn(add(add(a[0][c], a[1][c]), a[2][c]), wsum);
    cB[c] = __fdiv_rn(add(add(b[0][c], b[1][c]), b[2][c]), wsum);
  }
  float Hm[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
      for (int k = 0; k < 3; ++k)
        acc = add(acc, mul(sub(a[k][r], cA[r]), sub(b[k][c], cB[c])));
      Hm[3 * r + c] = acc;
    }
  jacobi_pose(Hm, cA, cB, pose);
}

// count = max(sum valid, 1) and the subset rows (u_sub * count) of the
// valid prefix: scratch[0] holds count (as an int), then S rows of (s, t);
// zero[0, nzero) is zeroed (the two-stage entry's control words).
__global__ void __launch_bounds__(kPrepThreads) prep(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, const float* __restrict__ u_sub,
    int S, float* __restrict__ scratch, int* __restrict__ zero, int nzero) {
  __shared__ int cnt[kPrepThreads];
  __shared__ int total;
  const int t = threadIdx.x;
  for (int i = t; i < nzero; i += kPrepThreads) zero[i] = 0;
  int c = 0;
  for (int n = t; n < N; n += kPrepThreads) c += valid[n];
  cnt[t] = c;
  __syncthreads();
  for (int off = kPrepThreads / 2; off > 0; off >>= 1) {
    if (t < off) cnt[t] += cnt[t + off];
    __syncthreads();
  }
  if (t == 0) {
    total = cnt[0] > 1 ? cnt[0] : 1;
    reinterpret_cast<int*>(scratch)[0] = total;
  }
  __syncthreads();
  const float countf = (float)total;
  float* rows = scratch + 1;
  for (int i = t; i < S; i += kPrepThreads) {
    const int j = min((int)mul(u_sub[i], countf), N - 1);
    for (int k = 0; k < 3; ++k) {
      rows[6 * i + k] = src[3 * j + k];
      rows[6 * i + 3 + k] = tgt[3 * j + k];
    }
  }
}

__global__ void __launch_bounds__(kHypThreads) hypotheses(
    const float* __restrict__ src, const float* __restrict__ tgt, int N,
    const float* __restrict__ u_tri, int H, int S, float thr2, float lo,
    float hi, const float* __restrict__ scratch, float* __restrict__ trans,
    float* __restrict__ coarse) {
  __shared__ float tile[kSubTile][6];
  const int h = blockIdx.x * kHypThreads + threadIdx.x;
  const int count = reinterpret_cast<const int*>(scratch)[0];
  const float countf = (float)count;
  float pose[16];
  bool edge = false;
  if (h < H) {
    float a[3][3], b[3][3];
    load_triplet(src, tgt, N, u_tri + 3 * h, countf, a, b);
    edge = edge_ok(a, b, lo, hi);
    triplet_pose(a, b, pose);
    for (int k = 0; k < 16; ++k) trans[16ll * h + k] = pose[k];
  }
  // the coarse count over the subset rows, a tile at a time
  const float* rows = scratch + 1;
  int c = 0;
  for (int r0 = 0; r0 < S; r0 += kSubTile) {
    const int m = min(kSubTile, S - r0);
    __syncthreads();
    for (int e = threadIdx.x; e < 6 * m; e += kHypThreads)
      tile[e / 6][e % 6] = rows[6 * r0 + e];
    __syncthreads();
    if (edge)
      for (int i = 0; i < m; ++i)
        c += residual2(pose, tile[i][0], tile[i][1], tile[i][2], tile[i][3],
                       tile[i][4], tile[i][5]) < thr2;
  }
  if (h < H) coarse[h] = edge ? (float)c : -1.f;
}

// Two-stage K16, pass 1: the edge check, one thread a hypothesis (kItems
// of them in a row), -1 written for a failure, and the survivors' indices
// compacted into surv in hypothesis order: a block scan of the threads'
// counts, then a look-back over the tiles; the last tile writes the
// survivor count into ctl.
__global__ void __launch_bounds__(kScanThreads) edge(
    const float* __restrict__ src, const float* __restrict__ tgt, int N,
    const float* __restrict__ u_tri, int H, float lo, float hi,
    const float* __restrict__ scratch, int* __restrict__ ctl,
    unsigned* __restrict__ status, int* __restrict__ surv,
    float* __restrict__ coarse) {
  __shared__ int sh[kScanThreads];
  __shared__ unsigned win[kWindow];
  __shared__ int st[2], s_tile;
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(ctl + kEdgeTicket, 1);
  __syncthreads();
  const int tile = s_tile;
  const float countf = (float)reinterpret_cast<const int*>(scratch)[0];
  const int h0 = tile * kTile + t * kItems;
  unsigned pass = 0;                        // bit j: hypothesis h0 + j
  int c = 0;
  for (int j = 0; j < kItems && h0 + j < H; ++j) {
    float a[3][3], b[3][3];
    load_triplet(src, tgt, N, u_tri + 3ll * (h0 + j), countf, a, b);
    if (edge_ok(a, b, lo, hi)) {
      pass |= 1u << j;
      ++c;
    } else {
      coarse[h0 + j] = -1.f;
    }
  }
  int total;
  const int excl = block_exclusive_scan<kScanThreads>(c, sh, total);
  const int before = look_back(status, tile, total, win, st);
  if (t == 0 && tile == (int)gridDim.x - 1)
    ctl[kSurvivors] = before + total;
  int pos = before + excl;
  for (int j = 0; j < kItems; ++j)
    if (pass >> j & 1) surv[pos++] = h0 + j;
}

// Two-stage K16, pass 2: a persistent grid over the survivor list, one
// thread a survivor: its triplet's Jacobi pose (kept in cache[j] for the
// first C survivors) and its count of the subset rows (staged in shared
// memory), written to coarse[h]; the counts' block histogram is added to
// ctl's.
__global__ void __launch_bounds__(kCountThreads) solve_count(
    const float* __restrict__ src, const float* __restrict__ tgt, int N,
    const float* __restrict__ u_tri, int S, float thr2,
    const float* __restrict__ scratch, int* __restrict__ ctl,
    const int* __restrict__ surv, float* __restrict__ cache, int C,
    float* __restrict__ coarse) {
  __shared__ float tile[kSubTile][6];
  __shared__ int bins[kMaxBins];
  const int nsurv = ctl[kSurvivors];
  const int t = threadIdx.x;
  const int first = blockIdx.x * kCountThreads;
  if (first >= nsurv) return;               // the whole block: no work
  const float countf = (float)reinterpret_cast<const int*>(scratch)[0];
  const float* rows = scratch + 1;
  const bool once = S <= kSubTile;          // the subset fits: stage it once
  for (int i = t; i <= S; i += kCountThreads) bins[i] = 0;
  if (once)
    for (int e = t; e < 6 * S; e += kCountThreads) tile[e / 6][e % 6] = rows[e];
  __syncthreads();
  for (int j0 = first; j0 < nsurv; j0 += gridDim.x * kCountThreads) {
    const int j = j0 + t;
    const bool live = j < nsurv;
    const int h = live ? surv[j] : 0;
    float pose[16];
    if (live) {
      float a[3][3], b[3][3];
      load_triplet(src, tgt, N, u_tri + 3ll * h, countf, a, b);
      triplet_pose(a, b, pose);
      if (j < C)
        for (int e = 0; e < 16; ++e) cache[16ll * j + e] = pose[e];
    }
    int c = 0;
    for (int r0 = 0; r0 < S; r0 += kSubTile) {
      const int m = min(kSubTile, S - r0);
      if (!once) {
        __syncthreads();
        for (int e = t; e < 6 * m; e += kCountThreads)
          tile[e / 6][e % 6] = rows[6 * r0 + e];
        __syncthreads();
      }
      if (live)
        for (int i = 0; i < m; ++i)
          c += residual2(pose, tile[i][0], tile[i][1], tile[i][2],
                         tile[i][3], tile[i][4], tile[i][5]) < thr2;
    }
    if (live) {
      coarse[h] = (float)c;
      atomicAdd(bins + c, 1);
    }
  }
  __syncthreads();
  for (int i = t; i <= S; i += kCountThreads)
    if (bins[i]) atomicAdd(ctl + kHist + i, bins[i]);
}

// The sort key of a kept hypothesis: count descending, then index
// ascending (lax.top_k's order), for counts -1..S. A survivor carries its
// place j in the survivor list (in hypothesis order, so the same order), a
// failing hypothesis its index h.
__device__ __forceinline__ unsigned long long top_key(int count, int jh) {
  return (unsigned long long)(0xFFFF - (count + 1)) << 32 | (unsigned)jh;
}

// Two-stage K16, pass 3: the top k of coarse. Each block finds the
// threshold count thr in the histogram (the count at which the survivors
// counted from the top reach k; -1 where fewer than k survive), then takes
// tiles of the survivor list by ticket: every survivor above thr is kept,
// and those at thr while their rank among the ties (a look-back scan, in
// list order) is below the remainder; a tile's kept keys go to `kept` at
// a range one atomic reserves.
__global__ void __launch_bounds__(kScanThreads) select_top(
    const float* __restrict__ coarse, int S, int k,
    const int* __restrict__ surv, int* __restrict__ ctl,
    unsigned* __restrict__ status, unsigned long long* __restrict__ kept) {
  __shared__ int sh[kScanThreads];
  __shared__ unsigned win[kWindow];
  __shared__ int st[2], s_tile, s_thr, s_rem, s_base;
  const int t = threadIdx.x;
  const int nsurv = ctl[kSurvivors];
  const int* hist = ctl + kHist;
  if (t == 0) {
    s_thr = -1;
    s_rem = 0;
  }
  // thread t sums the bins [top - q, top], top = S - t q, from the top
  const int q = (S + kScanThreads) / kScanThreads;
  const int top = S - t * q;
  int sum = 0;
  for (int i = 0; i < q && top - i >= 0; ++i) sum += hist[top - i];
  int total;
  int above = block_exclusive_scan<kScanThreads>(sum, sh, total);
  if (nsurv >= k)
    for (int i = 0; i < q && top - i >= 0; ++i) {
      const int n = hist[top - i];
      if (above < k && k <= above + n) {
        s_thr = top - i;
        s_rem = k - above;
      }
      above += n;
    }
  __syncthreads();
  const int thr = s_thr, rem = s_rem;
  for (;;) {
    if (t == 0) s_tile = atomicAdd(ctl + kSelectTicket, 1);
    __syncthreads();
    const int tile = s_tile;
    if (tile * kTile >= nsurv) break;
    const int j0 = tile * kTile + t * kItems;
    int cnt[kItems];
    int ties = 0;
    for (int j = 0; j < kItems; ++j) {
      cnt[j] = j0 + j < nsurv ? (int)coarse[surv[j0 + j]] : -2;
      ties += cnt[j] == thr;
    }
    const int excl = block_exclusive_scan<kScanThreads>(ties, sh, total);
    const int before = look_back(status, tile, total, win, st);
    unsigned take = 0;                      // bit j: item j is kept
    for (int j = 0, rank = before + excl; j < kItems; ++j) {
      const bool tie = cnt[j] == thr;
      if (cnt[j] > thr || (tie && rank < rem)) take |= 1u << j;
      rank += tie;
    }
    int pos = block_exclusive_scan<kScanThreads>(__popc(take), sh, total);
    if (t == 0) s_base = atomicAdd(ctl + kKept, total);
    __syncthreads();
    pos += s_base;
    for (int j = 0; j < kItems; ++j)
      if (take >> j & 1) kept[pos++] = top_key(cnt[j], j0 + j);
  }
}

// Two-stage K16, pass 4, one block: where fewer than k survive, the
// lowest-index failing hypotheses (all lie below k) join the kept keys;
// the k keys are sorted in shared memory (bitonic), and keep, the kept
// counts and each kept survivor's place in the list (-1 for a failure)
// are written.
__global__ void __launch_bounds__(kSortThreads) sort_top(
    const float* __restrict__ coarse, int k, const int* __restrict__ surv,
    const int* __restrict__ ctl, unsigned long long* __restrict__ kept,
    int* __restrict__ keep, float* __restrict__ kept_coarse,
    int* __restrict__ kept_j) {
  __shared__ int sh[kSortThreads];
  __shared__ unsigned long long keys[kMaxTop];
  const int t = threadIdx.x;
  const int nsurv = ctl[kSurvivors];
  if (nsurv < k) {                  // the first k - nsurv failures, by index
    const int qk = (k + kSortThreads - 1) / kSortThreads;
    const int h0 = t * qk;
    int f = 0;
    for (int i = 0; i < qk && h0 + i < k; ++i) f += coarse[h0 + i] < 0.f;
    int total;
    int rank = block_exclusive_scan<kSortThreads>(f, sh, total);
    for (int i = 0; i < qk && h0 + i < k; ++i)
      if (coarse[h0 + i] < 0.f && rank < k - nsurv)
        kept[nsurv + rank++] = top_key(-1, h0 + i);
    __syncthreads();
  }
  int n = 1;
  while (n < k) n <<= 1;
  for (int i = t; i < n; i += kSortThreads) keys[i] = i < k ? kept[i] : ~0ull;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n / 2; i += kSortThreads) {
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        const unsigned long long x = keys[a], y = keys[b];
        if ((x > y) == ((a & size) == 0)) {
          keys[a] = y;
          keys[b] = x;
        }
      }
      __syncthreads();
    }
  for (int i = t; i < k; i += kSortThreads) {
    const unsigned long long key = keys[i];
    const int count = 0xFFFF - (int)(key >> 32) - 1;
    const int jh = (int)(key & 0xFFFFFFFFu);
    keep[i] = count >= 0 ? surv[jh] : jh;
    kept_j[i] = count >= 0 ? jh : -1;
    kept_coarse[i] = (float)count;
  }
}

// Two-stage K16, pass 5: the pose of each kept hypothesis, one thread
// each: solve_count's from the cache where the survivor's place is below
// C, else solved again (the same solve, so the same bits).
__global__ void __launch_bounds__(kPoseThreads) kept_poses(
    const float* __restrict__ src, const float* __restrict__ tgt, int N,
    const float* __restrict__ u_tri, const float* __restrict__ scratch,
    const int* __restrict__ keep, const int* __restrict__ kept_j,
    const float* __restrict__ cache, int C, int k,
    float* __restrict__ trans) {
  const int i = blockIdx.x * kPoseThreads + threadIdx.x;
  if (i >= k) return;
  const int j = kept_j[i];
  if (j >= 0 && j < C) {
    for (int e = 0; e < 16; ++e) trans[16 * i + e] = cache[16ll * j + e];
    return;
  }
  const float countf = (float)reinterpret_cast<const int*>(scratch)[0];
  float a[3][3], b[3][3], pose[16];
  load_triplet(src, tgt, N, u_tri + 3ll * keep[i], countf, a, b);
  triplet_pose(a, b, pose);
  for (int e = 0; e < 16; ++e) trans[16 * i + e] = pose[e];
}

// K17's order of two (count, h) pairs: the larger count, then the lower h
__device__ __forceinline__ bool verify_before(int c, int h, int bc, int bh) {
  return c > bc || (c == bc && h < bh);
}

// The block's first (count, h) under verify_before, in thread 0: a xor
// tree in each warp, then the warps' in order.
__device__ __forceinline__ void verify_block_best(int& c, int& h, int* s_c,
                                                  int* s_h) {
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, c, off);
    const int oh = __shfl_xor_sync(0xffffffffu, h, off);
    if (verify_before(oc, oh, c, h)) {
      c = oc;
      h = oh;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_c[warp] = c;
    s_h[warp] = h;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kVerifyWarps; ++w)
      if (verify_before(s_c[w], s_h[w], c, h)) {
        c = s_c[w];
        h = s_h[w];
      }
}

// A thread's four rows of a tile, loaded ahead of the barriers that place
// them: rows t0 + 4t .. t0 + 4t + 3 (t0 a multiple of 4), three float4 of
// src and of tgt where `rows16` and all four lie below m.
struct VerifyRows {
  float x[12], y[12];
  bool ok[4];

  __device__ __forceinline__ void load(const float* src, const float* tgt,
                                       const bool* valid, int t0, int m,
                                       bool rows16) {
    const int e0 = 4 * (int)threadIdx.x;
    if (rows16 && e0 + 4 <= m) {
      const float4* ps =
          reinterpret_cast<const float4*>(src + 3ll * (t0 + e0));
      const float4* pt =
          reinterpret_cast<const float4*>(tgt + 3ll * (t0 + e0));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 u = ps[k], v = pt[k];
        x[4 * k] = u.x;
        x[4 * k + 1] = u.y;
        x[4 * k + 2] = u.z;
        x[4 * k + 3] = u.w;
        y[4 * k] = v.x;
        y[4 * k + 1] = v.y;
        y[4 * k + 2] = v.z;
        y[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 12; ++e) {
        const bool in = e0 + e / 3 < m;
        x[e] = in ? src[3ll * (t0 + e0) + e] : 0.f;
        y[e] = in ? tgt[3ll * (t0 + e0) + e] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = e0 + j < m && valid[t0 + e0 + j];
  }

  // the block's valid rows in row order into the shared tile, as (x, y,
  // z, u) in a and (v, w) in b; returns their count; ends at a barrier
  __device__ __forceinline__ int place(float4* a, float2* b, int* s_warp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int before = 0, mine = 0;
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned bits = __ballot_sync(0xffffffffu, ok[j]);
      before += __popc(bits & lt);
      mine += __popc(bits);
    }
    if (lane == 0) s_warp[warp] = mine;
    __syncthreads();
    int n = 0;
#pragma unroll
    for (int w = 0; w < kVerifyWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      n += s_warp[w];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ok[j]) continue;
      a[before] = make_float4(x[3 * j], x[3 * j + 1], x[3 * j + 2], y[3 * j]);
      b[before] = make_float2(y[3 * j + 1], y[3 * j + 2]);
      ++before;
    }
    __syncthreads();
    return n;
  }
};

// Each of the thread's first P poses' count of the n staged rows within
// the threshold: residual2 < thr2, a row read once for the P poses.
template <int P>
__device__ __forceinline__ void verify_count(
    const float (&T)[kVerifyPoses][12], const float4* a, const float2* b,
    int n, float thr2, int (&c)[kVerifyPoses]) {
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float4 p = a[i];
    const float2 q = b[i];
#pragma unroll
    for (int k = 0; k < P; ++k)
      c[k] += residual2(T[k], p.x, p.y, p.z, p.w, q.x, q.y) < thr2;
  }
}

// K17: block g * splits + s counts the rows [s chunk, (s + 1) chunk) under
// the live poses of group g (hypotheses g kVerifyGroup ..). sums: Hk ints
// (the splits' counts, added where splits > 1), then 2 a group (its first
// largest count and hypothesis); ticket: groups + 1 ints. Both are zero
// between calls: the launch leaves them so.
__global__ void __launch_bounds__(kVerifyThreads, kVerifyBlocksPerSm) verify(
    const float* __restrict__ trans, const float* __restrict__ coarse,
    const int* __restrict__ keep, int Hk, const float* __restrict__ src,
    const float* __restrict__ tgt, const bool* __restrict__ valid, int N,
    int splits, int chunk, bool vec16, float thr2, int* __restrict__ sums,
    int* __restrict__ ticket, float* __restrict__ counts,
    int* __restrict__ best) {
  __shared__ float4 s_a[kVerifyTile];
  __shared__ float2 s_b[kVerifyTile];
  __shared__ float s_pose[kVerifyGroup][12];  // a slot's pose, rows 0-2
  __shared__ int s_hyp[kVerifyGroup];   // the group's live hypotheses
  __shared__ int s_pos[kVerifyGroup];   // a hypothesis's slot, or -1
  __shared__ int s_cnt[kVerifyGroup];   // a slot's count (one split)
  __shared__ int s_warp[kVerifyPoses * kVerifyWarps];
  __shared__ int s_c[kVerifyWarps], s_h[kVerifyWarps];
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = blockIdx.x / splits, s = blockIdx.x % splits;
  const int groups = gridDim.x / splits;
  const int h0 = g * kVerifyGroup;
  const int r0 = s * chunk, r1 = min(N, r0 + chunk);
  int* gbest = sums + Hk;

  // every load the block starts from at once: its first tile of rows, and
  // the flag and pose of each hypothesis of the group (e = p T + t)
  VerifyRows rows;
  if (r0 < r1) rows.load(src, tgt, valid, r0, min(kVerifyTile, r1 - r0),
                         vec16);
  bool live[kVerifyPoses];
  float pose[kVerifyPoses][12];
#pragma unroll
  for (int p = 0; p < kVerifyPoses; ++p) {
    const int h = h0 + p * kVerifyThreads + t;
    live[p] = false;
    if (h < Hk) {
      const int row = keep != nullptr ? keep[h] : h;
      live[p] = coarse[row] >= 0.f;
      if (vec16) {                         // rows 0-2 as three float4
        const float4* q = reinterpret_cast<const float4*>(trans + 16ll * row);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 v = q[k];
          pose[p][4 * k] = v.x;
          pose[p][4 * k + 1] = v.y;
          pose[p][4 * k + 2] = v.z;
          pose[p][4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 12; ++e) pose[p][e] = trans[16ll * row + e];
      }
    }
  }

  // the live ones compacted in index order, their poses to their slots
  unsigned bits[kVerifyPoses];
#pragma unroll
  for (int p = 0; p < kVerifyPoses; ++p) {
    bits[p] = __ballot_sync(0xffffffffu, live[p]);
    if (lane == 0) s_warp[p * kVerifyWarps + warp] = __popc(bits[p]);
  }
  __syncthreads();
  int nlive = 0;
#pragma unroll
  for (int i = 0; i < kVerifyPoses * kVerifyWarps; ++i) nlive += s_warp[i];
#pragma unroll
  for (int p = 0; p < kVerifyPoses; ++p) {
    int base = __popc(bits[p] & ((1u << lane) - 1u));
    for (int i = 0; i < p * kVerifyWarps + warp; ++i) base += s_warp[i];
    const int e = p * kVerifyThreads + t;
    s_pos[e] = live[p] ? base : -1;
    if (live[p]) {
      s_hyp[base] = h0 + e;
#pragma unroll
      for (int k = 0; k < 12; ++k) s_pose[base][k] = pose[p][k];
    }
  }
  __syncthreads();

  // slots t, t + T, ...: their poses in registers
  int np = 0;
  float T[kVerifyPoses][12];
  int c[kVerifyPoses];
#pragma unroll
  for (int k = 0; k < kVerifyPoses; ++k) {
    c[k] = 0;
    const int slot = t + k * kVerifyThreads;
    if (slot < nlive) {
      np = k + 1;
#pragma unroll
      for (int e = 0; e < 12; ++e) T[k][e] = s_pose[slot][e];
    }
  }
  if (nlive > 0)
    for (int t0 = r0; t0 < r1; t0 += kVerifyTile) {
      if (t0 != r0)
        rows.load(src, tgt, valid, t0, min(kVerifyTile, r1 - t0), vec16);
      const int n = rows.place(s_a, s_b, s_warp);
      if (np == kVerifyPoses)
        verify_count<kVerifyPoses>(T, s_a, s_b, n, thr2, c);
      else if (np > 0)
        verify_count<1>(T, s_a, s_b, n, thr2, c);
      __syncthreads();
    }

  // the group's counts, added over the splits behind the group's ticket
  if (splits > 1) {
    for (int k = 0; k < np; ++k)
      if (c[k] != 0) atomicAdd(sums + s_hyp[t + k * kVerifyThreads], c[k]);
    __threadfence();
    __syncthreads();
    if (t == 0) {
      s_last = atomicAdd(ticket + g, 1) == splits - 1;
      if (s_last) ticket[g] = 0;           // every split has arrived
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  } else {
    for (int k = 0; k < np; ++k) s_cnt[t + k * kVerifyThreads] = c[k];
    __syncthreads();
  }
  int bc = -2, bh = 0x7fffffff;
#pragma unroll
  for (int p = 0; p < kVerifyPoses; ++p) {
    const int e = p * kVerifyThreads + t, h = h0 + e;
    if (h >= Hk) break;
    int cnt = -1;                          // the edge check failed
    if (s_pos[e] >= 0) {
      if (splits > 1) {
        cnt = __ldcg(sums + h);
        sums[h] = 0;
      } else {
        cnt = s_cnt[s_pos[e]];
      }
    }
    counts[h] = (float)cnt;
    if (cnt > bc) {                        // h rises with p: the first
      bc = cnt;
      bh = h;
    }
  }
  verify_block_best(bc, bh, s_c, s_h);

  // the first argmax over the groups, in group order, behind the last ticket
  if (groups > 1) {
    if (t == 0) {
      gbest[2 * g] = bc;
      gbest[2 * g + 1] = bh;
    }
    __threadfence();
    __syncthreads();
    if (t == 0) {
      s_last = atomicAdd(ticket + groups, 1) == groups - 1;
      if (s_last) ticket[groups] = 0;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    bc = -2;
    bh = 0x7fffffff;
    for (int j = t; j < groups; j += kVerifyThreads) {
      const int oc = __ldcg(gbest + 2 * j), oh = __ldcg(gbest + 2 * j + 1);
      if (verify_before(oc, oh, bc, bh)) {
        bc = oc;
        bh = oh;
      }
      gbest[2 * j] = 0;
      gbest[2 * j + 1] = 0;
    }
    verify_block_best(bc, bh, s_c, s_h);
  }
  if (t == 0) best[0] = keep != nullptr ? keep[bh] : bh;
}

// Adds red[k][0..T) into red[k][0] for k < n, a fixed tree over the T
// threads of the block (halves: red[k][t] += red[k][t + off], off = T / 2,
// ..., 1).
template <int T, int n>
__device__ void block_sums(float (*red)[T]) {
  const int t = threadIdx.x;
  for (int off = T / 2; off > 0; off >>= 1) {
    if (t < off)
      for (int k = 0; k < n; ++k) red[k][t] += red[k][t + off];
    __syncthreads();
  }
}

// polish's sums: a thread's rows in order, then a fixed xor-shuffle tree
// over the warp (every lane gets the same bits: a + b == b + a), the warp
// partials through `part` [n][kPolishWarps] and one barrier, then the same
// tree over the partials in every warp. One barrier a call; a call writes
// `part` while the block may still read the other buffer of the previous
// pass, so consecutive calls alternate two buffers.
template <int n>
__device__ __forceinline__ void polish_sums(float (&v)[n],
                                            float (*part)[kPolishWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k)
      v[k] = add(v[k], __shfl_xor_sync(0xFFFFFFFFu, v[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < n; ++k) part[k][warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < n; ++k) v[k] = lane < kPolishWarps ? part[k][lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k)
      v[k] = add(v[k], __shfl_xor_sync(0xFFFFFFFFu, v[k], off));
}

// The exclusive prefix of v over the block in thread order (a xor-shuffle
// scan in the warp, then the warps before it); `total` gets the sum. One
// barrier; `part` is kPolishWarps ints of shared memory.
__device__ __forceinline__ int polish_scan(int v, int* part, int& total) {
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
  for (int w = 0; w < kPolishWarps; ++w) {
    before += w < warp ? part[w] : 0;
    total += part[w];
  }
  return before + incl - v;
}

// The dynamic shared memory's head of a polish CTA, in 4-byte words: the
// pose [16], the warps' partials of the two passes [8][kPolishWarps] and
// [9][kPolishWarps] and of the counts [kPolishWarps]; in the wide route
// also the CTAs' partials as received, [kPolishCluster][8], [9] and [1]
// (each row written by its CTA through distributed shared memory). The
// rows follow it.
constexpr int kPolHeadPose = 0;
constexpr int kPolHeadPart1 = kPolHeadPose + 16;
constexpr int kPolHeadPart2 = kPolHeadPart1 + 8 * kPolishWarps;
constexpr int kPolHeadIPart = kPolHeadPart2 + 9 * kPolishWarps;
constexpr int kPolHeadIn1 = kPolHeadIPart + kPolishWarps;
constexpr int kPolHeadIn2 = kPolHeadIn1 + kPolishCluster * 8;
constexpr int kPolHeadInC = kPolHeadIn2 + kPolishCluster * 9;
constexpr int kPolHead = (kPolHeadInC + kPolishCluster + 3) & ~3;

__device__ __forceinline__ int add(int a, int b) { return a + b; }

// The wide route's sums: the CTA's v [n] (the same bits in each of its
// threads) into row `rank` of every CTA's inbox [C][n] (thread r < C sends
// to rank r), one cluster barrier, then the C rows added in rank order:
// every thread of every CTA ends with the same bits.
template <int n, class V>
__device__ __forceinline__ void cluster_sums(V (&v)[n], V* inbox) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  if (t < C)
#pragma unroll
    for (int k = 0; k < n; ++k)
      *cluster.map_shared_rank(inbox + rank * n + k, t) = v[k];
  cluster.sync();
#pragma unroll
  for (int k = 0; k < n; ++k) {
    v[k] = inbox[k];
    for (int r = 1; r < C; ++r) v[k] = add(v[k], inbox[r * n + k]);
  }
}

// K18 ransac_polish: one block (kWide false), or past kPolishMaxRows one
// thread-block cluster of C CTAs (kWide), CTA r owning the input rows [r
// q, (r + 1) q), q = ceil(N / C). A CTA copies the valid rows of its range
// once, in index order, into its shared memory (six arrays of M floats; a
// thread takes a contiguous range of rows for the copy, placed by a block
// scan), and its row m belongs to thread m % kPolishThreads in every pass
// after it, so no round reads global memory. A round: the inlier test (|R
// s + t - t'| < thr on the unfused root) with the inlier count and both
// sums, the centroids (every thread divides the same bits), the centred
// moments over the same inliers (a bit a row, kept in a register), and the
// Jacobi pose of thread 0 where at least 3 rows are inliers (else the old
// pose stays); three barriers. In the wide route each pass's sums are
// the CTAs' sums added in rank order (`cluster_sums`: one cluster barrier
// a pass, two a round), so every CTA holds the same sums, and the thread 0
// of every CTA solves the same pose (a rerun counts in jacobi_reruns from
// rank 0 only, as in the one-block route). A round whose inliers are the
// last round's would give the last pose again, bit for bit (the same rows
// in the same order), and so would every round after it: the first pass
// counts the rows whose test changed, and where none did the rounds end
// there, the pass's inlier count being the final one. Else the inlier
// count under the final pose ends the kernel.
template <bool kWide>
__global__ void __launch_bounds__(kPolishThreads) polish(
    const float* __restrict__ trans, const int* __restrict__ best,
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, float thr, int iters,
    float* __restrict__ trans_out, int* __restrict__ inliers) {
  extern __shared__ float smem[];           // the head, then [6][q]
  float* pose = smem + kPolHeadPose;
  auto* part1 = reinterpret_cast<float(*)[kPolishWarps]>(smem + kPolHeadPart1);
  auto* part2 = reinterpret_cast<float(*)[kPolishWarps]>(smem + kPolHeadPart2);
  int* ipart = reinterpret_cast<int*>(smem + kPolHeadIPart);
  float* rows = smem + kPolHead;
  int C = 1, rank = 0;
  if constexpr (kWide) {
    cg::cluster_group cluster = cg::this_cluster();
    C = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
  }
  const int q = (N + C - 1) / C;            // each CTA's input rows, at most
  const int lo = min(N, rank * q), nl = min(N, lo + q) - lo;
  const int t = threadIdx.x;
  if (t < 16) pose[t] = trans[16ll * best[0] + t];
  // the copy: thread t's contiguous range of rows, placed by a scan
  const int per = (nl + kPolishThreads - 1) / kPolishThreads;
  const int n0 = lo + min(nl, t * per), n1 = min(lo + nl, n0 + per);
  int c = 0;
  for (int n = n0; n < n1; ++n) c += valid[n];
  int M;
  int pos = polish_scan(c, ipart, M);
  for (int n = n0; n < n1; ++n) {
    if (!valid[n]) continue;
    for (int k = 0; k < 3; ++k) {
      rows[k * q + pos] = src[3 * n + k];
      rows[(3 + k) * q + pos] = tgt[3 * n + k];
    }
    ++pos;
  }
  // the wide route's barrier is the cluster's: it also guarantees that
  // every CTA has started before the first map_shared_rank store
  if constexpr (kWide)
    cg::this_cluster().sync();
  else
    __syncthreads();
  // row m of this thread: m = t + j * kPolishThreads
  const float *sx = rows, *sy = rows + q, *sz = rows + 2 * q,
              *tx = rows + 3 * q, *ty = rows + 4 * q, *tz = rows + 5 * q;
  auto inlier = [&](const float* T, int m) {
    return __fsqrt_rn(residual2(T, sx[m], sy[m], sz[m], tx[m], ty[m],
                                tz[m])) < thr;
  };
  float T[16];
  unsigned last = 0;                         // the last round's inlier bits
  int total = -1;                            // the final count, once known
  for (int it = 0; it < iters; ++it) {
    for (int k = 0; k < 16; ++k) T[k] = pose[k];
    unsigned in = 0;                         // bit j: row t + j * threads
    // the count, both sums, and the rows whose test changed
    float s1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int m = t, j = 0; m < M; m += kPolishThreads, ++j) {
      const bool hit = inlier(T, m);
      if (it > 0 && hit != (bool)(last >> j & 1)) s1[7] = add(s1[7], 1.f);
      if (!hit) continue;
      in |= 1u << j;
      s1[0] = add(s1[0], 1.f);
      s1[1] = add(s1[1], sx[m]);
      s1[2] = add(s1[2], sy[m]);
      s1[3] = add(s1[3], sz[m]);
      s1[4] = add(s1[4], tx[m]);
      s1[5] = add(s1[5], ty[m]);
      s1[6] = add(s1[6], tz[m]);
    }
    polish_sums(s1, part1);
    if constexpr (kWide) cluster_sums(s1, smem + kPolHeadIn1);
    if (it > 0 && s1[7] == 0.f) {            // the same bits in every thread
      total = (int)s1[0];
      break;
    }
    const float wtot = s1[0], wsum = add(wtot, 1e-6f);
    float cen[6];
    for (int k = 0; k < 6; ++k) cen[k] = __fdiv_rn(s1[1 + k], wsum);
    float s2[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int m = t, j = 0; m < M; m += kPolishThreads, ++j) {
      if (!(in >> j & 1)) continue;
      const float am[3] = {sub(sx[m], cen[0]), sub(sy[m], cen[1]),
                           sub(sz[m], cen[2])};
      const float bm[3] = {sub(tx[m], cen[3]), sub(ty[m], cen[4]),
                           sub(tz[m], cen[5])};
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)
          s2[3 * a + b] = add(s2[3 * a + b], mul(am[a], bm[b]));
    }
    polish_sums(s2, part2);
    if constexpr (kWide) cluster_sums(s2, smem + kPolHeadIn2);
    if (t == 0 && wtot >= 3.f) jacobi_pose(s2, cen, cen + 3, pose, rank == 0);
    __syncthreads();
    last = in;
  }
  for (int k = 0; k < 16; ++k) T[k] = pose[k];
  if (total < 0) {
    int count = 0;
    for (int m = t; m < M; m += kPolishThreads) count += inlier(T, m);
    polish_scan(count, ipart, total);
    if constexpr (kWide) {
      int v[1] = {total};
      cluster_sums(v, reinterpret_cast<int*>(smem + kPolHeadInC));
      total = v[0];
    }
  }
  if (rank == 0 && t < 16) trans_out[t] = T[t];
  if (rank == 0 && t == 0) inliers[0] = total;
}

// icp_solve's three launches. Block b of the G = kIcpBlocks blocks owns
// the rows [b c, (b + 1) c) (c = ceil(N / G)), thread t of it the rows b c
// + t, b c + t + kIcpThreads, ... in order. A correspondence is a valid
// source row whose nearest target lies within the radius (w = mask & (d2
// < r^2)), matched to that target.
__device__ __forceinline__ void icp_chunk(int N, int& n0, int& n1) {
  const int chunk = (N + (int)gridDim.x - 1) / (int)gridDim.x;
  n0 = min(N, (int)blockIdx.x * chunk);
  n1 = min(N, n0 + chunk);
}

__device__ __forceinline__ bool icp_matched(
    int n, const float* src, const bool* mask, const float* tgt,
    const int* nn, const float* d2, float r2, float* a, float* b) {
  if (!(mask[n] && d2[n] < r2)) return false;
  const int j = nn[n];
  for (int k = 0; k < 3; ++k) {
    a[k] = src[3 * n + k];
    b[k] = tgt[3 * j + k];
  }
  return true;
}

// The block's n sums (acc, a thread's rows in order, then block_sums) to
// its partial row part[blockIdx.x][off .. off + n); then true in every
// thread of the block that arrives last at `ticket`, which it resets, with
// tot[k] the sum of the G partials in block order (read at once into `red`,
// then added from there).
template <int n>
__device__ bool icp_reduce(const float (&acc)[n], float (*red)[kIcpThreads],
                           float* part, int off, int* ticket, bool* s_last,
                           float* tot) {
  const int t = threadIdx.x, G = gridDim.x;
  for (int k = 0; k < n; ++k) red[k][t] = acc[k];
  __syncthreads();
  block_sums<kIcpThreads, n>(red);
  if (t < n) part[blockIdx.x * kIcpPart + off + t] = red[t][0];
  __threadfence();
  __syncthreads();
  if (t == 0) {
    *s_last = atomicAdd(ticket, 1) == G - 1;
    if (*s_last) *ticket = 0;              // every block has arrived
  }
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
  float* cmb = &red[0][0];                 // G x n <= n x kIcpThreads
  for (int i = t; i < G * n; i += kIcpThreads)
    cmb[i] = __ldcg(part + (i / n) * kIcpPart + off + i % n);
  __syncthreads();
  if (t < n) {
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < G; ++b) s = add(s, cmb[b * n + t]);
    tot[t] = s;
  }
  __syncthreads();
  return true;
}

// Launch 1: the weight, sum a and sum b of each block; the last block
// writes the centroids (sum / (w + 1e-6)) to part[G][0..6). Each row's
// match (tgt[nn], 1) or (0, 0, 0, 0) goes to the scratch rows after the
// partials, for launch 2 to read in order.
__global__ void __launch_bounds__(kIcpThreads) icp_moments(
    const float* __restrict__ src, const bool* __restrict__ mask,
    const float* __restrict__ tgt, const int* __restrict__ nn,
    const float* __restrict__ d2, int N, float r2, float* __restrict__ part,
    int* __restrict__ ticket) {
  __shared__ float red[7][kIcpThreads];
  __shared__ float tot[7];
  __shared__ bool s_last;
  float4* rows = reinterpret_cast<float4*>(part + (gridDim.x + 1) * kIcpPart);
  int n0, n1;
  icp_chunk(N, n0, n1);
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = n0 + (int)threadIdx.x; n < n1; n += kIcpThreads) {
    float a[3], b[3];
    if (!icp_matched(n, src, mask, tgt, nn, d2, r2, a, b)) {
      rows[n] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    rows[n] = make_float4(b[0], b[1], b[2], 1.f);
    acc[0] = add(acc[0], 1.f);
    for (int k = 0; k < 3; ++k) {
      acc[1 + k] = add(acc[1 + k], a[k]);
      acc[4 + k] = add(acc[4 + k], b[k]);
    }
  }
  if (!icp_reduce(acc, red, part, 0, ticket, &s_last, tot)) return;
  const int t = threadIdx.x;
  if (t < 6)
    part[gridDim.x * kIcpPart + t] = __fdiv_rn(tot[1 + t],
                                               add(tot[0], 1e-6f));
}

// Launch 2: the centred cross-covariance of each block over launch 1's
// matches; the last block adds them to H, and its thread 0 solves the pose
// into trans_out.
__global__ void __launch_bounds__(kIcpThreads) icp_cross(
    const float* __restrict__ src, int N, float* __restrict__ part,
    int* __restrict__ ticket, float* __restrict__ trans_out) {
  __shared__ float red[9][kIcpThreads];
  __shared__ float tot[9];
  __shared__ bool s_last;
  float cen[6];
  for (int k = 0; k < 6; ++k) cen[k] = part[gridDim.x * kIcpPart + k];
  const float4* rows =
      reinterpret_cast<const float4*>(part + (gridDim.x + 1) * kIcpPart);
  int n0, n1;
  icp_chunk(N, n0, n1);
  float m[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = n0 + (int)threadIdx.x; n < n1; n += kIcpThreads) {
    const float4 b = rows[n];
    if (b.w == 0.f) continue;
    const float am[3] = {sub(src[3 * n], cen[0]), sub(src[3 * n + 1], cen[1]),
                         sub(src[3 * n + 2], cen[2])};
    const float bm[3] = {sub(b.x, cen[3]), sub(b.y, cen[4]),
                         sub(b.z, cen[5])};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        m[3 * i + j] = add(m[3 * i + j], mul(am[i], bm[j]));
  }
  if (!icp_reduce(m, red, part, 7, ticket, &s_last, tot)) return;
  if (threadIdx.x == 0) {
    float T[16];
    jacobi_pose(tot, cen, cen + 3, T);
    for (int k = 0; k < 16; ++k) trans_out[k] = T[k];
  }
}

// Launch 3: the source warped by the new pose, the rows of each block.
__global__ void __launch_bounds__(kIcpThreads) icp_warp(
    const float* __restrict__ src, int N, const float* __restrict__ trans,
    float* __restrict__ warped) {
  __shared__ float pose[16];
  if (threadIdx.x < 16) pose[threadIdx.x] = trans[threadIdx.x];
  __syncthreads();
  int n0, n1;
  icp_chunk(N, n0, n1);
  for (int n = n0 + (int)threadIdx.x; n < n1; n += kIcpThreads)
    warp_point(pose, src[3 * n], src[3 * n + 1], src[3 * n + 2],
               warped + 3 * n);
}

}  // namespace

// K16: src/tgt [N, 3] f32, valid [N] bool, u_tri [H, 3] f32, u_sub [S] f32
// (S = 0: no subset) -> trans [H, 4, 4], coarse [H] f32; scratch holds
// 1 + 6 S floats. Two launches.
extern "C" int eyoc_ransac_hypotheses(
    const float* src, const float* tgt, const bool* valid, int N,
    const float* u_tri, int H, const float* u_sub, int S, float thr2,
    float lo, float hi, float* scratch, float* trans, float* coarse,
    cudaStream_t stream) {
  if (N <= 0 || H < 0 || S < 0) return cudaErrorInvalidValue;
  prep<<<1, kPrepThreads, 0, stream>>>(src, tgt, valid, N, u_sub, S,
                                       scratch, nullptr, 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || H == 0) return err;
  hypotheses<<<(H + kHypThreads - 1) / kHypThreads, kHypThreads, 0,
               stream>>>(src, tgt, N, u_tri, H, S, thr2, lo, hi, scratch,
                         trans, coarse);
  return cudaGetLastError();
}

// Two-stage K16: src/tgt [N, 3] f32, valid [N] bool, u_tri [H, 3] f32,
// u_sub [S] f32 (0 < S < kMaxBins), k (0 < k <= min(H, kMaxTop)) -> coarse
// [H] f32, keep [k] int32 (the top k of coarse, lax.top_k's order), the
// kept counts [k] f32 and poses [k, 4, 4]. Scratch: 1 + 6 S floats; ctl
// int32 [ransac_topk_ctl(H, S)]; surv int32 [H]; kept_j int32 [k]; kept
// uint64 [k]; cache f32 [C, 16], the poses of the first C survivors. Six
// launches, grids fixed by H, S and k; nothing read back by the host.
extern "C" int eyoc_ransac_topk_ctl(int H, int S) {
  return kHist + S + 1 + 2 * ((H + kTile - 1) / kTile);
}

extern "C" int eyoc_ransac_hypotheses_topk(
    const float* src, const float* tgt, const bool* valid, int N,
    const float* u_tri, int H, const float* u_sub, int S, float thr2,
    float lo, float hi, int k, float* scratch, int* ctl, int* surv,
    int* kept_j, unsigned long long* kept, float* cache, int C,
    float* coarse, int* keep, float* kept_coarse, float* trans,
    cudaStream_t stream) {
  if (N <= 0 || H <= 0 || H >= (1 << 30) || S <= 0 || S >= kMaxBins ||
      k <= 0 || k > H || k > kMaxTop || C < 0)
    return cudaErrorInvalidValue;
  const int tiles = (H + kTile - 1) / kTile;
  const int nctl = eyoc_ransac_topk_ctl(H, S);
  unsigned* edge_status = reinterpret_cast<unsigned*>(ctl + kHist + S + 1);
  unsigned* select_status = edge_status + tiles;
  prep<<<1, kPrepThreads, 0, stream>>>(src, tgt, valid, N, u_sub, S,
                                       scratch, ctl, nctl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge<<<tiles, kScanThreads, 0, stream>>>(src, tgt, N, u_tri, H, lo, hi,
                                           scratch, ctl, edge_status, surv,
                                           coarse);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int count_blocks = (H + kCountThreads - 1) / kCountThreads;
  solve_count<<<count_blocks < kCountBlocks ? count_blocks : kCountBlocks,
                kCountThreads, 0, stream>>>(src, tgt, N, u_tri, S, thr2,
                                            scratch, ctl, surv, cache, C,
                                            coarse);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  select_top<<<tiles < kSelectBlocks ? tiles : kSelectBlocks,
               kScanThreads, 0, stream>>>(coarse, S, k, surv, ctl,
                                          select_status, kept);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sort_top<<<1, kSortThreads, 0, stream>>>(coarse, k, surv, ctl, kept, keep,
                                           kept_coarse, kept_j);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kept_poses<<<(k + kPoseThreads - 1) / kPoseThreads, kPoseThreads, 0,
               stream>>>(src, tgt, N, u_tri, scratch, keep, kept_j, cache,
                         C, k, trans);
  return cudaGetLastError();
}

// K17: trans [H, 4, 4], coarse [H], keep [Hk] int32 (null: every
// hypothesis), src/tgt [N, 3], valid [N] -> counts [Hk] f32 and best
// (the row of trans of the first largest count) int32. With G =
// eyoc_ransac_verify_groups(Hk): sums, Hk + 2 G ints, and ticket, G + 1
// ints, both zero between calls and left at zero. One launch of (pose
// groups) x (row splits): as many splits as put kVerifyBlocksPerSm blocks
// on each SM, a split at least kVerifyMinRows rows, a multiple of 4.
extern "C" int eyoc_ransac_verify_groups(int Hk) {
  return (Hk + kVerifyGroup - 1) / kVerifyGroup;
}

extern "C" int eyoc_ransac_verify(const float* trans, const float* coarse,
                                  const int* keep, int Hk, const float* src,
                                  const float* tgt, const bool* valid, int N,
                                  float thr2, int* sums, int* ticket,
                                  float* counts, int* best,
                                  cudaStream_t stream) {
  if (Hk <= 0 || N < 0) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int groups = eyoc_ransac_verify_groups(Hk);
  int splits = (sms * kVerifyBlocksPerSm + groups - 1) / groups;
  splits = max(1, min(splits, (N + kVerifyMinRows - 1) / kVerifyMinRows));
  const int chunk = ((N + splits - 1) / splits + 3) & ~3;
  if (chunk > 0) splits = (N + chunk - 1) / chunk;
  // src, tgt and trans 16-byte aligned: rows and poses by float4
  const bool vec16 = ((reinterpret_cast<unsigned long long>(src) |
                       reinterpret_cast<unsigned long long>(tgt) |
                       reinterpret_cast<unsigned long long>(trans)) & 15) == 0;
  verify<<<groups * splits, kVerifyThreads, 0, stream>>>(
      trans, coarse, keep, Hk, src, tgt, valid, N, splits, chunk, vec16,
      thr2, sums, ticket, counts, best);
  return cudaGetLastError();
}

// K18 ransac_polish: trans [H, 4, 4], best int32, src/tgt [N, 3], valid
// [N] -> trans_out [4, 4], inliers int32. One launch: one block where N <=
// kPolishMaxRows (its rows take 24 N bytes of shared memory), else one
// cluster of kPolishCluster CTAs (24 ceil(N / kPolishCluster) bytes each),
// N at most kPolishCluster kPolishMaxRows.
extern "C" int eyoc_ransac_polish(const float* trans, const int* best,
                                  const float* src, const float* tgt,
                                  const bool* valid, int N, float thr,
                                  int iters, float* trans_out, int* inliers,
                                  cudaStream_t stream) {
  const bool wide = N > kPolishMaxRows;
  if (N <= 0 || N > kPolishCluster * kPolishMaxRows)
    return cudaErrorInvalidValue;
  const int C = wide ? kPolishCluster : 1, q = (N + C - 1) / C;
  const int smem = (kPolHead + 6 * q) * (int)sizeof(float);
  void (*kernel)(const float*, const int*, const float*, const float*,
                 const bool*, int, float, int, float*, int*) =
      wide ? polish<true> : polish<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (!wide) {
    kernel<<<1, kPolishThreads, smem, stream>>>(trans, best, src, tgt, valid,
                                                N, thr, iters, trans_out,
                                                inliers);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3{(unsigned)C, 1, 1};
  cfg.blockDim = dim3{(unsigned)kPolishThreads, 1, 1};
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, trans, best, src, tgt, valid, N,
                           thr, iters, trans_out, inliers);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K18 icp_solve's scratch for N rows, in floats: the kIcpBlocks partial
// rows and the centroids, then each row's match.
extern "C" int eyoc_icp_scratch(int N) {
  return (kIcpBlocks + 1) * kIcpPart + 4 * N;
}

// K18 icp_solve: src [N, 3], mask [N], tgt [M, 3], nn [N] int32 and d2 [N]
// (K2's on the warped source) -> trans_out [4, 4] and warped [N, 3] (the
// source under it). Three launches of kIcpBlocks blocks each (moments and
// centroids; cross-covariance and the solve; the warp), chained on the
// stream; part: eyoc_icp_scratch(N) floats, written before read;
// ticket: 2 ints, zero between calls (each launch's last block resets its
// own).
extern "C" int eyoc_icp_solve(const float* src, const bool* mask,
                              const float* tgt, const int* nn,
                              const float* d2, int N, float r2, float* part,
                              int* ticket, float* trans_out, float* warped,
                              cudaStream_t stream) {
  if (N < 0) return cudaErrorInvalidValue;
  icp_moments<<<kIcpBlocks, kIcpThreads, 0, stream>>>(
      src, mask, tgt, nn, d2, N, r2, part, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  icp_cross<<<kIcpBlocks, kIcpThreads, 0, stream>>>(src, N, part, ticket + 1,
                                                    trans_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  icp_warp<<<kIcpBlocks, kIcpThreads, 0, stream>>>(src, N, trans_out,
                                                   warped);
  return cudaGetLastError();
}

// The Jacobi solves of this library that ran again on the IEEE forms
// (jacobi_pose.cuh), since it was loaded: *out (host memory).
extern "C" int eyoc_ransac_jacobi_reruns(unsigned long long* out) {
  return jacobi_reruns_read(out);
}
