// K19 est_quad_linear_robust: the valid step's IRLS pose, every round in
// one launch, one thread-block cluster a problem.
//
// Replaces eyoc_tpu/geometry/robust.py:est_quad_linear_robust (:65, with
// _normal_equations :33 and _small_angle_trans :19): 20 rounds of a
// small-angle 6-DoF solve. Round i halves par at i = 5, 10, 15 (par
// starts at 1), solves (M + 1e-6 I) x = v, where M = sum w^2 J^T J and
// v = sum w^2 J^T r over the rows J = [[0, z, -y, 1, 0, 0], [-z, 0, x, 0,
// 1, 0], [y, -x, 0, 0, 0, 1]] at the current source point and r = target
// - source, makes Tc = [rz ry rx | x[3:6]] of the twist, composes T = Tc
// T, warps the current source points by Tc (the warp compounds, as in
// JAX) and sets w = par / (|source - target| + par). Round 0 takes weight
// 1 at every valid row.
//
// Design: a cluster of C CTAs (kThreads threads each) a problem, on C
// neighbouring SMs; problems are batched over clusters, so a data-parallel
// valid step can call it with several pairs.
// - The valid rows are split evenly over the CTAs in index order: CTA r
//   owns the valid rows of ranks [r q, (r + 1) q), q = ceil(M / C). The
//   problem's rows are cut into C kWarps warp segments; each warp counts
//   its segment's valid rows, the counts meet through distributed shared
//   memory after one cluster barrier, and warp 0 of every CTA takes their
//   prefix. Each CTA then copies its rows, in index order, into six
//   arrays of its own dynamic shared memory (24 B a row: at most kMaxRows
//   a CTA); where q is larger the rows go to the problem's part of a
//   global copy, at their ranks, each CTA reading only its own. Masked
//   rows are skipped, not multiplied by a zero weight: for finite rows
//   that is what JAX computes, and non-finite padding cannot poison the
//   sums.
// - The 21 entries of M's upper triangle are 10 distinct sums (the others
//   are 0 or repeat one: M00 = Syy + Szz, M01 = -Sxy, M04 = -Sz, M33 =
//   Sa, ...), v is 6 more: 16 sums a round. A CTA's row j belongs to its
//   thread j % kThreads. A round's one pass over the rows warps each row
//   in place, takes its new weight and adds its 16 terms for the next
//   round's system, so the weights are never stored. The sums go by fixed
//   xor-shuffle trees: over each warp's lanes (transposed: each step
//   halves the sums a lane carries, 16 shuffles, lane l ends with sum l /
//   2), then, after a block barrier, warp w adds sums w, w + kWarps, ...
//   over the CTA's warps (lane l warp l's, 0 past them) and stores it into
//   every CTA's inbox through distributed shared memory (two inboxes, by
//   round parity); one cluster barrier; then warp 0 of every CTA reads the
//   C CTAs' partials from its own inbox (lane l the one of rank l mod C)
//   and adds them by the same tree: every CTA holds the same bits. That
//   warp solves the system, forms Tc with sincosf, composes T in registers
//   and hands Tc to the other warps through shared memory and a block
//   barrier (a solve on every warp would take the issue slots of 20
//   warps). One cluster barrier a round; no grid barrier, no host sync for
//   the 20 rounds.
// - The solve: the lower-right block of M + 1e-6 I is exactly (Sa + 1e-6)
//   I = d I, so the twist's rotation part solves the 3 x 3 Schur
//   complement A - B B^T / d (B = [s]x, s = (Sx, Sy, Sz)), symmetric
//   positive definite, by an LDL^T elimination with reciprocals, and the
//   translation is (v_t + s x x_r) / d: four IEEE divisions in the chain,
//   where the 6 x 6 elimination took 21.
// - Every operation is rounded apart (__fmul_rn, __fadd_rn, ...: nvcc
//   contracts no FMA), divisions and roots are IEEE (no --use_fast_math),
//   so the plain mirror (geometry/robust.py:est_quad_linear_robust_k19_plain)
//   repeats its arithmetic; a problem with no valid row gives M = 1e-6 I,
//   v = 0, x = 0 and the identity.
//
// What bounds it: 20 dependent rounds, each a pass over the rows (about 70
// flops a row), the trees, one cluster barrier and the solve: latency,
// far above its bytes (the rows once) and its operations. The cluster spreads the pass over C SMs (8 CTAs of 640
// threads: at most one row a thread at the valid step's 5000 rows) and
// keeps the exchange between neighbouring SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

#ifndef EYOC_K19_MAX_ROWS
#define EYOC_K19_MAX_ROWS 8192
#endif
#ifndef EYOC_K19_THREADS
#define EYOC_K19_THREADS 640
#endif

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = EYOC_K19_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kWarps >= 1 && kWarps <= 32,
              "whole warps, at most 32");
constexpr int kMaxCluster = 16;
constexpr int kMaxRows = EYOC_K19_MAX_ROWS;  // rows a CTA in shared memory
constexpr int kSums = 16;
constexpr int kCopyBatch = 4;                // the copy: 32-row groups a pass
constexpr float kTikhonov = 1e-6f;
constexpr int kStamps = 6;                   // device clock reads a round
// the dynamic shared memory's head, in 4-byte words: the CTAs' partials
// as received [2][kMaxCluster][kSums], the round's step (Rc, tc) [12], the
// warps' sums [kSums][kWarps], the warp segments' counts [kWarps] and the
// cluster's prefix of them [kMaxCluster kWarps + 1]
constexpr int kHeadInbox = 0;
constexpr int kHeadStep = kHeadInbox + 2 * kMaxCluster * kSums;
constexpr int kHeadWPart = kHeadStep + 16;
constexpr int kHeadCount = kHeadWPart + kSums * kWarps;
constexpr int kHeadBase = kHeadCount + kWarps;
constexpr int kHead = (kHeadBase + kMaxCluster * kWarps + 1 + 3) & ~3;

// The sums of v[k] over groups of `lanes` lanes of the warp (lanes a power
// of two) by a fixed xor-shuffle tree: every lane of a group gets the same
// bits (a + b == b + a).
template <int n>
__device__ __forceinline__ void xor_sums(float (&v)[n], int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
}

// The 16 sums of s over the warp's 32 lanes by the pairs of the xor tree,
// each step halving the sums a lane carries: at offset 16, 8, 4, 2 a lane
// keeps the half of its sums that its bit of the offset selects, adds its
// partner's of that half and sends the other; at offset 1 both add. Lane l
// ends with sum l / 2, the bits of xor_sums(s, 32) (the same pairs are
// added at every step), after 16 shuffles in place of 80.
__device__ __forceinline__ float warp_sums_scattered(const float (&s)[kSums]) {
  const int lane = threadIdx.x & 31;
  float v8[8], v4[4], v2[2];
  bool hi = lane & 16;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v8[j] = (hi ? s[8 + j] : s[j]) +
            __shfl_xor_sync(kFull, hi ? s[j] : s[8 + j], 16);
  hi = lane & 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v4[j] = (hi ? v8[4 + j] : v8[j]) +
            __shfl_xor_sync(kFull, hi ? v8[j] : v8[4 + j], 8);
  hi = lane & 4;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    v2[j] = (hi ? v4[2 + j] : v4[j]) +
            __shfl_xor_sync(kFull, hi ? v4[j] : v4[2 + j], 4);
  hi = lane & 2;
  const float v = (hi ? v2[1] : v2[0]) +
                  __shfl_xor_sync(kFull, hi ? v2[0] : v2[1], 2);
  return v + __shfl_xor_sync(kFull, v, 1);
}

// Adds the 16 terms of a row at weight w, source (x, y, z) and target q to
// s: a = w^2, a x, a y, a z, a xx, a yy, a zz, a xy, a xz, a yz, a r (r = q
// - source), then v's twist entries a (y r2 - z r1), a (z r0 - x r2), a (x
// r1 - y r0) as (a y) r2 - (a z) r1, ...
__device__ __forceinline__ void row_terms(float (&s)[kSums], float w, float x,
                                          float y, float z, float qx,
                                          float qy, float qz) {
  const float a = __fmul_rn(w, w);
  const float ax = __fmul_rn(a, x), ay = __fmul_rn(a, y),
              az = __fmul_rn(a, z);
  const float r0 = __fsub_rn(qx, x), r1 = __fsub_rn(qy, y),
              r2 = __fsub_rn(qz, z);
  const float t[kSums] = {
      a, ax, ay, az, __fmul_rn(ax, x), __fmul_rn(ay, y), __fmul_rn(az, z),
      __fmul_rn(ax, y), __fmul_rn(ax, z), __fmul_rn(ay, z), __fmul_rn(a, r0),
      __fmul_rn(a, r1), __fmul_rn(a, r2),
      __fsub_rn(__fmul_rn(ay, r2), __fmul_rn(az, r1)),
      __fsub_rn(__fmul_rn(az, r0), __fmul_rn(ax, r2)),
      __fsub_rn(__fmul_rn(ax, r1), __fmul_rn(ay, r0))};
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = __fadd_rn(s[k], t[k]);
}

// x of (M + 1e-6 I) x = v from the 16 sums. With h = 1 / (Sa + 1e-6) and
// s = (Sx, Sy, Sz): the rotation part x_r solves the Schur complement
// (A - (|s|^2 I - s s^T) h) x_r = v_r - s x (v_t h) by an LDL^T elimination
// (reciprocals of the pivots, no pivoting: the complement is symmetric
// positive definite), then x_t = (v_t + s x x_r) h.
__device__ __forceinline__ void solve6(const float (&S)[kSums],
                                       float (&x)[6]) {
  const float sa = S[0], sx = S[1], sy = S[2], sz = S[3], sxx = S[4],
              syy = S[5], szz = S[6], sxy = S[7], sxz = S[8], syz = S[9];
  const float e = kTikhonov;
  const float h = __fdiv_rn(1.f, __fadd_rn(sa, e));
  const float a00 = __fsub_rn(
      __fadd_rn(__fadd_rn(syy, szz), e),
      __fmul_rn(__fadd_rn(__fmul_rn(sy, sy), __fmul_rn(sz, sz)), h));
  const float a11 = __fsub_rn(
      __fadd_rn(__fadd_rn(sxx, szz), e),
      __fmul_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sz, sz)), h));
  const float a22 = __fsub_rn(
      __fadd_rn(__fadd_rn(sxx, syy), e),
      __fmul_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)), h));
  const float a01 = __fadd_rn(-sxy, __fmul_rn(__fmul_rn(sx, sy), h));
  const float a02 = __fadd_rn(-sxz, __fmul_rn(__fmul_rn(sx, sz), h));
  const float a12 = __fadd_rn(-syz, __fmul_rn(__fmul_rn(sy, sz), h));
  const float t0 = __fmul_rn(S[10], h), t1 = __fmul_rn(S[11], h),
              t2 = __fmul_rn(S[12], h);
  const float g0 = __fsub_rn(S[13], __fsub_rn(__fmul_rn(sy, t2),
                                              __fmul_rn(sz, t1)));
  const float g1 = __fsub_rn(S[14], __fsub_rn(__fmul_rn(sz, t0),
                                              __fmul_rn(sx, t2)));
  const float g2 = __fsub_rn(S[15], __fsub_rn(__fmul_rn(sx, t1),
                                              __fmul_rn(sy, t0)));
  const float r0 = __fdiv_rn(1.f, a00);
  const float l10 = __fmul_rn(a01, r0), l20 = __fmul_rn(a02, r0);
  const float b11 = __fsub_rn(a11, __fmul_rn(l10, a01));
  const float b12 = __fsub_rn(a12, __fmul_rn(l10, a02));
  const float b22 = __fsub_rn(a22, __fmul_rn(l20, a02));
  const float h1 = __fsub_rn(g1, __fmul_rn(l10, g0));
  const float h2 = __fsub_rn(g2, __fmul_rn(l20, g0));
  const float r1 = __fdiv_rn(1.f, b11);
  const float l21 = __fmul_rn(b12, r1);
  const float c22 = __fsub_rn(b22, __fmul_rn(l21, b12));
  x[2] = __fdiv_rn(__fsub_rn(h2, __fmul_rn(l21, h1)), c22);
  x[1] = __fmul_rn(__fsub_rn(h1, __fmul_rn(b12, x[2])), r1);
  x[0] = __fmul_rn(__fsub_rn(__fsub_rn(g0, __fmul_rn(a01, x[1])),
                             __fmul_rn(a02, x[2])), r0);
  x[3] = __fmul_rn(__fadd_rn(S[10], __fsub_rn(__fmul_rn(sy, x[2]),
                                              __fmul_rn(sz, x[1]))), h);
  x[4] = __fmul_rn(__fadd_rn(S[11], __fsub_rn(__fmul_rn(sz, x[0]),
                                              __fmul_rn(sx, x[2]))), h);
  x[5] = __fmul_rn(__fadd_rn(S[12], __fsub_rn(__fmul_rn(sx, x[1]),
                                              __fmul_rn(sy, x[0]))), h);
}

// Rc (row-major 3 x 3) = rz(x2) ry(x1) rx(x0): the rz ry product's rows
// (a0, a1, a2) = (cz cy, -sz, cz sy), (sz cy, cz, sz sy), (-sy, 0, cy),
// then each row times rx as (a0, a1 cx + a2 sx, a2 cx - a1 sx).
__device__ __forceinline__ void step_rotation(const float (&x)[6],
                                              float (&Rc)[9]) {
  float cx, sx, cy, sy, cz, sz;
  sincosf(x[0], &sx, &cx);
  sincosf(x[1], &sy, &cy);
  sincosf(x[2], &sz, &cz);
  const float a[9] = {__fmul_rn(cz, cy), -sz, __fmul_rn(cz, sy),
                      __fmul_rn(sz, cy), cz, __fmul_rn(sz, sy),
                      -sy, 0.f, cy};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Rc[3 * i] = a[3 * i];
    Rc[3 * i + 1] = __fadd_rn(__fmul_rn(a[3 * i + 1], cx),
                              __fmul_rn(a[3 * i + 2], sx));
    Rc[3 * i + 2] = __fsub_rn(__fmul_rn(a[3 * i + 2], cx),
                              __fmul_rn(a[3 * i + 1], sx));
  }
}

// Row i of R p: (R_i0 p0 + R_i1 p1) + R_i2 p2.
__device__ __forceinline__ float dot3(const float* R, int i, float p0,
                                      float p1, float p2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(R[3 * i], p0),
                             __fmul_rn(R[3 * i + 1], p1)),
                   __fmul_rn(R[3 * i + 2], p2));
}

// Problem blockIdx.x / C of the cluster: its valid rows split over the C
// CTAs, CTA r's q or fewer in six arrays at R (source x, y, z, target x,
// y, z; ld floats apart): its dynamic shared memory of L rows where q <= L,
// else columns [r q, (r + 1) q) of the problem's [6][N] part of `spill`.
// kStamp: thread 0 of the first problem's rank-0 CTA writes clock64() at
// each round's start, after the warps' sums and the block barrier, after
// the cluster barrier, after the cluster's sums, after the solve and the
// block barrier, and after the pass (stamps [iters][kStamps]; the last
// round stops after the cluster's sums), for the profile of a round.
template <bool kStamp>
__global__ void __launch_bounds__(kThreads) irls(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, int L, int iters,
    float* __restrict__ spill, float* __restrict__ trans_out,
    long long* __restrict__ stamps) {
  extern __shared__ float smem[];           // the head, then [6][L]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / C;
  float* inbox = smem + kHeadInbox;         // [2][kMaxCluster][kSums]
  float* step = smem + kHeadStep;           // Rc (9), then tc (3)
  float* wpart = smem + kHeadWPart;         // [kSums][kWarps]
  int* wcount = reinterpret_cast<int*>(smem + kHeadCount);
  int* gbase = reinterpret_cast<int*>(smem + kHeadBase);
  const float* P = src + 3ll * b * N;
  const float* Q = tgt + 3ll * b * N;
  const bool* V = valid + (long long)b * N;
  const bool stamp = kStamp && b == 0 && rank == 0 && t == 0;

  // the warp segments' counts, their prefix over the cluster
  const int G = C * kWarps;
  const int seg = ((N + G - 1) / G + 31) & ~31;
  {
    const int n0 = min(N, (rank * kWarps + warp) * seg),
              n1 = min(N, n0 + seg);
    int c = 0;
    for (int n = n0 + lane; n < n1; n += 32) c += V[n];
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
    if (lane == 0) wcount[warp] = c;
  }
  cluster.sync();
  if (warp == 0) {
    int carry = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int own =
          g < G ? *cluster.map_shared_rank(wcount + g % kWarps, g / kWarps)
                : 0;
      int x = own;                          // the inclusive scan of own
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_sync(kFull, x, lane >= off ? lane - off : lane);
        if (lane >= off) x += y;
      }
      if (g < G) gbase[g] = carry + x - own;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) gbase[G] = carry;
  }
  __syncthreads();
  const int M = gbase[G], q = (M + C - 1) / C;
  const int lo = min(M, rank * q), cnt = min(M, lo + q) - lo;
  float* R = smem + kHead;
  int ld = L;
  if (q > L) {
    R = spill + 6ll * b * N + lo;
    ld = N;
  }
  // the CTA's rows, ranks [lo, lo + cnt), each put at its rank - lo: warp
  // w copies the segments w, w + kWarps, ... that hold some of them, its
  // 32-row groups placed by ballots, kCopyBatch groups a pass with the
  // pass's loads first
  const unsigned below = (1u << lane) - 1u;
  for (int g = warp; g < G; g += kWarps) {
    int base = gbase[g];
    if (gbase[g + 1] <= lo || base >= lo + cnt) continue;
    const int n0 = min(N, g * seg), n1 = min(N, n0 + seg);
    for (int i0 = n0; i0 < n1; i0 += kCopyBatch * 32) {
      bool v[kCopyBatch];
      float r[kCopyBatch][6];
#pragma unroll
      for (int k = 0; k < kCopyBatch; ++k) {
        const int n = i0 + 32 * k + lane;
        v[k] = n < n1 && V[n];
        for (int e = 0; e < 6; ++e) r[k][e] = 0.f;
        if (v[k])
          for (int e = 0; e < 3; ++e) {
            r[k][e] = P[3 * n + e];
            r[k][3 + e] = Q[3 * n + e];
          }
      }
#pragma unroll
      for (int k = 0; k < kCopyBatch; ++k) {
        if (i0 + 32 * k >= n1) break;
        const unsigned bal = __ballot_sync(kFull, v[k]);
        const int m = base + __popc(bal & below) - lo;
        if (v[k] && m >= 0 && m < cnt)
          for (int e = 0; e < 6; ++e) R[e * ld + m] = r[k][e];
        base += __popc(bal);
      }
    }
  }
  __syncthreads();
  float *sx = R, *sy = R + ld, *sz = R + 2 * ld;
  const float *tx = R + 3 * ld, *ty = R + 4 * ld, *tz = R + 5 * ld;

  // round 0's sums: weight 1 at every valid row
  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0.f;
  for (int m = t; m < cnt; m += kThreads)
    row_terms(s, 1.f, sx[m], sy[m], sz[m], tx[m], ty[m], tz[m]);

  float T[12] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f,
                 0.f, 0.f, 0.f};         // R row-major, then t
  float par = 1.f;
  for (int i = 0; i < iters; ++i) {
    if (stamp) stamps[kStamps * i] = clock64();
    if (i > 0 && i % 5 == 0) par = __fmul_rn(par, 0.5f);
    // the cluster's sums: the warp's (lane l ends with sum l / 2), the
    // CTA's (warp w adds sums w, w + kWarps, ... over the warps) into its
    // partial, one cluster barrier, then the CTAs' partials by warp 0
    {
      const float v = warp_sums_scattered(s);
      if ((lane & 1) == 0) wpart[(lane >> 1) * kWarps + warp] = v;
    }
    __syncthreads();
    if (stamp) stamps[kStamps * i + 1] = clock64();
    // this round's inboxes: [kMaxCluster][kSums], a row a sending CTA
    float* box = inbox + (i & 1) * kMaxCluster * kSums;
    for (int k = warp; k < kSums; k += kWarps) {
      float v[1] = {lane < kWarps ? wpart[k * kWarps + lane] : 0.f};
      xor_sums(v, 32);
      // the CTA's sum k into every CTA's inbox: lane r stores rank r's
      if (lane < C)
        *cluster.map_shared_rank(box + rank * kSums + k, lane) = v[0];
    }
    cluster.sync();
    if (stamp) stamps[kStamps * i + 2] = clock64();
    // warp 0: the cluster's sums (lane l reads rank l mod C's partials
    // from the inbox), the solve, Tc to shared memory, T = Tc T; the
    // others wait for Tc
    if (warp == 0) {
      const float4* from =
          reinterpret_cast<const float4*>(box + (lane & (C - 1)) * kSums);
#pragma unroll
      for (int k = 0; k < kSums / 4; ++k) {
        const float4 f = from[k];
        s[4 * k] = f.x;
        s[4 * k + 1] = f.y;
        s[4 * k + 2] = f.z;
        s[4 * k + 3] = f.w;
      }
      xor_sums(s, C);
      if (stamp) stamps[kStamps * i + 3] = clock64();
      float x[6], Rc[9];
      solve6(s, x);
      step_rotation(x, Rc);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) step[k] = Rc[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) step[9 + k] = x[3 + k];
      }
      float Tn[12];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          Tn[3 * r + c] = dot3(Rc, r, T[c], T[3 + c], T[6 + c]);
        Tn[9 + r] = __fadd_rn(dot3(Rc, r, T[9], T[10], T[11]), x[3 + r]);
      }
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = Tn[k];
    }
    if (i == iters - 1) break;
    __syncthreads();
    if (stamp) stamps[kStamps * i + 4] = clock64();
    float Rc[9], tc[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rc[k] = step[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) tc[k] = step[9 + k];
    // warp the rows in place, their weights, the next round's sums
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;
    for (int m = t; m < cnt; m += kThreads) {
      const float px = sx[m], py = sy[m], pz = sz[m];
      const float wx = __fadd_rn(dot3(Rc, 0, px, py, pz), tc[0]);
      const float wy = __fadd_rn(dot3(Rc, 1, px, py, pz), tc[1]);
      const float wz = __fadd_rn(dot3(Rc, 2, px, py, pz), tc[2]);
      sx[m] = wx;
      sy[m] = wy;
      sz[m] = wz;
      const float dx = __fsub_rn(wx, tx[m]), dy = __fsub_rn(wy, ty[m]),
                  dz = __fsub_rn(wz, tz[m]);
      const float norm = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                    __fmul_rn(dz, dz)));
      const float w = __fdiv_rn(par, __fadd_rn(norm, par));
      row_terms(s, w, wx, wy, wz, tx[m], ty[m], tz[m]);
    }
    if (stamp) stamps[kStamps * i + 5] = clock64();
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
  if (rank == 0 && t < 16) {
    const int r = t >> 2, c = t & 3;
    const float last = c == 3 ? 1.f : 0.f;          // the row [0, 0, 0, 1]
    trans_out[(long long)b * 16 + t] =
        r == 3 ? last : (c == 3 ? T[9 + r] : T[3 * r + c]);
  }
}

// The launch: B clusters of `cluster` CTAs (a power of two, at most
// kMaxCluster; past 8, the card's non-portable sizes), each CTA with the
// head and L = min(ceil(N / cluster), kMaxRows) rows of dynamic shared
// memory. A cluster the card cannot place is refused by the launch.
template <bool kStamp>
int irls_launch(const float* src, const float* tgt, const bool* valid, int B,
                int N, int iters, int cluster, float* spill,
                float* trans_out, long long* stamps, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N < 0 || iters < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  const int per = (N + cluster - 1) / cluster;
  const int L = per < kMaxRows ? per : kMaxRows;
  if (per > L && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = (kHead + 6 * (size_t)L) * sizeof(float);
  void (*kernel)(const float*, const float*, const bool*, int, int, int,
                 float*, float*, long long*) = irls<kStamp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3{(unsigned)(B * cluster), 1, 1};
  cfg.blockDim = dim3{(unsigned)kThreads, 1, 1};
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, src, tgt, valid, N, L, iters, spill,
                           trans_out, stamps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K19: src / tgt [B, N, 3] f32, valid [B, N] bool -> trans_out [B, 4, 4]
// f32 after `iters` rounds, one cluster of `cluster` CTAs a problem.
// `spill`: [B, 6, N] f32 where ceil(N / cluster) > kMaxRows (the rows that
// shared memory cannot hold), else may be null. One launch.
extern "C" int eyoc_est_quad_linear_robust(const float* src, const float* tgt,
                                           const bool* valid, int B, int N,
                                           int iters, int cluster,
                                           float* spill, float* trans_out,
                                           cudaStream_t stream) {
  return irls_launch<false>(src, tgt, valid, B, N, iters, cluster, spill,
                            trans_out, nullptr, stream);
}

// K19 as above, with the device clock read by thread 0 of the first
// problem's rank-0 CTA at six points of each round into stamps [iters][6]
// (round start, after the warps' sums, after the cluster barrier, after the
// cluster's sums, after the solve, after the pass; the last round stops
// after the cluster's sums): the profile of a round.
extern "C" int eyoc_est_quad_linear_robust_stamped(
    const float* src, const float* tgt, const bool* valid, int B, int N,
    int iters, int cluster, float* spill, float* trans_out, long long* stamps,
    cudaStream_t stream) {
  return irls_launch<true>(src, tgt, valid, B, N, iters, cluster, spill,
                           trans_out, stamps, stream);
}
