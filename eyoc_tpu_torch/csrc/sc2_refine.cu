// K14 sc2_seed_transforms and K15 sc2_irls, and their Jacobi forms K23
// sc2_seed_transforms_jacobi and K24 sc2_irls_jacobi: SC2-PCR from each
// seed's k1 columns to the refined pose, for B problems, with nothing read
// back by the host in between.
//
// K14 replaces eyoc_tpu/registration/sc2pcr.py:161 `_seed_transforms`
// (with its k2 x k2 `_power_iteration`, :100) after K4's k1 selection.
// Three launches:
// - `compact_rows`, one block a problem: the valid rows copied once, in
//   index order, into a scratch (source and target as two float4s a
//   row), each row's place there (-1 where invalid) and the count. No
//   later code reads `valid` or an invalid row.
// - `seed_consensus`, a warp a seed, kSeedWarps seeds a block. A seed whose
//   k1 columns are the seed before's (the labeling's seeds past its valid
//   rows all take the problem's first valid rows) has that seed's
//   consensus and pose, bit for bit, and makes no chain; the others
//   (heads) do. A lane holds one of the k1 <= 32 columns: the k1 x k1
//   `cross` values |d_S - d_T| (distances sqrt((dx*dx + dy*dy) + dz*dz),
//   unfused, as K4 and the plain version; each pair once) in the warp's
//   slice of shared memory and its column's hard bits cross < d; the seed
//   row's exact count over valid pairs, a popcount of those bits; the top
//   k2 of (nbr_ok ? count : -1) by (count desc, index asc), each column's
//   rank; a row of the soft k2 x k2 matrix clip(1 - cross^2 / d^2, 0)
//   (valid pairs, zero diagonal; each pair once) in a lane's registers;
//   `iters` power iterations y_i = sum_j M[i][j] v_j, v through the warp's
//   buffer, normalized by |v| + 1e-6 (the norm by a fixed xor-shuffle
//   tree); w = |v| * fine_ok / (sum + 1e-6); the weighted centroids and
//   centred moments by xor trees. No block barrier in the chain. Then the
//   block's QCP solves, one lane of warp 0 a head.
// - K23 only, `head_poses`, a thread a head: the consensus writes each
//   head's 17 moments to a buffer instead of solving, and the Jacobi
//   solves run 32 heads a warp, the heads of a window of kPoseThreads seeds
//   compacted first (a ballot and a prefix over the warps), so that the
//   chains' blocks end before any solve and no warp issues a solve for 4
//   live lanes. jacobi_pose sees the same 17 floats: the same bits.
// - `seed_fitness`, a block a group of kFitSeeds seeds and a part of the
//   compacted rows: the count over the problem's valid rows of |R s_n + t
//   - t_n| < inlier_threshold under each head's pose, the rows staged in
//   shared memory a tile at a time and each row tested on every head pose
//   of the group (a row read once a block, not once a seed), the integer
//   counts added over the block and the parts; the other seeds take their
//   head's pose and consensus set. The problem's last block to finish (a
//   ticket word a problem, reset by that block) writes the fitness (-1
//   where the seed is not ok) and takes its first argmax, `best`.
//
// K15 replaces :219 `_post_refine`: `irls`, one thread-block cluster of C
// CTAs a problem (the wrapper's K15_CLUSTER, K24_CLUSTER), as K19 runs its
// IRLS (robust_irls.cu). The problem's valid rows are split evenly over
// the CTAs in index order (CTA r the rows of ranks [r q, (r + 1) q), q =
// ceil(M / C): the warp segments' counts meet through distributed shared
// memory after one cluster barrier) and copied once into each CTA's
// dynamic shared memory (six arrays; past kIrlsRows rows a CTA into the
// problem's part of a global scratch, at their ranks). From trans[b,
// best[b]] it runs the IRLS while-loop with its exact stop, (it < it_num)
// & (it == 0 | |cur - prev| >= 1). A round: pass 1 over the CTA's rows,
// the warp, the inlier test (dist < thr), the Cauchy weight 1 / (1 +
// (dist / thr)^2), the count and the weighted sums; the cluster's sums
// (`cluster_sums`: a thread's rows in order, the warp's xor tree, the
// CTA's warps' by a tree over lanes, each CTA's 8 sums pushed into every
// CTA's inbox through map_shared_rank before one cluster barrier, then
// added there by a fixed xor tree over the CTAs (lane l holding rank l mod
// C's), so every thread of every CTA holds the same bits); the centroids; pass 2, the centred moments over the same inliers
// (each row's weight kept in a register from pass 1, or made again past
// kIrlsPerThread rows a thread: the same bits), their 11 sums the same
// way; then thread 0 of every CTA solves the same pose from those bits
// where the count is not 0 (else the old pose stays), and a block barrier
// hands it to the CTA. Two cluster barriers a round, no broadcast.
//
// K23 and K24 are K14 and K15 with qcp_kabsch=False
// (eyoc_tpu/registration/sc2pcr.py:205, :222 over geometry/svd3.py:kabsch,
// :283): the same kernels, instantiated with the pose solve `jacobi_pose`
// (jacobi_pose.cuh, the Jacobi Kabsch that K16-K18 solve by) in place of
// `qcp_pose`, each with entry symbols of its own; K23 solves in a fourth
// launch, `head_poses` (above). K15 and K24 also take
// `refine_unroll` (:224-236): with unroll > 0 a problem runs exactly that
// many rounds with no count check, a round with no inlier keeping the pose.
//
// `qcp_pose`, shared by K14 and K15, follows eyoc_tpu/geometry/svd3.py:
// kabsch_qcp (:131-160) and qcp_leading_quaternion (:101-128) step for
// step: max|H| scaling, lam_upper, 12 Newton steps on the quartic with the
// 1e-12 derivative guard, the adjugate column of largest norm (or the
// identity quaternion), 2 shifted power steps, R, then t = cB - R cA.
//
// Every float reduction runs in a fixed order (a lane's rows in order, then
// a fixed xor-shuffle tree), so both kernels give the same bits on every
// call; integer counts are exact in any order. Divisions and square roots
// are IEEE (no --use_fast_math), as torch's on the CPU. A threshold test
// sqrt_rn(s) < thr is made as s < lim, lim the least float whose rounded
// root reaches thr (`root_limit`): the same answer for every s, since a
// rounded root is monotone, without the root.
//
// What bounds them: K14 is a chain of small dependent steps a seed (20
// power iterations, the QCP solve) plus the fitness's operations, about
// 25 flops for each (seed, valid row); K15 is 20 dependent rounds at most,
// two passes over the valid rows, two exchanges and a solve on one thread
// each: latency and instruction issue, far above their bytes and
// operations. The designs cut both: K14 takes the invalid rows out of
// every seed's walk, a block barrier out of every step of its chain and
// the chains of repeated seeds out of the labeling; K15 spreads its passes
// over a cluster's SMs and keeps its rows in their shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

#include "jacobi_pose.cuh"

#ifndef EYOC_K15_MAX_ROWS
#define EYOC_K15_MAX_ROWS 4096
#endif
#ifndef EYOC_IRLS_THREADS
#define EYOC_IRLS_THREADS 256
#endif

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 32;             // k1 and k2 at most (K4's _K4_MAX_K)
constexpr int kCompactThreads = 256;  // compact_rows: a block a chunk
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactRows = 4;       // of a problem's rows, a thread's
constexpr int kChunk = kCompactRows * kCompactThreads;
constexpr int kTagUnit = 1 << 11;     // a count word: epoch kTagUnit + count
constexpr int kMaxEpoch = 1 << 20;
static_assert(kChunk < kTagUnit, "a chunk's count fits under the tag");
constexpr int kCopyBatch = 4;         // K15's copy: 32-row groups a pass
constexpr int kSeedWarps = 4;         // seed_consensus: seeds (warps) a block
constexpr int kSeedThreads = 32 * kSeedWarps;
constexpr int kMoments = 17;          // a head's H (9), GA, GB, cA, cB
constexpr int kPoseThreads = 128;     // head_poses: seeds a block
constexpr int kPoseWarps = kPoseThreads / 32;
constexpr int kFitSeeds = 32;         // seed_fitness: seeds a block
constexpr int kFitThreads = 256;
constexpr int kFitWarps = kFitThreads / 32;
constexpr int kFitPer = kFitSeeds / kFitWarps;   // heads a warp tests
constexpr int kFitBlocksPerSM = 2;    // its row splits aim at this ...
constexpr int kMaxSplits = 8;         // ... with at most this many parts
constexpr int kFitMinRows = 512;      // ... of at least this many rows of N

// (dx*dx + dy*dy) + dz*dz, unfused: the square of dist3_rn.
__device__ __forceinline__ float sq3_rn(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float dist3_rn(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return __fsqrt_rn(sq3_rn(ax, ay, az, bx, by, bz));
}

// The sums of v[k] over the warp by a fixed xor-shuffle tree: every lane
// gets the same bits (a + b == b + a).
template <int n>
__device__ __forceinline__ void warp_sums(float (&v)[n]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
}

__device__ __forceinline__ float det3(float a, float b, float c, float d,
                                      float e, float f, float g, float h,
                                      float i) {
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// Minor (r, c) of the 4x4 row-major A: the determinant of A without row r
// and column c.
__device__ float minor4(const float* A, int r, int c) {
  float m[9];
  int k = 0;
  for (int rr = 0; rr < 4; ++rr) {
    if (rr == r) continue;
    for (int cc = 0; cc < 4; ++cc) {
      if (cc == c) continue;
      m[k++] = A[4 * rr + cc];
    }
  }
  return det3(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8]);
}

// The weighted Kabsch pose from the centred moments H = sum w (a - cA)
// (b - cB)^T (row-major 3x3), GA = sum w |a - cA|^2, GB = sum w |b - cB|^2
// and the centroids: T (row-major 4x4) with b ~ R a + t.
__device__ void qcp_pose(const float* H, float GA, float GB, const float* cA,
                         const float* cB, float* T) {
  float scale = 0.f;
  for (int k = 0; k < 9; ++k) scale = fmaxf(scale, fabsf(H[k]));
  scale = fmaxf(scale, 1e-12f);
  float S[9];
  for (int k = 0; k < 9; ++k) S[k] = H[k] / scale;
  const float Sxx = S[0], Sxy = S[1], Sxz = S[2], Syx = S[3], Syy = S[4],
              Syz = S[5], Szx = S[6], Szy = S[7], Szz = S[8];
  const float lam_upper = (GA + GB) / (2.f * scale);
  // the Horn profile matrix (svd3.py:horn_profile_matrix)
  const float N4[16] = {
      Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
      Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
      Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
      Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz};
  // the depressed quartic's coefficients (svd3.py:qcp_quartic_coeffs)
  const float Sxx2 = Sxx * Sxx, Syy2 = Syy * Syy, Szz2 = Szz * Szz;
  const float Sxy2 = Sxy * Sxy, Syz2 = Syz * Syz, Sxz2 = Sxz * Sxz;
  const float Syx2 = Syx * Syx, Szy2 = Szy * Szy, Szx2 = Szx * Szx;
  const float c2 =
      -2.f * (Sxx2 + Syy2 + Szz2 + Sxy2 + Syx2 + Sxz2 + Szx2 + Syz2 + Szy2);
  const float c1 = 8.f * (Sxx * Syz * Szy + Syy * Szx * Sxz +
                          Szz * Sxy * Syx - Sxx * Syy * Szz -
                          Syz * Szx * Sxy - Szy * Syx * Sxz);
  const float SxzpSzx = Sxz + Szx, SyzpSzy = Syz + Szy, SxypSyx = Sxy + Syx;
  const float SyzmSzy = Syz - Szy, SxzmSzx = Sxz - Szx, SxymSyx = Sxy - Syx;
  const float SxxpSyy = Sxx + Syy, SxxmSyy = Sxx - Syy;
  const float t0 = Sxy2 + Sxz2 - Syx2 - Szx2;
  const float t1 = Syy2 + Szz2 - Sxx2 + Syz2 + Szy2;
  const float t2 = 2.f * (Syz * Szy - Syy * Szz);
  const float c0 =
      t0 * t0 + (t1 + t2) * (t1 - t2) +
      (-SxzpSzx * SyzmSzy + SxymSyx * (SxxmSyy - Szz)) *
          (-SxzmSzx * SyzpSzy + SxymSyx * (SxxmSyy + Szz)) +
      (-SxzpSzx * SyzpSzy - SxypSyx * (SxxpSyy - Szz)) *
          (-SxzmSzx * SyzmSzy - SxypSyx * (SxxpSyy + Szz)) +
      (SxypSyx * SyzpSzy + SxzpSzx * (SxxmSyy + Szz)) *
          (-SxymSyx * SyzmSzy + SxzpSzx * (SxxpSyy + Szz)) +
      (SxypSyx * SyzmSzy + SxzmSzx * (SxxmSyy - Szz)) *
          (-SxymSyx * SyzpSzy + SxzmSzx * (SxxpSyy - Szz));
  // Newton on the quartic from the upper bound of the largest root
  float x = lam_upper;
  for (int it = 0; it < 12; ++it) {
    const float x2 = x * x;
    const float P = x2 * x2 + c2 * x2 + c1 * x + c0;
    const float dP = 4.f * x2 * x + 2.f * c2 * x + c1;
    x = x - P / (fabsf(dP) < 1e-12f ? 1e-12f : dP);
  }
  // the adjugate of N4 - x I; its column of largest norm
  float A[16];
  for (int k = 0; k < 16; ++k) A[k] = N4[k] - ((k % 5) == 0 ? x : 0.f);
  float adj[16];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c)
      adj[4 * r + c] = (((r + c) & 1) ? -1.f : 1.f) * minor4(A, c, r);
  int col = 0;
  float best = -1.f;
  for (int c = 0; c < 4; ++c) {
    float n = 0.f;
    for (int r = 0; r < 4; ++r) n += adj[4 * r + c] * adj[4 * r + c];
    if (n > best) {
      best = n;
      col = c;
    }
  }
  float q[4];
  for (int r = 0; r < 4; ++r) q[r] = adj[4 * r + col];
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                         q[3] * q[3]);
  if (qn > 1e-12f) {
    for (int r = 0; r < 4; ++r) q[r] = q[r] / (qn + 1e-30f);
  } else {
    q[0] = 1.f;
    q[1] = q[2] = q[3] = 0.f;
  }
  // two shifted power steps on N4 + lam_upper I
  for (int it = 0; it < 2; ++it) {
    float nq[4];
    for (int r = 0; r < 4; ++r) {
      float a = 0.f;
      for (int c = 0; c < 4; ++c)
        a += (N4[4 * r + c] + (r == c ? lam_upper : 0.f)) * q[c];
      nq[r] = a;
    }
    const float n2 = nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] +
                     nq[3] * nq[3];
    if (n2 > 1e-24f) {
      const float inv = 1.f / sqrtf(fmaxf(n2, 1e-24f));
      for (int r = 0; r < 4; ++r) q[r] = nq[r] * inv;
    }
  }
  // the rotation (svd3.py:quat_to_rotmat)
  const float n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  if (n2 > 1e-24f) {
    const float inv = 1.f / sqrtf(fmaxf(n2, 1e-24f));
    for (int r = 0; r < 4; ++r) q[r] = q[r] * inv;
  } else {
    q[0] = 1.f;
    q[1] = q[2] = q[3] = 0.f;
  }
  const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float R[9] = {1.f - 2.f * (qy * qy + qz * qz), 2.f * (qx * qy - qz * w),
                      2.f * (qx * qz + qy * w),        2.f * (qx * qy + qz * w),
                      1.f - 2.f * (qx * qx + qz * qz), 2.f * (qy * qz - qx * w),
                      2.f * (qx * qz - qy * w),        2.f * (qy * qz + qx * w),
                      1.f - 2.f * (qx * qx + qy * qy)};
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T[4 * r + c] = R[3 * r + c];
    T[4 * r + 3] = cB[r] - (R[3 * r] * cA[0] + R[3 * r + 1] * cA[1] +
                            R[3 * r + 2] * cA[2]);
  }
  T[12] = T[13] = T[14] = 0.f;
  T[15] = 1.f;
}

// R s + t with the row-major 4x4 T.
__device__ __forceinline__ void warp_point(const float* T, float x, float y,
                                           float z, float* o) {
  for (int r = 0; r < 3; ++r)
    o[r] = T[4 * r] * x + T[4 * r + 1] * y + T[4 * r + 2] * z + T[4 * r + 3];
}

// ------------------------------------------------------------------ K14

// compact_rows: block c of problem b (blockIdx.x = b C + c) takes the
// problem's rows c kChunk, ... (a thread the rows c kChunk + j kCompactThreads
// + t, j < kCompactRows, each load a warp's contiguous bytes, all in flight
// at once): the valid ones in index order as rows [2m] and [2m + 1] (the
// source and target of the m-th, w = 0), pos[n] = m or -1, count = M, and
// its share of the S fitness counters zeroed. A row's place: the valid
// rows of the chunks before (each block publishes its count, tagged with
// the call's epoch, in its word of `flags`, and reads its predecessors'),
// then those of its chunk before it (ballots, the warps' counts through
// shared memory). The chunks are placed with no chain from one to the
// next, so a problem's rows spread over the card.
__global__ void __launch_bounds__(kCompactThreads) compact_rows(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, int S, int C, int epoch,
    int* __restrict__ flags, float4* __restrict__ rows,
    int* __restrict__ pos, int* __restrict__ count, int* __restrict__ hits) {
  __shared__ int counts[kCompactRows][kCompactWarps];
  __shared__ int before_all;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / C, c = blockIdx.x - b * C;
  const float* P = src + 3ll * b * N;
  const float* Q = tgt + 3ll * b * N;
  const bool* V = valid + (long long)b * N;
  float4* R = rows + 2ll * b * N;
  int* I = pos + (long long)b * N;
  for (int k = c * kCompactThreads + t; k < S; k += C * kCompactThreads)
    hits[(long long)b * S + k] = 0;
  const int c0 = c * kChunk;
  bool v[kCompactRows];
  float r[kCompactRows][6];
#pragma unroll
  for (int j = 0; j < kCompactRows; ++j) {
    const int n = c0 + j * kCompactThreads + t;
    v[j] = n < N && V[n];
    for (int e = 0; e < 6; ++e) r[j][e] = 0.f;
    if (v[j])
      for (int e = 0; e < 3; ++e) {
        r[j][e] = P[3 * n + e];
        r[j][3 + e] = Q[3 * n + e];
      }
  }
  unsigned bal[kCompactRows];
#pragma unroll
  for (int j = 0; j < kCompactRows; ++j) {
    bal[j] = __ballot_sync(kFull, v[j]);
    if (lane == 0) counts[j][warp] = __popc(bal[j]);
  }
  __syncthreads();
  int total = 0, mine[kCompactRows];
  for (int j = 0; j < kCompactRows; ++j)
    for (int w = 0; w < kCompactWarps; ++w) {
      if (w == warp) mine[j] = total;
      total += counts[j][w];
    }
  // publish this chunk's count, then add the chunks' before it
  volatile int* F = flags + (long long)b * C;
  if (t == 0) F[c] = epoch * kTagUnit + total;
  if (warp == 0) {
    int x = 0;
    for (int k = lane; k < c; k += 32) {
      int f;
      do {
        f = F[k];
      } while (f / kTagUnit != epoch);
      x += f - epoch * kTagUnit;
    }
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) before_all = x;
  }
  __syncthreads();
  const int before = before_all;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kCompactRows; ++j) {
    const int n = c0 + j * kCompactThreads + t;
    if (n >= N) continue;
    if (!v[j]) {
      I[n] = -1;
      continue;
    }
    const int m = before + mine[j] + __popc(bal[j] & below);
    I[n] = m;
    R[2 * m] = make_float4(r[j][0], r[j][1], r[j][2], 0.f);
    R[2 * m + 1] = make_float4(r[j][3], r[j][4], r[j][5], 0.f);
  }
  if (c == C - 1 && t == 0) count[b] = before + total;
}

// seed_consensus: warp w of block g of problem b (blockIdx.x = b G + g)
// holds seed s = g kSeedWarps + w (none past S), G = ceil(S / kSeedWarps).
// A seed whose k1 columns are the seed before's, in the same order, has
// that seed's consensus and pose, bit for bit: it is no head (head[s] = 0)
// and runs no chain; seed_fitness gives it its head's outputs. kJacobi
// (K23): the head's moments to moments[17 (b S + s)], for head_poses to
// solve by `jacobi_pose`; else (K14) the pose by `qcp_pose` here.
template <bool kJacobi>
__global__ void __launch_bounds__(kSeedThreads) seed_consensus(
    const float4* __restrict__ rows, const int* __restrict__ pos,
    const int* __restrict__ knn, int N, int S, int k1, int k2, float d_thre,
    float d_thre2, int iters, float* __restrict__ trans,
    int* __restrict__ fine_out, int* __restrict__ head,
    float* __restrict__ moments) {
  __shared__ float cross_all[kSeedWarps][kMaxK][kMaxK + 1];
  __shared__ float4 pts[kSeedWarps][2][kMaxK];
  __shared__ int fine_all[kSeedWarps][kMaxK];
  __shared__ float4 vbuf[kSeedWarps][kMaxK / 4];
  __shared__ float mom[kSeedWarps][17];     // H (9), GA, GB, cA, cB
  __shared__ int lead_all[kSeedWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = (S + kSeedWarps - 1) / kSeedWarps;
  const int b = blockIdx.x / G;
  const int s0 = (blockIdx.x - b * G) * kSeedWarps, s = s0 + warp;
  const bool live = s < S;
  const long long row = (long long)b * S + s;
  const float4* R = rows + 2ll * b * N;
  float (*cross)[kMaxK + 1] = cross_all[warp];
  float4* ps = pts[warp][0];
  float4* pt = pts[warp][1];
  int* fine = fine_all[warp];
  // lane i < k1 holds column i; a head where a column differs from the
  // seed before's (seed 0 always)
  int col = 0, before = 0;
  if (live && lane < k1) {
    col = knn[row * k1 + lane];
    before = s > 0 ? knn[(row - 1) * k1 + lane] : -1;
  }
  const bool lead = live && __ballot_sync(kFull, col != before) != 0u;
  if (lane == 0) {
    lead_all[warp] = lead;
    if (live) head[row] = lead;
  }
  if (lead) {
    // column `lane`'s rows (zero where invalid) and ok bit
    int ok = 0;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), q = a;
    if (lane < k1) {
      const int m = pos[(long long)b * N + col];
      ok = m >= 0;
      if (ok) {
        a = R[2 * m];
        q = R[2 * m + 1];
      }
    }
    ps[lane] = a;
    pt[lane] = q;
    unsigned okm = ok ? 1u << lane : 0u;     // the k1 columns' ok bits
    for (int off = 16; off > 0; off >>= 1)
      okm |= __shfl_xor_sync(kFull, okm, off);
    __syncwarp();
    // cross[i][j] = |d_S(i, j) - d_T(i, j)| over the 32 columns (zeros past
    // k1), each pair once: lane l takes (l, l + k mod 32) for k = 1..16 and
    // writes both places (d(i, j) and d(j, i) are the same bits)
    cross[lane][lane] = 0.f;
    for (int k = 1; k <= 16; ++k) {
      const int j = (lane + k) & 31;
      const float4 aj = ps[j], qj = pt[j];
      const float ds = dist3_rn(aj.x, aj.y, aj.z, a.x, a.y, a.z);
      const float dt = dist3_rn(qj.x, qj.y, qj.z, q.x, q.y, q.z);
      const float c = fabsf(__fsub_rn(ds, dt));
      cross[lane][j] = c;
      cross[j][lane] = c;
    }
    __syncwarp();
    // the hard bits (cross < d) of column `lane`, then the seed row's exact
    // local SC^2: the count over valid i of hard[0][i] * hard[i][lane]; -1
    // at an invalid column
    unsigned hard = 0;
    for (int i = 0; i < k1; ++i)
      hard |= (unsigned)(cross[i][lane] < d_thre) << i;
    const unsigned row0 = __shfl_sync(kFull, hard, 0);
    int key = -1;
    if (lane < k1 && ok) key = (okm & 1u) ? __popc(okm & row0 & hard) : 0;
    // the top k2 by (key desc, index asc): each column's rank
    int r = 0;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      const int ki = __shfl_sync(kFull, key, i);
      r += i < k1 && (ki > key || (ki == key && i < lane));
    }
    if (lane < k1 && r < k2) fine[r] = lane;
    __syncwarp();
    // the soft k2 x k2 matrix clip(1 - cross^2 / d^2, 0) over valid pairs,
    // zero diagonal, each pair once (lane i < k2 takes (i, i + k mod k2) for
    // k = 1..k2/2); then in the warp's slice in place of cross, and row
    // `lane` of it in registers
    const int fi = lane < k2 ? fine[lane] : 0;
    const bool oki = lane < k2 && (okm >> fi & 1u);
    float half[kMaxK / 2];
#pragma unroll
    for (int k = 1; k <= kMaxK / 2; ++k) {
      float m = 0.f;
      const int j = lane + k < k2 ? lane + k : lane + k - k2;
      if (oki && k <= k2 / 2) {
        const int fj = fine[j];
        if (okm >> fj & 1u) {
          const float c = cross[fi][fj];
          m = fmaxf(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(c, c), d_thre2)), 0.f);
        }
      }
      half[k - 1] = m;
    }
    __syncwarp();
    float (*Msm)[kMaxK + 1] = cross;
    if (lane < k2) {
      Msm[lane][lane] = 0.f;
#pragma unroll
      for (int k = 1; k <= kMaxK / 2; ++k) {
        const int j = lane + k < k2 ? lane + k : lane + k - k2;
        if (k <= k2 / 2) {
          Msm[lane][j] = half[k - 1];
          Msm[j][lane] = half[k - 1];
        }
      }
    }
    __syncwarp();
    float Mrow[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      Mrow[j] = lane < k2 && j < k2 ? Msm[lane][j] : 0.f;
    // the power iteration: y_i = sum_j M[i][j] v_j (v through the warp's
    // buffer, every lane reading all of it; four chains of j, added in a
    // fixed order), v = y / (|y| + 1e-6), the norm by a xor-shuffle tree
    // (which also holds every lane until all have read the buffer)
    float* vb = reinterpret_cast<float*>(vbuf[warp]);
    float v = lane < k2 ? 1.f : 0.f;
    for (int it = 0; it < iters; ++it) {
      vb[lane] = v;
      __syncwarp();
      float y4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMaxK / 4; ++j) {
        if (4 * j >= k2) break;
        const float4 v4 = vbuf[warp][j];
        y4[0] += Mrow[4 * j] * v4.x;
        y4[1] += Mrow[4 * j + 1] * v4.y;
        y4[2] += Mrow[4 * j + 2] * v4.z;
        y4[3] += Mrow[4 * j + 3] * v4.w;
      }
      const float y = (y4[0] + y4[1]) + (y4[2] + y4[3]);
      float nn[1] = {y * y};
      warp_sums(nn);
      v = y / (sqrtf(nn[0]) + 1e-6f);
    }
    // the weights and the weighted Kabsch over the k2 points
    float ws[1] = {oki ? fabsf(v) : 0.f};
    const float w0 = ws[0];
    warp_sums(ws);
    const float w = w0 / (ws[0] + 1e-6f);
    const float4 fa = ps[fi], fq = pt[fi];
    float c1[7] = {w, fa.x * w, fa.y * w, fa.z * w, fq.x * w, fq.y * w,
                   fq.z * w};
    warp_sums(c1);
    const float wsum = c1[0] + 1e-6f;
    float cA[3], cB[3];
    for (int c = 0; c < 3; ++c) {
      cA[c] = c1[1 + c] / wsum;
      cB[c] = c1[4 + c] / wsum;
    }
    const float am[3] = {fa.x - cA[0], fa.y - cA[1], fa.z - cA[2]};
    const float bm[3] = {fq.x - cB[0], fq.y - cB[1], fq.z - cB[2]};
    float mo[11];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) mo[3 * r + c] = am[r] * w * bm[c];
    mo[9] = w * (am[0] * am[0] + am[1] * am[1] + am[2] * am[2]);
    mo[10] = w * (bm[0] * bm[0] + bm[1] * bm[1] + bm[2] * bm[2]);
    warp_sums(mo);
    if (lane == 0) {
      float* out = kJacobi ? moments + kMoments * row : mom[warp];
      for (int k = 0; k < 11; ++k) out[k] = mo[k];
      for (int c = 0; c < 3; ++c) {
        out[11 + c] = cA[c];
        out[14 + c] = cB[c];
      }
    }
    if (lane < k2) fine_out[row * k2 + lane] = fine[lane];
  }
  if constexpr (!kJacobi) {
    __syncthreads();
    // the block's pose solves, lane u of warp 0 for seed s0 + u (a head)
    if (t < kSeedWarps && lead_all[t]) {
      const float* m = mom[t];
      float* T = trans + 16 * ((long long)b * S + s0 + t);
      qcp_pose(m, m[9], m[10], m + 11, m + 14, T);
    }
  }
}

// head_poses (K23): block g takes the seeds u = g kPoseThreads, ... of the
// B S, compacts its heads (a ballot a warp, the warps' counts in order),
// and its thread i solves the i-th: `jacobi_pose` of the head's moments
// into trans[u].
__global__ void __launch_bounds__(kPoseThreads) head_poses(
    const int* __restrict__ head, const float* __restrict__ moments,
    long long total, float* __restrict__ trans) {
  __shared__ int list[kPoseThreads];
  __shared__ int count[kPoseWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long u0 = (long long)blockIdx.x * kPoseThreads;
  const bool h = u0 + t < total && head[u0 + t];
  const unsigned heads = __ballot_sync(kFull, h);
  if (lane == 0) count[warp] = __popc(heads);
  __syncthreads();
  int base = 0, nh = 0;
  for (int w = 0; w < kPoseWarps; ++w) {
    base += w < warp ? count[w] : 0;
    nh += count[w];
  }
  if (h) list[base + __popc(heads & ((1u << lane) - 1u))] = t;
  __syncthreads();
  if (t >= nh) return;
  const long long u = u0 + list[t];
  float m[kMoments];
  for (int k = 0; k < kMoments; ++k) m[k] = moments[kMoments * u + k];
  jacobi_pose(m, m + 11, m + 14, trans + 16 * u);
}

// seed_fitness: block (g, r) of problem b (blockIdx.x = (b G + g) splits +
// r, G = ceil(S / kFitSeeds)) takes the seeds s0 = g kFitSeeds, ... and the
// r-th of `splits` parts of the compacted rows. A seed's head is the last
// head at or before it. Part 0 gives each other seed its head's pose and
// consensus set; every part tests the poses of the group's heads on each
// of its rows (a row read once a block, a thread's rows t, t +
// kFitThreads, ...), the counts added into hits[head] (integers: in any
// order). The problem's last block to finish (a ticket word a problem,
// reset by that block) writes the fitness, hits of the seed's head or -1
// where the seed is not ok, and best[b], the first largest.
__global__ void __launch_bounds__(kFitThreads) seed_fitness(
    const float4* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ head, const bool* __restrict__ seed_ok, int N,
    int S, int k2, int splits, float inlier_lim, float* __restrict__ trans,
    int* __restrict__ fine_out, int* __restrict__ hits,
    int* __restrict__ head_of, float* __restrict__ fitness,
    int* __restrict__ best, int* __restrict__ ticket) {
  __shared__ float4 poses[kFitSeeds][3];   // the heads' pose rows
  __shared__ float4 tile_a[kFitThreads], tile_q[kFitThreads];
  __shared__ int hs[kFitSeeds], of[kFitSeeds], cnt[kFitSeeds];
  __shared__ int part[kFitWarps];
  __shared__ float bf[kFitWarps];
  __shared__ int nh_all, last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = (S + kFitSeeds - 1) / kFitSeeds;
  const int split = blockIdx.x % splits, group = blockIdx.x / splits;
  const int b = group / G, s0 = (group - b * G) * kFitSeeds;
  const long long base = (long long)b * S;
  // the last head before s0 (seed 0 is one)
  int prior = 0;
  for (int k = t; k < s0; k += kFitThreads)
    if (head[base + k]) prior = k;
  for (int off = 16; off > 0; off >>= 1)
    prior = max(prior, __shfl_xor_sync(kFull, prior, off));
  if (lane == 0) part[warp] = prior;
  __syncthreads();
  if (warp == 0) {
    for (int w = 0; w < kFitWarps; ++w) prior = max(prior, part[w]);
    const int s = s0 + lane;
    const bool h = s < S && head[base + s];
    const unsigned heads = __ballot_sync(kFull, h);
    const unsigned upto = heads & (lane == 31 ? kFull : (2u << lane) - 1u);
    of[lane] = upto ? s0 + 31 - __clz(upto) : prior;
    if (h) hs[__popc(heads & ((1u << lane) - 1u))] = s;
    if (lane == 0) nh_all = __popc(heads);
  }
  __syncthreads();
  const int nh = nh_all;
  for (int k = t; k < 12 * kFitSeeds; k += kFitThreads)
    reinterpret_cast<float*>(poses[k / 12])[k % 12] =
        k / 12 < nh ? trans[16 * (base + hs[k / 12]) + k % 12] : 0.f;
  if (split == 0) {
    for (int k = t; k < 16 * kFitSeeds; k += kFitThreads) {
      const int u = k / 16, s = s0 + u;
      if (s < S && of[u] != s)
        trans[16 * (base + s) + k % 16] = trans[16 * (base + of[u]) + k % 16];
    }
    for (int k = t; k < k2 * kFitSeeds; k += kFitThreads) {
      const int u = k / k2, s = s0 + u;
      if (s < S && of[u] != s)
        fine_out[k2 * (base + s) + k % k2] =
            fine_out[k2 * (base + of[u]) + k % k2];
    }
    if (t < kFitSeeds && s0 + t < S) head_of[base + s0 + t] = of[t];
  }
  __syncthreads();
  // the part's rows go through shared memory a tile of kFitThreads at a
  // time (a row a thread, the next tile's loads in flight while the tile
  // is tested); warp w tests the heads kFitPer w, ... (their poses in
  // registers) on every row of a tile, a lane's rows in turn
  const float4* R = rows + 2ll * b * N;
  const int M = count[b], per = (M + splits - 1) / splits;
  const int lo = min(M, split * per), hi = min(M, lo + per);
  float T[kFitPer][12];
  for (int u = 0; u < kFitPer; ++u)
    for (int k = 0; k < 12; ++k)
      T[u][k] = reinterpret_cast<const float*>(poses[kFitPer * warp + u])[k];
  const bool tests = kFitPer * warp < nh;
  int c[kFitPer] = {};
  float4 na = make_float4(0.f, 0.f, 0.f, 0.f), nq = na;
  if (nh > 0 && lo + t < hi) {
    na = R[2 * (lo + t)];
    nq = R[2 * (lo + t) + 1];
  }
  for (int m0 = lo; m0 < hi && nh > 0; m0 += kFitThreads) {
    __syncthreads();                 // the tile before is tested
    tile_a[t] = na;
    tile_q[t] = nq;
    __syncthreads();
    const int m1 = m0 + kFitThreads;
    if (m1 + t < hi) {
      na = R[2 * (m1 + t)];
      nq = R[2 * (m1 + t) + 1];
    }
    const int n = min(kFitThreads, hi - m0);
    if (tests)
      for (int m = lane; m < n; m += 32) {
        const float4 a = tile_a[m], q = tile_q[m];
        for (int u = 0; u < kFitPer; ++u) {
          float o[3];
          warp_point(T[u], a.x, a.y, a.z, o);
          c[u] += sq3_rn(o[0], o[1], o[2], q.x, q.y, q.z) < inlier_lim;
        }
      }
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int u = 0; u < kFitPer; ++u) c[u] += __shfl_xor_sync(kFull, c[u], off);
  if (lane == 0)
    for (int u = 0; u < kFitPer; ++u) cnt[kFitPer * warp + u] = c[u];
  __syncthreads();
  if (t < nh && cnt[t] > 0) atomicAdd(hits + base + hs[t], cnt[t]);
  // the problem's last block: the fitness and best[b]
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket + b, 1) == G * splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float f = -3.4e38f;
  int i = S;
  for (int k = t; k < S; k += kFitThreads) {
    const int h = __ldcg(head_of + base + k);
    const float x = seed_ok[base + k] ? (float)__ldcg(hits + base + h) : -1.f;
    fitness[base + k] = x;
    if (x > f) {
      f = x;
      i = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float g = __shfl_xor_sync(kFull, f, off);
    const int j = __shfl_xor_sync(kFull, i, off);
    if (g > f || (g == f && j < i)) {
      f = g;
      i = j;
    }
  }
  if (lane == 0) {
    bf[warp] = f;
    part[warp] = i;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kFitWarps; ++w)
      if (bf[w] > f || (bf[w] == f && part[w] < i)) {
        f = bf[w];
        i = part[w];
      }
    best[b] = i < S ? i : 0;
    ticket[b] = 0;
  }
}

// ----------------------------------------------------------- K15, K24

// K15's and K24's `irls` (the header's K15 paragraph): a cluster of C CTAs
// of kIrlsThreads threads a problem. The head of its dynamic shared
// memory, in 4-byte words: the CTAs' pass-1 and pass-2 sums as received
// [kMaxCluster][8], [kMaxCluster][11],
// the warps' sums [11][kIrlsWarps], the warp segments' counts [kIrlsWarps],
// the cluster's prefix of them [kMaxCluster kIrlsWarps + 1], the pose [16].
constexpr int kIrlsThreads = EYOC_IRLS_THREADS;
constexpr int kIrlsWarps = kIrlsThreads / 32;
static_assert(kIrlsThreads % 32 == 0 && kIrlsWarps >= 1 && kIrlsWarps <= 32,
              "whole warps, at most 32");
constexpr int kIrlsRows = EYOC_K15_MAX_ROWS;   // rows a CTA in shared memory
constexpr int kIrlsPerThread = (kIrlsRows + kIrlsThreads - 1) / kIrlsThreads;
constexpr int kMaxCluster = 16;
constexpr int kIrlsStamps = 8;                 // device clock reads a round
constexpr int kHeadIn1 = 0;
constexpr int kHeadIn2 = kHeadIn1 + kMaxCluster * 8;
constexpr int kHeadWPart = kHeadIn2 + kMaxCluster * 11;
constexpr int kHeadCount = kHeadWPart + 11 * kIrlsWarps;
constexpr int kHeadBase = kHeadCount + kIrlsWarps;
constexpr int kHeadPose = kHeadBase + kMaxCluster * kIrlsWarps + 1;
constexpr int kIrlsHead = (kHeadPose + 16 + 3) & ~3;

// The cluster's sums of v[n]: a thread's rows in order, the warp's xor
// tree, the CTA's warps' sums by a tree over lanes (warp k adds sums k, k +
// kIrlsWarps, ...), each CTA's sum k stored into every CTA's inbox [rank][n]
// through distributed shared memory, one cluster barrier, then the C CTAs'
// sums by an xor tree over C lanes in every warp: every thread of every
// CTA holds the same bits.
template <int n>
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster,
                                             float (&v)[n], float* wpart,
                                             float* inbox, int C, int rank,
                                             long long* stamp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sums(v);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < n; ++k) wpart[k * kIrlsWarps + warp] = v[k];
  __syncthreads();
  for (int k = warp; k < n; k += kIrlsWarps) {
    float x[1] = {lane < kIrlsWarps ? wpart[k * kIrlsWarps + lane] : 0.f};
    warp_sums(x);
    if (lane < C) *cluster.map_shared_rank(inbox + rank * n + k, lane) = x[0];
  }
  if (stamp != nullptr) *stamp = clock64();
  cluster.sync();
  // lane l reads rank l mod C's sums; the xor tree over each group of C
  // lanes (C a power of two) adds them, the same pairs in every lane
#pragma unroll
  for (int k = 0; k < n; ++k) v[k] = inbox[(lane & (C - 1)) * n + k];
  for (int off = C >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
}

// Problem blockIdx.x / C of the cluster, its valid rows split evenly over
// the C CTAs in index order: CTA r's are the valid rows of ranks [r q, (r +
// 1) q), q = ceil(M / C), in six arrays at R (source x, y, z, target x, y,
// z; ld floats apart): its dynamic shared memory of L rows where q <= L,
// else columns [r q, (r + 1) q) of the problem's [6][N] part of `spill`.
// The IRLS rounds (the header's K15 paragraph; kJacobi: the pose by
// `jacobi_pose`, K24, else by `qcp_pose`, K15), the two passes over the
// CTA's rows (row j its thread j % kIrlsThreads's). kStamp: thread 0 of
// the first problem's rank-0 CTA writes clock64() at each round's start,
// after pass 1, after its CTA sums, after its cluster barrier and sums,
// after pass 2, after its CTA sums, after its cluster barrier and sums,
// and after the solve and the block barrier (stamps [rounds][kIrlsStamps],
// at most `unroll` or it_num rounds).
template <bool kJacobi, bool kStamp>
__global__ void __launch_bounds__(kIrlsThreads) irls(
    const float* __restrict__ trans_all, const int* __restrict__ best,
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, int S, int L, float thr,
    float lim, int it_num, int unroll, float* __restrict__ spill,
    float* __restrict__ trans_out, int* __restrict__ iters_out,
    long long* __restrict__ stamps) {
  extern __shared__ float smem[];           // the head, then [6][L]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / C;
  float* in1 = smem + kHeadIn1;
  float* in2 = smem + kHeadIn2;
  float* wpart = smem + kHeadWPart;
  int* wcount = reinterpret_cast<int*>(smem + kHeadCount);
  int* gbase = reinterpret_cast<int*>(smem + kHeadBase);
  float* pose = smem + kHeadPose;
  const float* P = src + 3ll * b * N;
  const float* Q = tgt + 3ll * b * N;
  const bool* V = valid + (long long)b * N;
  const bool stamp = kStamp && b == 0 && rank == 0 && t == 0;
  if (t < 16) pose[t] = trans_all[((long long)b * S + best[b]) * 16 + t];

  // the warp segments' counts, their prefix over the cluster
  const int G = C * kIrlsWarps;
  const int seg = ((N + G - 1) / G + 31) & ~31;
  {
    const int n0 = min(N, (rank * kIrlsWarps + warp) * seg),
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
      const int own = g < G ? *cluster.map_shared_rank(wcount + g % kIrlsWarps,
                                                       g / kIrlsWarps)
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
  float* R = smem + kIrlsHead;
  int ld = L;
  if (q > L) {
    R = spill + 6ll * b * N + lo;
    ld = N;
  }
  // the CTA's rows, ranks [lo, lo + cnt), each at its rank - lo: warp w
  // copies the segments w, w + kIrlsWarps, ... that hold some of them, its
  // 32-row groups placed by ballots, kCopyBatch groups a pass with the
  // pass's loads first
  const unsigned below = (1u << lane) - 1u;
  for (int g = warp; g < G; g += kIrlsWarps) {
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
  const float *sx = R, *sy = R + ld, *sz = R + 2 * ld, *tx = R + 3 * ld,
              *ty = R + 4 * ld, *tz = R + 5 * ld;
  auto dist2 = [&](const float* T, int m) {
    float o[3];
    warp_point(T, sx[m], sy[m], sz[m], o);
    return sq3_rn(o[0], o[1], o[2], tx[m], ty[m], tz[m]);
  };
  auto cauchy = [&](float sq) {
    const float r = __fdiv_rn(__fsqrt_rn(sq), thr);
    return __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(r, r)));
  };
  float T[16];
  // the thread's rows t + j kIrlsThreads (j < kIrlsPerThread): their squared
  // distances, then their weights (< 0 where out), from pass 1 for pass 2;
  // past them (rows in the global copy only) pass 2 makes the same test
  // again
  float w_of[kIrlsPerThread];
  const int rows = (cnt + kIrlsThreads - 1) / kIrlsThreads;  // the same in all
  int prev = 0, cur = 0, it = 0;
  while (unroll > 0 ? it < unroll
                    : it < it_num && (it == 0 || abs(cur - prev) >= 1)) {
    long long* st = stamp ? stamps + (long long)kIrlsStamps * it : nullptr;
    if (stamp) st[0] = clock64();
    for (int k = 0; k < 16; ++k) T[k] = pose[k];
    // pass 1: sum w, sum w a, sum w b and the inlier count
    float s1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    auto add1 = [&](int m, float w) {
      s1[0] += w;
      s1[1] += sx[m] * w;
      s1[2] += sy[m] * w;
      s1[3] += sz[m] * w;
      s1[4] += tx[m] * w;
      s1[5] += ty[m] * w;
      s1[6] += tz[m] * w;
      s1[7] += 1.f;
    };
#pragma unroll
    for (int j = 0; j < kIrlsPerThread; ++j) {
      if (j >= rows) break;
      const int m = t + j * kIrlsThreads;
      w_of[j] = m < cnt ? dist2(T, m) : lim;
    }
#pragma unroll
    for (int j = 0; j < kIrlsPerThread; ++j) {
      if (j >= rows) break;
      if (w_of[j] < lim) {
        w_of[j] = cauchy(w_of[j]);
        add1(t + j * kIrlsThreads, w_of[j]);
      } else {
        w_of[j] = -1.f;
      }
    }
    for (int m = t + kIrlsPerThread * kIrlsThreads; m < cnt;
         m += kIrlsThreads) {
      const float sq = dist2(T, m);
      if (sq < lim) add1(m, cauchy(sq));
    }
    if (stamp) st[1] = clock64();
    cluster_sums(cluster, s1, wpart, in1, C, rank, stamp ? st + 2 : nullptr);
    if (stamp) st[3] = clock64();
    const float wsum = s1[0] + 1e-6f;
    float cen[6];
    for (int k = 0; k < 6; ++k) cen[k] = s1[1 + k] / wsum;
    const int count = (int)s1[7];
    // pass 2: the centred moments over the same inliers
    float s2[11] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    auto add2 = [&](int m, float w) {
      const float am[3] = {sx[m] - cen[0], sy[m] - cen[1], sz[m] - cen[2]};
      const float bm[3] = {tx[m] - cen[3], ty[m] - cen[4], tz[m] - cen[5]};
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) s2[3 * i + j] += am[i] * w * bm[j];
      s2[9] += w * (am[0] * am[0] + am[1] * am[1] + am[2] * am[2]);
      s2[10] += w * (bm[0] * bm[0] + bm[1] * bm[1] + bm[2] * bm[2]);
    };
#pragma unroll
    for (int j = 0; j < kIrlsPerThread; ++j) {
      if (j >= rows) break;
      if (w_of[j] >= 0.f) add2(t + j * kIrlsThreads, w_of[j]);
    }
    for (int m = t + kIrlsPerThread * kIrlsThreads; m < cnt;
         m += kIrlsThreads) {
      const float sq = dist2(T, m);
      if (sq < lim) add2(m, cauchy(sq));
    }
    if (stamp) st[4] = clock64();
    cluster_sums(cluster, s2, wpart, in2, C, rank, stamp ? st + 5 : nullptr);
    if (stamp) st[6] = clock64();
    if (t == 0 && count > 0) {
      if constexpr (kJacobi)
        jacobi_pose(s2, cen, cen + 3, pose);
      else
        qcp_pose(s2, s2[9], s2[10], cen, cen + 3, pose);
    }
    __syncthreads();
    if (stamp) st[7] = clock64();
    prev = cur;
    cur = count;
    ++it;
  }
  if (rank == 0 && t < 16) trans_out[(long long)b * 16 + t] = pose[t];
  if (rank == 0 && t == 0) iters_out[b] = it;
}

// The least float s with sqrt_rn(s) >= thr: sqrt_rn(s) < thr exactly where
// s < root_limit(thr) (a rounded root is monotone); 0 where thr is not
// positive (no s passes), inf at thr = inf.
float root_limit(float thr) {
  if (!(thr > 0.f)) return 0.f;
  float s = thr * thr;
  while (sqrtf(s) >= thr) s = nextafterf(s, 0.f);
  while (sqrtf(s) < thr) s = nextafterf(s, INFINITY);
  return s;
}

// The parts a fitness block's rows are split into: enough blocks for
// about kFitBlocksPerSM a multiprocessor (the eval shape has few seed
// groups), at most kMaxSplits, and parts of kFitMinRows rows of N or more.
cudaError_t fitness_splits(long long groups, int N, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long r = (kFitBlocksPerSM * (long long)sms + groups - 1) / groups;
  r = min(r, (long long)kMaxSplits);
  r = min(r, (long long)(N + kFitMinRows - 1) / kFitMinRows);
  *splits = r > 1 ? (int)r : 1;
  return cudaSuccess;
}

// K14 and K23 (kJacobi): src/tgt [B, N, 3] f32, valid [B, N] bool, knn
// [B, S, k1] int32, seed_ok [B, S] bool -> trans [B, S, 4, 4], fitness [B,
// S], best [B] int32 and fine_out [B, S, k2] int32 (the consensus sets, as
// positions among the k1 columns). `scratch`: 9 B N + B + 3 B S words,
// 16-byte aligned (the compacted rows [B, N] x 2 float4, the places [B,
// N], the counts [B], the fitness counters, the head flags and each seed's
// head [B, S]); `ticket`: B zeroed words, left zeroed; `flags`: nflags
// words, at least B ceil(N / kChunk), that hold no value of `epoch` (0 <
// epoch < kMaxEpoch; the wrapper passes a new one each call); `moments`
// (K23): [B, S, 17] f32, the heads' moments. Three launches, K23 four.
template <bool kJacobi>
int seed_transforms(const float* src, const float* tgt, const bool* valid,
                    const int* knn, const bool* seed_ok, int B, int N, int S,
                    int k1, int k2, float d_thre, float d_thre2,
                    float inlier_thr, int iters, int* scratch, int* ticket,
                    int* flags, long long nflags, int epoch, float* trans,
                    float* fitness, int* best, int* fine_out, float* moments,
                    cudaStream_t stream) {
  if (k1 < 1 || k1 > kMaxK || k2 < 1 || k2 > k1) return cudaErrorInvalidValue;
  if (kJacobi && moments == nullptr) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (N < S) return cudaErrorInvalidValue;
  float4* rows = reinterpret_cast<float4*>(scratch);
  int* pos = scratch + 8ll * B * N;
  int* count = pos + (long long)B * N;
  int* hits = count + B;
  int* head = hits + (long long)B * S;
  int* head_of = head + (long long)B * S;
  const int G = (S + kSeedWarps - 1) / kSeedWarps;
  const int G3 = (S + kFitSeeds - 1) / kFitSeeds;
  int splits = 1;
  cudaError_t err = fitness_splits((long long)B * G3, N, &splits);
  if (err != cudaSuccess) return err;
  const int C = (N + kChunk - 1) / kChunk;
  if ((long long)B * C > nflags || epoch <= 0 || epoch >= kMaxEpoch)
    return cudaErrorInvalidValue;
  compact_rows<<<B * C, kCompactThreads, 0, stream>>>(
      src, tgt, valid, N, S, C, epoch, flags, rows, pos, count, hits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a template instance is launched through a plain name
  void (*consensus)(const float4*, const int*, const int*, int, int, int,
                    int, float, float, int, float*, int*, int*, float*) =
      seed_consensus<kJacobi>;
  consensus<<<B * G, kSeedThreads, 0, stream>>>(
      rows, pos, knn, N, S, k1, k2, d_thre, d_thre2, iters, trans, fine_out,
      head, moments);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (kJacobi) {
    const long long total = (long long)B * S;
    head_poses<<<(total + kPoseThreads - 1) / kPoseThreads, kPoseThreads, 0,
                 stream>>>(head, moments, total, trans);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  seed_fitness<<<B * G3 * splits, kFitThreads, 0, stream>>>(
      rows, count, head, seed_ok, N, S, k2, splits, root_limit(inlier_thr),
      trans, fine_out, hits, head_of, fitness, best, ticket);
  return cudaGetLastError();
}

// K15 and K24 (kJacobi): trans_all [B, S, 4, 4], best [B] int32, src/tgt
// [B, N, 3], valid [B, N] -> trans [B, 4, 4], iterations [B] int32; unroll
// > 0 runs exactly that many rounds (it_num and the count check unread).
// B clusters of `cluster` CTAs (a power of two, at most kMaxCluster; past
// 8, the card's non-portable sizes), each CTA with the head and L =
// min(ceil(N / cluster), kIrlsRows) rows of dynamic shared memory;
// `spill`: [B, 6, N] f32 where ceil(N / cluster) > kIrlsRows (the rows
// that the cluster's shared memory cannot hold), else may be null.
// kStamp: stamps [rounds][kIrlsStamps] (irls). A cluster the card cannot
// place is refused by the launch. One launch.
template <bool kJacobi, bool kStamp>
int irls_launch(const float* trans_all, const int* best, const float* src,
                const float* tgt, const bool* valid, int B, int N, int S,
                float thr, int it_num, int unroll, int cluster, float* spill,
                float* trans_out, int* iters_out, long long* stamps,
                cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N < 0 || unroll < 0 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || (kStamp && stamps == nullptr))
    return cudaErrorInvalidValue;
  const int per = (N + cluster - 1) / cluster;
  const int L = per < kIrlsRows ? per : kIrlsRows;
  if (per > L && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = (kIrlsHead + 6 * (size_t)L) * sizeof(float);
  void (*kernel)(const float*, const int*, const float*, const float*,
                 const bool*, int, int, int, float, float, int, int, float*,
                 float*, int*, long long*) = irls<kJacobi, kStamp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3{(unsigned)(B * cluster), 1, 1};
  cfg.blockDim = dim3{(unsigned)kIrlsThreads, 1, 1};
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, trans_all, best, src, tgt, valid, N,
                           S, L, thr, root_limit(thr), it_num, unroll, spill,
                           trans_out, iters_out, stamps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K14 (the QCP solve) and K23 (the Jacobi solve, with the heads' moments
// [B, S, 17] f32 as `moments`): `seed_transforms`.
extern "C" int eyoc_sc2_seed_transforms(
    const float* src, const float* tgt, const bool* valid, const int* knn,
    const bool* seed_ok, int B, int N, int S, int k1, int k2, float d_thre,
    float d_thre2, float inlier_thr, int iters, int* scratch, int* ticket,
    int* flags, long long nflags, int epoch, float* trans, float* fitness,
    int* best, int* fine_out, cudaStream_t stream) {
  return seed_transforms<false>(src, tgt, valid, knn, seed_ok, B, N, S, k1,
                                k2, d_thre, d_thre2, inlier_thr, iters,
                                scratch, ticket, flags, nflags, epoch, trans,
                                fitness, best, fine_out, nullptr, stream);
}

extern "C" int eyoc_sc2_seed_transforms_jacobi(
    const float* src, const float* tgt, const bool* valid, const int* knn,
    const bool* seed_ok, int B, int N, int S, int k1, int k2, float d_thre,
    float d_thre2, float inlier_thr, int iters, int* scratch, int* ticket,
    int* flags, long long nflags, int epoch, float* trans, float* fitness,
    int* best, int* fine_out, float* moments, cudaStream_t stream) {
  return seed_transforms<true>(src, tgt, valid, knn, seed_ok, B, N, S, k1,
                               k2, d_thre, d_thre2, inlier_thr, iters,
                               scratch, ticket, flags, nflags, epoch, trans,
                               fitness, best, fine_out, moments, stream);
}

// K15 (the QCP solve) and K24 (the Jacobi solve): `irls_launch`, a
// cluster of `cluster` CTAs a problem.
extern "C" int eyoc_sc2_irls(const float* trans_all, const int* best,
                             const float* src, const float* tgt,
                             const bool* valid, int B, int N, int S,
                             float thr, int it_num, int unroll, int cluster,
                             float* spill, float* trans_out, int* iters_out,
                             cudaStream_t stream) {
  return irls_launch<false, false>(trans_all, best, src, tgt, valid, B, N, S,
                                   thr, it_num, unroll, cluster, spill,
                                   trans_out, iters_out, nullptr, stream);
}

extern "C" int eyoc_sc2_irls_jacobi(const float* trans_all, const int* best,
                                    const float* src, const float* tgt,
                                    const bool* valid, int B, int N, int S,
                                    float thr, int it_num, int unroll,
                                    int cluster, float* spill,
                                    float* trans_out, int* iters_out,
                                    cudaStream_t stream) {
  return irls_launch<true, false>(trans_all, best, src, tgt, valid, B, N, S,
                                  thr, it_num, unroll, cluster, spill,
                                  trans_out, iters_out, nullptr, stream);
}

// K24 as above with the device clock read by thread 0 of the first
// problem's rank-0 CTA at eight points of each round into stamps
// [rounds][8] (irls): the profile of a round.
extern "C" int eyoc_sc2_irls_jacobi_stamped(
    const float* trans_all, const int* best, const float* src,
    const float* tgt, const bool* valid, int B, int N, int S, float thr,
    int it_num, int unroll, int cluster, float* spill, float* trans_out,
    int* iters_out, long long* stamps, cudaStream_t stream) {
  return irls_launch<true, true>(trans_all, best, src, tgt, valid, B, N, S,
                                 thr, it_num, unroll, cluster, spill,
                                 trans_out, iters_out, stamps, stream);
}

// The Jacobi solves of this library (K23, K24) that ran again on the IEEE
// forms (jacobi_pose.cuh), since it was loaded: *out (host memory).
extern "C" int eyoc_sc2_refine_jacobi_reruns(unsigned long long* out) {
  return jacobi_reruns_read(out);
}
