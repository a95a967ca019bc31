// K16 ransac_hypotheses, K17 ransac_verify and K18 (ransac_polish,
// icp_solve): RANSAC's test path and ICP's solve on the card, with nothing
// read back by the host in between.
//
// K16 replaces eyoc_tpu/registration/ransac.py:55 `_sample_triplets`, :61
// `_edge_ok`, :119 `kabsch(s3, t3)` and the coarse `_count_inliers` of
// :132: `prep` (one block) counts the valid rows and gathers the subset
// rows (u * count) of the valid prefix into scratch; `hypotheses` runs one
// thread a hypothesis: the triplet (u * count truncated, in f32), Open3D's
// edge-length check (three unfused norms, |s| / (|t| + 1e-9) inside
// (lo, hi)), the Jacobi Kabsch of the three points with unit weights (so
// the centroids divide by 3 + 1e-6), and its count of the subset rows, staged
// in shared memory a tile at a time, with |R s + t - t'|^2 < thr^2; -1
// where the edge check fails (the edge flag alone, 0 or -1, without a
// subset).
// K17 replaces the full verification of :140-145 (`_count_inliers`, queue
// item 11): `verify`, one block a kept hypothesis, reads trans[keep[h]] and
// its edge flag (coarse >= 0) itself and counts the valid rows within the
// threshold; `verify_best`, one block, takes the first argmax and writes
// the row of trans it names.
// K18 replaces the polish of :148-160 (`ransac_polish`: one block reads
// best on the card, runs the rounds -- warp, |d| < thr over valid rows,
// the weighted Jacobi Kabsch, the old pose kept where fewer than 3 rows
// are inliers -- then the final inlier count) and the solve of
// eyoc_tpu/registration/icp.py:41-46 (`icp_solve`: w = mask & (d2 < r^2)
// from K2's nearest neighbours, the weighted Jacobi Kabsch of the source on
// its matches, and the source warped by the new pose for the next round's
// K2).
//
// `jacobi_pose`, shared by all three, follows eyoc_tpu/geometry/svd3.py:
// kabsch (:283-322) and jacobi_eigh (:31-74) step for step: H / max(max|H|,
// 1e-12), the Horn matrix, 8 cyclic sweeps over (0,1), (0,2), (0,3), (1,2),
// (1,3), (2,3) -- no rotation where |a_pq| < 1e-30, t = sign(tau) / (|tau|
// + sqrt(1 + tau^2)) with sign(0) = 0 -- each rotation applied to the two
// rows, then the two columns it touches, and to V's two columns (no 4x4
// products); the eigenvector of the first largest eigenvalue; R; then t =
// cB - R cA. Its arithmetic is unfused (_rn intrinsics), as the plain
// version's elementwise ops are; moments in the block kernels are taken in
// two centred passes (K15's form).
//
// Every float reduction runs in a fixed order (a thread's rows in order,
// then a fixed shared-memory tree), so each kernel gives the same bits on
// every call. Divisions and square roots are IEEE (no --use_fast_math).
//
// What bounds them: K16 is operations, ~27 flops for each (hypothesis,
// subset row) and ~3000 a Jacobi solve; K17 is operations, ~27 flops for
// each (kept hypothesis, valid row); K18's two entries are one block each,
// a chain of dependent passes and solves: latency, far above their bytes
// and operations.

#include <cuda_runtime.h>

namespace {

constexpr int kHypThreads = 128;     // hypotheses: one thread a hypothesis
constexpr int kSubTile = 512;        // subset rows staged at a time
constexpr int kPrepThreads = 256;
constexpr int kVerifyThreads = 256;  // verify: one block a hypothesis
constexpr int kBestThreads = 1024;   // verify_best: one block
constexpr int kSolveThreads = 512;   // polish / icp: one block
constexpr int kSweeps = 8;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

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

// One Givens rotation of the cyclic Jacobi on the row-major symmetric A
// and the eigenvector columns V (svd3.py:43-69): rows p, q of A, then its
// columns p, q, then V's columns p, q.
template <int p, int q>
__device__ __forceinline__ void givens(float (&A)[16], float (&V)[16]) {
  const float apq = A[4 * p + q], app = A[5 * p], aqq = A[5 * q];
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = __fdiv_rn(sub(aqq, app), small ? 1.f : mul(2.f, apq));
  const float sgn = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : 0.f);
  float t = __fdiv_rn(sgn, add(fabsf(tau),
                               __fsqrt_rn(add(1.f, mul(tau, tau)))));
  if (small) t = 0.f;
  const float c = __fdiv_rn(1.f, __fsqrt_rn(add(1.f, mul(t, t))));
  const float s = mul(t, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x = A[4 * p + j], y = A[4 * q + j];
    A[4 * p + j] = sub(mul(c, x), mul(s, y));
    A[4 * q + j] = add(mul(s, x), mul(c, y));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = A[4 * i + p], y = A[4 * i + q];
    A[4 * i + p] = sub(mul(c, x), mul(s, y));
    A[4 * i + q] = add(mul(s, x), mul(c, y));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = V[4 * i + p], y = V[4 * i + q];
    V[4 * i + p] = sub(mul(c, x), mul(s, y));
    V[4 * i + q] = add(mul(s, x), mul(c, y));
  }
}

// The weighted Kabsch pose from the centred cross-covariance H = sum w
// (a - cA)(b - cB)^T (row-major 3x3) and the centroids: T (row-major 4x4)
// with b ~ R a + t, by the Jacobi eigensolver of the Horn matrix.
__device__ void jacobi_pose(const float* H, const float* cA, const float* cB,
                            float* T) {
  float scale = 0.f;
  for (int k = 0; k < 9; ++k) scale = fmaxf(scale, fabsf(H[k]));
  scale = fmaxf(scale, 1e-12f);
  float S[9];
  for (int k = 0; k < 9; ++k) S[k] = __fdiv_rn(H[k], scale);
  const float Sxx = S[0], Sxy = S[1], Sxz = S[2], Syx = S[3], Syy = S[4],
              Syz = S[5], Szx = S[6], Szy = S[7], Szz = S[8];
  // the Horn profile matrix (svd3.py:horn_profile_matrix)
  float A[16] = {add(add(Sxx, Syy), Szz), sub(Syz, Szy), sub(Szx, Sxz),
                 sub(Sxy, Syx),
                 sub(Syz, Szy), sub(sub(Sxx, Syy), Szz), add(Sxy, Syx),
                 add(Szx, Sxz),
                 sub(Szx, Sxz), add(Sxy, Syx), sub(add(-Sxx, Syy), Szz),
                 add(Syz, Szy),
                 sub(Sxy, Syx), add(Szx, Sxz), add(Syz, Szy),
                 add(sub(-Sxx, Syy), Szz)};
  float V[16] = {1.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f,
                 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 1.f};
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    givens<0, 1>(A, V);
    givens<0, 2>(A, V);
    givens<0, 3>(A, V);
    givens<1, 2>(A, V);
    givens<1, 3>(A, V);
    givens<2, 3>(A, V);
  }
  // the eigenvector of the first largest eigenvalue
  int col = 0;
  float best = A[0];
  for (int c = 1; c < 4; ++c) {
    if (A[5 * c] > best) {
      best = A[5 * c];
      col = c;
    }
  }
  float q[4];
  for (int r = 0; r < 4; ++r) q[r] = V[4 * r + col];
  // the rotation (svd3.py:quat_to_rotmat)
  const float n2 = add(add(add(mul(q[0], q[0]), mul(q[1], q[1])),
                           mul(q[2], q[2])),
                       mul(q[3], q[3]));
  if (n2 > 1e-24f) {
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(n2, 1e-24f)));
    for (int r = 0; r < 4; ++r) q[r] = mul(q[r], inv);
  } else {
    q[0] = 1.f;
    q[1] = q[2] = q[3] = 0.f;
  }
  const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float R[9] = {
      sub(1.f, mul(2.f, add(mul(qy, qy), mul(qz, qz)))),
      mul(2.f, sub(mul(qx, qy), mul(qz, w))),
      mul(2.f, add(mul(qx, qz), mul(qy, w))),
      mul(2.f, add(mul(qx, qy), mul(qz, w))),
      sub(1.f, mul(2.f, add(mul(qx, qx), mul(qz, qz)))),
      mul(2.f, sub(mul(qy, qz), mul(qx, w))),
      mul(2.f, sub(mul(qx, qz), mul(qy, w))),
      mul(2.f, add(mul(qy, qz), mul(qx, w))),
      sub(1.f, mul(2.f, add(mul(qx, qx), mul(qy, qy))))};
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T[4 * r + c] = R[3 * r + c];
    T[4 * r + 3] =
        sub(cB[r], add(add(mul(R[3 * r], cA[0]), mul(R[3 * r + 1], cA[1])),
                       mul(R[3 * r + 2], cA[2])));
  }
  T[12] = T[13] = T[14] = 0.f;
  T[15] = 1.f;
}

// count = max(sum valid, 1) and the subset rows (u_sub * count) of the
// valid prefix: scratch[0] holds count (as an int), then S rows of (s, t).
__global__ void __launch_bounds__(kPrepThreads) prep(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, const float* __restrict__ u_sub,
    int S, float* __restrict__ scratch) {
  __shared__ int cnt[kPrepThreads];
  __shared__ int total;
  const int t = threadIdx.x;
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
    for (int k = 0; k < 3; ++k) {
      const int j = min((int)mul(u_tri[3 * h + k], countf), N - 1);
      for (int c = 0; c < 3; ++c) {
        a[k][c] = src[3 * j + c];
        b[k][c] = tgt[3 * j + c];
      }
    }
    // Open3D's edge-length check: edges (0,1), (1,2), (2,0)
    edge = true;
    for (int k = 0; k < 3; ++k) {
      const int l = k == 2 ? 0 : k + 1;
      const float es = norm3(sub(a[k][0], a[l][0]), sub(a[k][1], a[l][1]),
                             sub(a[k][2], a[l][2]));
      const float et = norm3(sub(b[k][0], b[l][0]), sub(b[k][1], b[l][1]),
                             sub(b[k][2], b[l][2]));
      const float ratio = __fdiv_rn(es, add(et, 1e-9f));
      edge = edge && ratio > lo && ratio < hi;
    }
    // unit weights: the centroids divide by 3 + 1e-6 (svd3.py:301)
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

__global__ void __launch_bounds__(kVerifyThreads) verify(
    const float* __restrict__ trans, const float* __restrict__ coarse,
    const int* __restrict__ keep, const float* __restrict__ src,
    const float* __restrict__ tgt, const bool* __restrict__ valid, int N,
    float thr2, float* __restrict__ counts) {
  __shared__ float pose[16];
  __shared__ int cnt[kVerifyThreads];
  const int t = threadIdx.x;
  const int h = blockIdx.x;
  const long long row = keep != nullptr ? keep[h] : h;
  if (coarse[row] < 0.f) {              // the edge check failed
    if (t == 0) counts[h] = -1.f;
    return;
  }
  if (t < 16) pose[t] = trans[16 * row + t];
  __syncthreads();
  int c = 0;
  for (int n = t; n < N; n += kVerifyThreads)
    c += valid[n] && residual2(pose, src[3 * n], src[3 * n + 1],
                               src[3 * n + 2], tgt[3 * n], tgt[3 * n + 1],
                               tgt[3 * n + 2]) < thr2;
  cnt[t] = c;
  __syncthreads();
  for (int off = kVerifyThreads / 2; off > 0; off >>= 1) {
    if (t < off) cnt[t] += cnt[t + off];
    __syncthreads();
  }
  if (t == 0) counts[h] = (float)cnt[0];
}

// best = the row of trans of the first largest count.
__global__ void __launch_bounds__(kBestThreads) verify_best(
    const float* __restrict__ counts, const int* __restrict__ keep, int Hk,
    int* __restrict__ best) {
  __shared__ float bf[kBestThreads];
  __shared__ int bi[kBestThreads];
  const int t = threadIdx.x;
  float f = -3.4e38f;
  int i = Hk;
  for (int h = t; h < Hk; h += kBestThreads) {
    if (counts[h] > f) {
      f = counts[h];
      i = h;
    }
  }
  bf[t] = f;
  bi[t] = i;
  __syncthreads();
  for (int off = kBestThreads / 2; off > 0; off >>= 1) {
    if (t < off) {
      const float g = bf[t + off];
      const int j = bi[t + off];
      if (g > bf[t] || (g == bf[t] && j < bi[t])) {
        bf[t] = g;
        bi[t] = j;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const int h = bi[0] < Hk ? bi[0] : 0;
    best[0] = keep != nullptr ? keep[h] : h;
  }
}

// Adds red[k][0..kSolveThreads) into red[k][0] for k < n, a fixed tree.
template <int n>
__device__ void block_sums(float (*red)[kSolveThreads]) {
  const int t = threadIdx.x;
  for (int off = kSolveThreads / 2; off > 0; off >>= 1) {
    if (t < off)
      for (int k = 0; k < n; ++k) red[k][t] += red[k][t + off];
    __syncthreads();
  }
}

// The weighted Kabsch of rows (a_n, b_n) with 0/1 weights given by `in(n,
// a, b)`, by one block in two centred passes: wsum and the centroids,
// then H. Returns sum w (every thread); thread 0 writes the new pose into
// `pose` when sum w >= min_w. `red` is 9 x kSolveThreads of shared memory.
template <class Row>
__device__ float block_kabsch(int N, Row row, float min_w, float* pose,
                              float (*red)[kSolveThreads], float* cen) {
  const int t = threadIdx.x;
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = t; n < N; n += kSolveThreads) {
    float a[3], b[3];
    if (!row(n, a, b)) continue;
    acc[0] = add(acc[0], 1.f);
    for (int k = 0; k < 3; ++k) {
      acc[1 + k] = add(acc[1 + k], a[k]);
      acc[4 + k] = add(acc[4 + k], b[k]);
    }
  }
  for (int k = 0; k < 7; ++k) red[k][t] = acc[k];
  __syncthreads();
  block_sums<7>(red);
  const float wtot = red[0][0];
  if (t == 0) {
    const float wsum = add(wtot, 1e-6f);
    for (int k = 0; k < 6; ++k) cen[k] = __fdiv_rn(red[1 + k][0], wsum);
  }
  __syncthreads();
  float m[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = t; n < N; n += kSolveThreads) {
    float a[3], b[3];
    if (!row(n, a, b)) continue;
    float am[3], bm[3];
    for (int k = 0; k < 3; ++k) {
      am[k] = sub(a[k], cen[k]);
      bm[k] = sub(b[k], cen[3 + k]);
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) m[3 * i + j] = add(m[3 * i + j],
                                                   mul(am[i], bm[j]));
  }
  for (int k = 0; k < 9; ++k) red[k][t] = m[k];
  __syncthreads();
  block_sums<9>(red);
  if (t == 0 && wtot >= min_w) {
    float Hm[9];
    for (int k = 0; k < 9; ++k) Hm[k] = red[k][0];
    jacobi_pose(Hm, cen, cen + 3, pose);
  }
  __syncthreads();
  return wtot;
}

__global__ void __launch_bounds__(kSolveThreads) polish(
    const float* __restrict__ trans, const int* __restrict__ best,
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, float thr, int iters,
    float* __restrict__ trans_out, int* __restrict__ inliers) {
  __shared__ float red[9][kSolveThreads];
  __shared__ float pose[16];
  __shared__ float cen[6];
  __shared__ int cnt[kSolveThreads];
  const int t = threadIdx.x;
  if (t < 16) pose[t] = trans[16ll * best[0] + t];
  __syncthreads();
  // an inlier under the current pose: valid and |R s + t - t'| < thr
  auto inlier = [&](int n, float* a, float* b) {
    if (!valid[n]) return false;
    for (int k = 0; k < 3; ++k) {
      a[k] = src[3 * n + k];
      b[k] = tgt[3 * n + k];
    }
    return __fsqrt_rn(residual2(pose, a[0], a[1], a[2], b[0], b[1], b[2])) <
           thr;
  };
  for (int it = 0; it < iters; ++it)
    block_kabsch(N, inlier, 3.f, pose, red, cen);
  int c = 0;
  float a[3], b[3];
  for (int n = t; n < N; n += kSolveThreads) c += inlier(n, a, b);
  cnt[t] = c;
  __syncthreads();
  for (int off = kSolveThreads / 2; off > 0; off >>= 1) {
    if (t < off) cnt[t] += cnt[t + off];
    __syncthreads();
  }
  if (t < 16) trans_out[t] = pose[t];
  if (t == 0) inliers[0] = cnt[0];
}

__global__ void __launch_bounds__(kSolveThreads) icp(
    const float* __restrict__ src, const bool* __restrict__ mask,
    const float* __restrict__ tgt, const int* __restrict__ nn,
    const float* __restrict__ d2, int N, float r2,
    float* __restrict__ trans_out, float* __restrict__ warped) {
  __shared__ float red[9][kSolveThreads];
  __shared__ float pose[16];
  __shared__ float cen[6];
  // a correspondence: a valid source row whose nearest target lies within
  // the radius (w = mask & (d2 < r^2)), matched to that target
  auto matched = [&](int n, float* a, float* b) {
    if (!(mask[n] && d2[n] < r2)) return false;
    const int j = nn[n];
    for (int k = 0; k < 3; ++k) {
      a[k] = src[3 * n + k];
      b[k] = tgt[3 * j + k];
    }
    return true;
  };
  block_kabsch(N, matched, -1.f, pose, red, cen);
  const int t = threadIdx.x;
  for (int n = t; n < N; n += kSolveThreads)
    warp_point(pose, src[3 * n], src[3 * n + 1], src[3 * n + 2],
               warped + 3 * n);
  if (t < 16) trans_out[t] = pose[t];
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
                                       scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || H == 0) return err;
  hypotheses<<<(H + kHypThreads - 1) / kHypThreads, kHypThreads, 0,
               stream>>>(src, tgt, N, u_tri, H, S, thr2, lo, hi, scratch,
                         trans, coarse);
  return cudaGetLastError();
}

// K17: trans [H, 4, 4], coarse [H], keep [Hk] int32 (null: every
// hypothesis), src/tgt [N, 3], valid [N] -> counts [Hk] f32 and best
// (the row of trans of the first largest count) int32. Two launches.
extern "C" int eyoc_ransac_verify(const float* trans, const float* coarse,
                                  const int* keep, int Hk, const float* src,
                                  const float* tgt, const bool* valid, int N,
                                  float thr2, float* counts, int* best,
                                  cudaStream_t stream) {
  if (Hk <= 0) return cudaErrorInvalidValue;
  verify<<<Hk, kVerifyThreads, 0, stream>>>(trans, coarse, keep, src, tgt,
                                            valid, N, thr2, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  verify_best<<<1, kBestThreads, 0, stream>>>(counts, keep, Hk, best);
  return cudaGetLastError();
}

// K18 ransac_polish: trans [H, 4, 4], best int32, src/tgt [N, 3], valid
// [N] -> trans_out [4, 4], inliers int32. One launch.
extern "C" int eyoc_ransac_polish(const float* trans, const int* best,
                                  const float* src, const float* tgt,
                                  const bool* valid, int N, float thr,
                                  int iters, float* trans_out, int* inliers,
                                  cudaStream_t stream) {
  polish<<<1, kSolveThreads, 0, stream>>>(trans, best, src, tgt, valid, N,
                                          thr, iters, trans_out, inliers);
  return cudaGetLastError();
}

// K18 icp_solve: src [N, 3], mask [N], tgt [M, 3], nn [N] int32 and d2 [N]
// (K2's on the warped source) -> trans_out [4, 4] and warped [N, 3] (the
// source under it). One launch.
extern "C" int eyoc_icp_solve(const float* src, const bool* mask,
                              const float* tgt, const int* nn,
                              const float* d2, int N, float r2,
                              float* trans_out, float* warped,
                              cudaStream_t stream) {
  icp<<<1, kSolveThreads, 0, stream>>>(src, mask, tgt, nn, d2, N, r2,
                                       trans_out, warped);
  return cudaGetLastError();
}
