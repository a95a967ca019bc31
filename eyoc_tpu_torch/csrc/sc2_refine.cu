// K14 sc2_seed_transforms and K15 sc2_irls: SC2-PCR from each seed's k1
// columns to the refined pose, for B problems, with nothing read back by
// the host in between.
//
// K14 replaces eyoc_tpu/registration/sc2pcr.py:161 `_seed_transforms`
// (with its k2 x k2 `_power_iteration`, :100) after K4's k1 selection:
// one block a (problem, seed), `seed_consensus`, runs in shared memory
//   nbr_ok = valid[knn]; the k1 x k1 hard mask |d_S - d_T| < d over valid
//   pairs (distances sqrt((dx*dx + dy*dy) + dz*dz), unfused, as K4 and the
//   plain version); the seed row's exact counts; the top k2 of
//   (nbr_ok ? count : -1) by (count desc, index asc); the soft k2 x k2
//   matrix clip(1 - cross^2 / d^2, 0) over valid pairs with a zero
//   diagonal; `iters` power iterations normalized by |v| + 1e-6;
//   w = |v| * fine_ok / (sum + 1e-6); the weighted QCP Kabsch; and the
//   fitness, the count over the problem's valid rows of
//   |R s_n + t - t_n| < inlier_threshold, -1 where the seed is not ok.
// A second launch, `seed_best`, one block a problem, takes the first
// argmax of the fitness.
//
// K15 replaces :219 `_post_refine`: one persistent block a problem,
// `irls`, starts from trans[b, best[b]] and runs the IRLS while-loop with
// its exact stop, (it < it_num) & (it == 0 | |cur - prev| >= 1): warp,
// distance, inliers (dist < thr over valid rows), Cauchy weights
// 1 / (1 + (dist / thr)^2), the weighted Kabsch from centred moments taken
// in two passes, and the old pose kept when no row is an inlier.
//
// `qcp_pose`, shared by both, follows eyoc_tpu/geometry/svd3.py:
// kabsch_qcp (:131-160) and qcp_leading_quaternion (:101-128) step for
// step: max|H| scaling, lam_upper, 12 Newton steps on the quartic with the
// 1e-12 derivative guard, the adjugate column of largest norm (or the
// identity quaternion), 2 shifted power steps, R, then t = cB - R cA.
//
// Every float reduction runs in a fixed order (a thread's rows in order,
// then a fixed shared-memory tree), so both kernels give the same bits on
// every call. Divisions and square roots are IEEE (no --use_fast_math), as
// torch's on the CPU.
//
// What bounds them: K14 is a chain of small dependent steps a seed (20
// power iterations, the QCP solve) plus the fitness's operations, about
// 25 flops for each (seed, valid row); K15 is one block a problem and
// 20 dependent iterations at most, two passes over the valid rows each:
// latency, far above their bytes and operations.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;          // k1 and k2 at most (K4's _K4_MAX_K)
constexpr int kSeedThreads = 128;  // seed_consensus: one block a seed
constexpr int kBestThreads = 256;  // seed_best: one block a problem
constexpr int kIrlsThreads = 512;  // irls: one block a problem
constexpr int kMoments = 11;       // sum w, sum w a (3), sum w b (3); then
                                   // H (9), GA, GB

__device__ __forceinline__ float dist3_rn(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz)));
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

__global__ void __launch_bounds__(kSeedThreads) seed_consensus(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, const int* __restrict__ knn,
    const bool* __restrict__ seed_ok, int N, int S, int k1, int k2,
    float d_thre, float d_thre2, float inlier_thr, int iters,
    float* __restrict__ trans, float* __restrict__ fitness,
    int* __restrict__ fine_out) {
  __shared__ float ps[kMaxK][3], pt[kMaxK][3];
  __shared__ int ok[kMaxK], key[kMaxK], fine[kMaxK];
  __shared__ float cross[kMaxK][kMaxK + 1];
  __shared__ float M[kMaxK][kMaxK + 1];
  __shared__ float v[kMaxK], y[kMaxK];
  __shared__ float nrm;
  __shared__ float pose[16];
  __shared__ int cnt[kSeedThreads];
  const int t = threadIdx.x;
  const int b = blockIdx.x / S;
  const int s = blockIdx.x - b * S;
  const float* P = src + (long long)b * N * 3;
  const float* Q = tgt + (long long)b * N * 3;
  const bool* V = valid + (long long)b * N;
  const int* kn = knn + ((long long)b * S + s) * k1;
  if (t < k1) {
    const int j = kn[t];
    for (int c = 0; c < 3; ++c) {
      ps[t][c] = P[3 * j + c];
      pt[t][c] = Q[3 * j + c];
    }
    ok[t] = V[j];
  }
  __syncthreads();
  // cross[i][j] = |d_S(i, j) - d_T(i, j)| over the k1 columns
  for (int e = t; e < k1 * k1; e += kSeedThreads) {
    const int i = e / k1, j = e - i * k1;
    const float ds = dist3_rn(ps[i][0], ps[i][1], ps[i][2], ps[j][0],
                              ps[j][1], ps[j][2]);
    const float dt = dist3_rn(pt[i][0], pt[i][1], pt[i][2], pt[j][0],
                              pt[j][1], pt[j][2]);
    cross[i][j] = fabsf(__fsub_rn(ds, dt));
  }
  __syncthreads();
  // the seed row's exact local SC^2: hard[0][i] * hard[i][j] summed over i
  if (t < k1) {
    int c = 0;
    if (ok[t] && ok[0])
      for (int i = 0; i < k1; ++i)
        c += ok[i] && cross[0][i] < d_thre && cross[i][t] < d_thre;
    key[t] = ok[t] ? c : -1;
  }
  __syncthreads();
  // the top k2 by (key desc, index asc): each column's rank
  if (t < k1) {
    const int kt = key[t];
    int r = 0;
    for (int i = 0; i < k1; ++i) r += key[i] > kt || (key[i] == kt && i < t);
    if (r < k2) fine[r] = t;
  }
  __syncthreads();
  // the soft k2 x k2 matrix over valid pairs, zero diagonal
  for (int e = t; e < k2 * k2; e += kSeedThreads) {
    const int i = e / k2, j = e - i * k2;
    const int fi = fine[i], fj = fine[j];
    float m = 0.f;
    if (i != j && ok[fi] && ok[fj]) {
      const float c = cross[fi][fj];
      m = fmaxf(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(c, c), d_thre2)), 0.f);
    }
    M[i][j] = m;
  }
  if (t < k2) v[t] = 1.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (t < k2) {
      float a = 0.f;
      for (int j = 0; j < k2; ++j) a += M[t][j] * v[j];
      y[t] = a;
    }
    __syncthreads();
    if (t == 0) {
      float q = 0.f;
      for (int j = 0; j < k2; ++j) q += y[j] * y[j];
      nrm = sqrtf(q) + 1e-6f;
    }
    __syncthreads();
    if (t < k2) v[t] = y[t] / nrm;
    __syncthreads();
  }
  // the weights and the weighted Kabsch over the k2 points (one thread)
  if (t == 0) {
    float w[kMaxK];
    float ws = 0.f;
    for (int i = 0; i < k2; ++i) {
      w[i] = ok[fine[i]] ? fabsf(v[i]) : 0.f;
      ws += w[i];
    }
    const float wn = ws + 1e-6f;
    float wsum = 0.f, sa[3] = {0.f, 0.f, 0.f}, sb[3] = {0.f, 0.f, 0.f};
    for (int i = 0; i < k2; ++i) {
      w[i] = w[i] / wn;
      wsum += w[i];
      for (int c = 0; c < 3; ++c) {
        sa[c] += ps[fine[i]][c] * w[i];
        sb[c] += pt[fine[i]][c] * w[i];
      }
    }
    wsum += 1e-6f;
    float cA[3], cB[3];
    for (int c = 0; c < 3; ++c) {
      cA[c] = sa[c] / wsum;
      cB[c] = sb[c] / wsum;
    }
    float H[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float GA = 0.f, GB = 0.f;
    for (int i = 0; i < k2; ++i) {
      float am[3], bm[3];
      for (int c = 0; c < 3; ++c) {
        am[c] = ps[fine[i]][c] - cA[c];
        bm[c] = pt[fine[i]][c] - cB[c];
      }
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) H[3 * r + c] += am[r] * w[i] * bm[c];
      GA += w[i] * (am[0] * am[0] + am[1] * am[1] + am[2] * am[2]);
      GB += w[i] * (bm[0] * bm[0] + bm[1] * bm[1] + bm[2] * bm[2]);
    }
    qcp_pose(H, GA, GB, cA, cB, pose);
  }
  __syncthreads();
  // the fitness over the problem's valid rows
  int c = 0;
  for (int n = t; n < N; n += kSeedThreads) {
    if (!V[n]) continue;
    float o[3];
    warp_point(pose, P[3 * n], P[3 * n + 1], P[3 * n + 2], o);
    c += dist3_rn(o[0], o[1], o[2], Q[3 * n], Q[3 * n + 1], Q[3 * n + 2]) <
         inlier_thr;
  }
  cnt[t] = c;
  __syncthreads();
  for (int off = kSeedThreads / 2; off > 0; off >>= 1) {
    if (t < off) cnt[t] += cnt[t + off];
    __syncthreads();
  }
  const long long row = (long long)b * S + s;
  if (t < 16) trans[row * 16 + t] = pose[t];
  if (t == 0) fitness[row] = seed_ok[row] ? (float)cnt[0] : -1.f;
  if (t < k2) fine_out[row * k2 + t] = fine[t];
}

// best[b] = the first seed of largest fitness.
__global__ void __launch_bounds__(kBestThreads) seed_best(
    const float* __restrict__ fitness, int S, int* __restrict__ best) {
  __shared__ float bf[kBestThreads];
  __shared__ int bi[kBestThreads];
  const int t = threadIdx.x;
  const float* F = fitness + (long long)blockIdx.x * S;
  float f = -3.4e38f;
  int i = S;
  for (int s = t; s < S; s += kBestThreads) {
    if (F[s] > f) {
      f = F[s];
      i = s;
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
  if (t == 0) best[blockIdx.x] = bi[0] < S ? bi[0] : 0;
}

// Adds red[k][0..kIrlsThreads) into red[k][0] for k < n, a fixed tree.
__device__ void block_sums(float (*red)[kIrlsThreads], int n) {
  const int t = threadIdx.x;
  for (int off = kIrlsThreads / 2; off > 0; off >>= 1) {
    if (t < off)
      for (int k = 0; k < n; ++k) red[k][t] += red[k][t + off];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kIrlsThreads) irls(
    const float* __restrict__ trans_all, const int* __restrict__ best,
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, int S, float thr, int it_num,
    float* __restrict__ trans_out, int* __restrict__ iters_out) {
  __shared__ float red[kMoments][kIrlsThreads];
  __shared__ int cnt[kIrlsThreads];
  __shared__ float pose[16];
  __shared__ float cen[6];
  __shared__ int count;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const float* P = src + (long long)b * N * 3;
  const float* Q = tgt + (long long)b * N * 3;
  const bool* V = valid + (long long)b * N;
  if (t < 16) pose[t] = trans_all[((long long)b * S + best[b]) * 16 + t];
  __syncthreads();
  int prev = 0, cur = 0, it = 0;
  while (it < it_num && (it == 0 || abs(cur - prev) >= 1)) {
    // pass 1: the inliers under the current pose, sum w, sum w a, sum w b
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int c = 0;
    for (int n = t; n < N; n += kIrlsThreads) {
      if (!V[n]) continue;
      const float a[3] = {P[3 * n], P[3 * n + 1], P[3 * n + 2]};
      const float q[3] = {Q[3 * n], Q[3 * n + 1], Q[3 * n + 2]};
      float o[3];
      warp_point(pose, a[0], a[1], a[2], o);
      const float d = dist3_rn(o[0], o[1], o[2], q[0], q[1], q[2]);
      if (!(d < thr)) continue;
      const float r = __fdiv_rn(d, thr);
      const float w = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(r, r)));
      ++c;
      acc[0] += w;
      for (int k = 0; k < 3; ++k) {
        acc[1 + k] += a[k] * w;
        acc[4 + k] += q[k] * w;
      }
    }
    for (int k = 0; k < 7; ++k) red[k][t] = acc[k];
    cnt[t] = c;
    __syncthreads();
    for (int off = kIrlsThreads / 2; off > 0; off >>= 1) {
      if (t < off) {
        for (int k = 0; k < 7; ++k) red[k][t] += red[k][t + off];
        cnt[t] += cnt[t + off];
      }
      __syncthreads();
    }
    if (t == 0) {
      const float wsum = red[0][0] + 1e-6f;
      for (int k = 0; k < 6; ++k) cen[k] = red[1 + k][0] / wsum;
      count = cnt[0];
    }
    __syncthreads();
    // pass 2: the centred moments
    float m[kMoments] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
                         0.f};
    for (int n = t; n < N; n += kIrlsThreads) {
      if (!V[n]) continue;
      const float a[3] = {P[3 * n], P[3 * n + 1], P[3 * n + 2]};
      const float q[3] = {Q[3 * n], Q[3 * n + 1], Q[3 * n + 2]};
      float o[3];
      warp_point(pose, a[0], a[1], a[2], o);
      const float d = dist3_rn(o[0], o[1], o[2], q[0], q[1], q[2]);
      if (!(d < thr)) continue;
      const float r = __fdiv_rn(d, thr);
      const float w = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(r, r)));
      float am[3], bm[3];
      for (int k = 0; k < 3; ++k) {
        am[k] = a[k] - cen[k];
        bm[k] = q[k] - cen[3 + k];
      }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) m[3 * i + j] += am[i] * w * bm[j];
      m[9] += w * (am[0] * am[0] + am[1] * am[1] + am[2] * am[2]);
      m[10] += w * (bm[0] * bm[0] + bm[1] * bm[1] + bm[2] * bm[2]);
    }
    for (int k = 0; k < kMoments; ++k) red[k][t] = m[k];
    __syncthreads();
    block_sums(red, kMoments);
    if (t == 0 && count > 0) {
      float H[9];
      for (int k = 0; k < 9; ++k) H[k] = red[k][0];
      float T[16];
      qcp_pose(H, red[9][0], red[10][0], cen, cen + 3, T);
      for (int k = 0; k < 16; ++k) pose[k] = T[k];
    }
    prev = cur;
    cur = count;
    ++it;
    __syncthreads();
  }
  if (t < 16) trans_out[(long long)b * 16 + t] = pose[t];
  if (t == 0) iters_out[b] = it;
}

}  // namespace

// K14: src/tgt [B, N, 3] f32, valid [B, N] bool, knn [B, S, k1] int32,
// seed_ok [B, S] bool -> trans [B, S, 4, 4], fitness [B, S], best [B]
// int32 and fine_out [B, S, k2] int32 (the consensus sets, as positions
// among the k1 columns). Two launches.
extern "C" int eyoc_sc2_seed_transforms(
    const float* src, const float* tgt, const bool* valid, const int* knn,
    const bool* seed_ok, int B, int N, int S, int k1, int k2, float d_thre,
    float d_thre2, float inlier_thr, int iters, float* trans, float* fitness,
    int* best, int* fine_out, cudaStream_t stream) {
  if (k1 < 1 || k1 > kMaxK || k2 < 1 || k2 > k1) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return cudaSuccess;
  seed_consensus<<<B * S, kSeedThreads, 0, stream>>>(
      src, tgt, valid, knn, seed_ok, N, S, k1, k2, d_thre, d_thre2,
      inlier_thr, iters, trans, fitness, fine_out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seed_best<<<B, kBestThreads, 0, stream>>>(fitness, S, best);
  return cudaGetLastError();
}

// K15: trans_all [B, S, 4, 4], best [B] int32, src/tgt [B, N, 3], valid
// [B, N] -> trans [B, 4, 4], iterations [B] int32. One launch.
extern "C" int eyoc_sc2_irls(const float* trans_all, const int* best,
                             const float* src, const float* tgt,
                             const bool* valid, int B, int N, int S,
                             float thr, int it_num, float* trans_out,
                             int* iters_out, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  irls<<<B, kIrlsThreads, 0, stream>>>(trans_all, best, src, tgt, valid, N,
                                       S, thr, it_num, trans_out, iters_out);
  return cudaGetLastError();
}
