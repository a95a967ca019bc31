// K18 ransac_polish's time split, to read on the card: one Jacobi solve
// alone, the Givens chain alone, and one pass of the rows in two layouts.
// Each entry runs its work `reps` times in a dependent chain inside one
// launch, so that the difference of two launches (reps = 1 and 1 + R) over
// R is the time of one unit without the launch. Not part of the port:
// profile_k18_polish.py builds and runs it.
//
// - solve: `jacobi_pose` (csrc/jacobi_pose.cuh, the solve of K16-K18) on
//   thread 0, its input made to depend on the previous output;
// - solve, warp: `jacobi_pose_warp` below (each rotation's element updates
//   spread over the lanes of a warp, the same bits as jacobi_pose), the
//   same way;
// - chain: the division and root chain of the 48 Givens rotations alone,
//   each rotation's input depending on the last one's (c, s): what no
//   spreading of the element updates over lanes removes. Once as
//   `rotation()` runs it (three IEEE divisions a rotation), once with the
//   quotients of 1 as IEEE reciprocals (`rotation_rcp` below: the same
//   bits);
// - pass, global: the inlier test and the 7 sums of a round's first pass
//   as the parent's polish ran it: each thread's rows read from global
//   memory behind a `valid` load, then the 9-level shared-memory tree
//   (`block_sums`, 512 threads);
// - pass, shared: the same pass as csrc/ransac.cu's polish runs it: the
//   valid rows copied once into shared memory (not timed: reps = 1 and
//   1 + R both copy), then the rows of each thread and the xor-shuffle
//   tree (`polish_sums`).

#include "../ransac.cu"

namespace {

constexpr int kSolveThreads = 512;   // the parent's one-block pass

// rotation() with 1 / x as __frcp_rn(x) and sign(tau) / x as sign(tau) *
// (1 / x): the same bits (each the IEEE quotient), one division a rotation
// instead of three.
__device__ __forceinline__ void rotation_rcp(float app, float aqq, float apq,
                                             float& c, float& s) {
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = __fdiv_rn(sub(aqq, app), small ? 1.f : mul(2.f, apq));
  const float sgn = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : 0.f);
  float t = mul(sgn, __frcp_rn(add(fabsf(tau),
                                   __fsqrt_rn(add(1.f, mul(tau, tau))))));
  if (small) t = 0.f;
  c = __frcp_rn(__fsqrt_rn(add(1.f, mul(t, t))));
  s = mul(t, c);
}

// The same rotation over the lanes of one warp: lane l < 16 holds A[l / 4]
// [l % 4], lane 16 + l holds V[l / 4][l % 4]. Every lane reads a_pp, a_qq,
// a_pq and a_qp and the two other elements its update needs, computes the
// same (c, s), then its element by the operations of givens() (a corner
// of A from its row-step values), so the warp holds givens()'s bits.
template <int p, int q>
__device__ __forceinline__ void givens_warp(float& a) {
  const unsigned all = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31, i = (lane & 15) >> 2, j = lane & 3;
  const bool v = lane >= 16, row = i == p || i == q, col = j == p || j == q;
  // the two elements of this lane's update: V[i][p], V[i][q]; A[p][j],
  // A[q][j] (the row step alone); A[i][p], A[i][q] (the column step alone)
  const int s1 = v ? 16 + 4 * i + p : (row && !col ? 4 * p + j : 4 * i + p);
  const int s2 = v ? 16 + 4 * i + q : (row && !col ? 4 * q + j : 4 * i + q);
  const float app = __shfl_sync(all, a, 5 * p);
  const float aqq = __shfl_sync(all, a, 5 * q);
  const float apq = __shfl_sync(all, a, 4 * p + q);
  const float aqp = __shfl_sync(all, a, 4 * q + p);
  const float x = __shfl_sync(all, a, s1), y = __shfl_sync(all, a, s2);
  float c, s;
  rotation(app, aqq, apq, c, s);
  if (!v && row && col) {         // a corner: the row step's (i, p), (i, q)
    const float rp = i == p ? sub(mul(c, app), mul(s, aqp))
                            : add(mul(s, app), mul(c, aqp));
    const float rq = i == p ? sub(mul(c, apq), mul(s, aqq))
                            : add(mul(s, apq), mul(c, aqq));
    a = j == p ? sub(mul(c, rp), mul(s, rq)) : add(mul(s, rp), mul(c, rq));
  } else if (!v && row) {         // row p or q: the row step
    a = i == p ? sub(mul(c, x), mul(s, y)) : add(mul(s, x), mul(c, y));
  } else if (col) {               // column p or q of A, or of V
    a = j == p ? sub(mul(c, x), mul(s, y)) : add(mul(s, x), mul(c, y));
  }
}


// jacobi_pose by the 32 lanes of one warp, each given the same H, cA and
// cB: its rotations spread over the lanes (givens_warp); the same bits in
// T, in every lane.
__device__ void jacobi_pose_warp(const float* H, const float* cA,
                                 const float* cB, float* T) {
  const unsigned all = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  float A[16];
  horn_matrix(H, A);
  float a = lane < 16 ? A[lane] : ((lane - 16) % 5 == 0 ? 1.f : 0.f);
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    givens_warp<0, 1>(a);
    givens_warp<0, 2>(a);
    givens_warp<0, 3>(a);
    givens_warp<1, 2>(a);
    givens_warp<1, 3>(a);
    givens_warp<2, 3>(a);
  }
  float d[4];
  for (int c = 0; c < 4; ++c) d[c] = __shfl_sync(all, a, 5 * c);
  const int col = largest(d);
  float q[4];
  for (int r = 0; r < 4; ++r) q[r] = __shfl_sync(all, a, 16 + 4 * r + col);
  quat_pose(q, cA, cB, T);
}

__global__ void probe_solve_kernel(const float* __restrict__ in, int reps,
                                   int warp_form, float* __restrict__ out) {
  if (!warp_form && threadIdx.x != 0) return;
  float H[9], c[6], T[16];
  for (int k = 0; k < 9; ++k) H[k] = in[k];
  for (int k = 0; k < 6; ++k) c[k] = in[9 + k];
  for (int r = 0; r < reps; ++r) {
    if (warp_form)
      jacobi_pose_warp(H, c, c + 3, T);
    else
      jacobi_pose(H, c, c + 3, T);
    H[0] = add(H[0], mul(T[0], 0.f));      // the next solve waits on this
  }
  if (threadIdx.x == 0)
    for (int k = 0; k < 16; ++k) out[k] = T[k];
}

__global__ void probe_chain_kernel(const float* __restrict__ in, int reps,
                                   int reciprocal, float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  float app = in[0], aqq = in[4], apq = in[1], c = 1.f, s = 0.f;
  for (int r = 0; r < reps * 6 * kSweeps; ++r) {
    aqq = add(aqq, mul(c, 0.f));
    if (reciprocal)
      rotation_rcp(app, aqq, apq, c, s);
    else
      rotation(app, aqq, apq, c, s);
    apq = add(apq, mul(s, 1e-3f));         // a new rotation each step
  }
  out[0] = c;
  out[1] = s;
}

__global__ void __launch_bounds__(kSolveThreads) probe_pass_global(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, const float* __restrict__ pose0,
    float thr, int reps, float* __restrict__ out) {
  __shared__ float red[9][kSolveThreads];
  __shared__ float pose[16];
  const int t = threadIdx.x;
  if (t < 16) pose[t] = pose0[t];
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n = t; n < N; n += kSolveThreads) {
      if (!valid[n]) continue;
      float a[3], b[3];
      for (int k = 0; k < 3; ++k) {
        a[k] = src[3 * n + k];
        b[k] = tgt[3 * n + k];
      }
      if (!(__fsqrt_rn(residual2(pose, a[0], a[1], a[2], b[0], b[1],
                                 b[2])) < thr))
        continue;
      acc[0] = add(acc[0], 1.f);
      for (int k = 0; k < 3; ++k) {
        acc[1 + k] = add(acc[1 + k], a[k]);
        acc[4 + k] = add(acc[4 + k], b[k]);
      }
    }
    for (int k = 0; k < 7; ++k) red[k][t] = acc[k];
    __syncthreads();
    block_sums<kSolveThreads, 7>(red);
    if (t == 0) pose[3] = add(pose[3], mul(red[0][0], 0.f));
    __syncthreads();
  }
  if (t < 7) out[t] = red[t][0];
}

__global__ void __launch_bounds__(kPolishThreads) probe_pass_shared(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, const float* __restrict__ pose0,
    float thr, int reps, float* __restrict__ out) {
  extern __shared__ float rows[];
  __shared__ float part[2][7][kPolishWarps];
  __shared__ int ipart[kPolishWarps];
  const int t = threadIdx.x;
  const int per = (N + kPolishThreads - 1) / kPolishThreads;
  const int n0 = min(N, t * per), n1 = min(N, n0 + per);
  int c = 0;
  for (int n = n0; n < n1; ++n) c += valid[n];
  int M;
  int pos = polish_scan(c, ipart, M);
  for (int n = n0; n < n1; ++n) {
    if (!valid[n]) continue;
    for (int k = 0; k < 3; ++k) {
      rows[k * N + pos] = src[3 * n + k];
      rows[(3 + k) * N + pos] = tgt[3 * n + k];
    }
    ++pos;
  }
  __syncthreads();
  const float *sx = rows, *sy = rows + N, *sz = rows + 2 * N,
              *tx = rows + 3 * N, *ty = rows + 4 * N, *tz = rows + 5 * N;
  float T[16];
  for (int k = 0; k < 16; ++k) T[k] = pose0[k];
  float s1[7];
  for (int r = 0; r < reps; ++r) {
    for (int k = 0; k < 7; ++k) s1[k] = 0.f;
    for (int m = t; m < M; m += kPolishThreads) {
      if (!(__fsqrt_rn(residual2(T, sx[m], sy[m], sz[m], tx[m], ty[m],
                                 tz[m])) < thr))
        continue;
      s1[0] = add(s1[0], 1.f);
      s1[1] = add(s1[1], sx[m]);
      s1[2] = add(s1[2], sy[m]);
      s1[3] = add(s1[3], sz[m]);
      s1[4] = add(s1[4], tx[m]);
      s1[5] = add(s1[5], ty[m]);
      s1[6] = add(s1[6], tz[m]);
    }
    polish_sums(s1, part[r & 1]);
    T[3] = add(T[3], mul(s1[0], 0.f));     // the next pass waits on this
  }
  if (t < 7) out[t] = s1[t];
}

}  // namespace

// in: H [9] then cA, cB [6]; kind 0 solve, 1 solve by a warp, 2 the chain
// as rotation() runs it, 3 as rotation_rcp(); out: T [16], or (c, s).
extern "C" int eyoc_probe_solve(const float* in, int reps, int kind,
                                float* out, cudaStream_t stream) {
  if (kind >= 2)
    probe_chain_kernel<<<1, 32, 0, stream>>>(in, reps, kind == 3, out);
  else
    probe_solve_kernel<<<1, 32, 0, stream>>>(in, reps, kind, out);
  return cudaGetLastError();
}

// src/tgt [N, 3], valid [N], pose [16] -> out [7]: the first pass's sums
// (inliers, source and target sums) under pose, reps times.
extern "C" int eyoc_probe_pass(const float* src, const float* tgt,
                               const bool* valid, int N, const float* pose,
                               float thr, int reps, int shared, float* out,
                               cudaStream_t stream) {
  if (!shared) {
    probe_pass_global<<<1, kSolveThreads, 0, stream>>>(src, tgt, valid, N,
                                                       pose, thr, reps, out);
    return cudaGetLastError();
  }
  if (N <= 0 || N > kPolishMaxRows) return cudaErrorInvalidValue;
  const int smem = 6 * N * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_pass_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  probe_pass_shared<<<1, kPolishThreads, smem, stream>>>(src, tgt, valid, N,
                                                         pose, thr, reps,
                                                         out);
  return cudaGetLastError();
}
