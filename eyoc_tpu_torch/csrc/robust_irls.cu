// K19 est_quad_linear_robust: the valid step's IRLS pose, every round in
// one launch.
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
// Design: one block of 512 threads a problem (problems are batched over
// blocks, so a data-parallel valid step can call it with several pairs).
// - The valid rows are copied once, in index order, into six arrays of
//   dynamic shared memory (24 B a row: at most kMaxRows = 8192 rows, 196
//   KB); a problem with more reads and writes its rows in its part of a
//   global copy, in the same order. Masked rows are skipped, not
//   multiplied by a zero weight: for finite rows that is what JAX
//   computes, and non-finite padding cannot poison the sums.
// - The 21 entries of M's upper triangle are 10 distinct sums (the others
//   are 0 or repeat one: M00 = Syy + Szz, M01 = -Sxy, M04 = -Sz, M33 =
//   Sa, ...), v is 6 more: 16 sums a round. Row m belongs to thread m %
//   kThreads. A round's one pass over the rows warps each row in place,
//   takes its new weight and adds its 16 terms for the next round's
//   system, so the weights are never stored. The sums go by a fixed
//   xor-shuffle tree over each warp, the 16 warps' partials through
//   shared memory and one barrier (two buffers, by round parity), then the
//   same tree over the partials in every warp: every thread holds the
//   same bits, solves the 6 x 6 system itself (Gaussian elimination with
//   partial pivoting, the first largest pivot, then back substitution),
//   forms Tc with precise sinf / cosf and composes T in registers. One
//   barrier a round; no host sync for the 20 rounds.
// - Every operation is rounded apart (__fmul_rn, __fadd_rn, ...: nvcc
//   contracts no FMA), divisions and roots are IEEE (no --use_fast_math),
//   so the plain mirror (geometry/robust.py:est_quad_linear_robust_k19_plain)
//   repeats its arithmetic; a problem with no valid row gives M = 1e-6 I,
//   v = 0, x = 0 and the identity.
//
// What bounds it: 20 dependent rounds, each a pass over the rows (about 40
// flops a row), a tree and a 6 x 6 solve on every thread: latency and
// instruction issue on one SM a problem, far above its bytes (the rows
// once) and its operations.

#include <cuda_runtime.h>

#include <math.h>

#ifndef EYOC_K19_MAX_ROWS
#define EYOC_K19_MAX_ROWS 8192
#endif

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = EYOC_K19_MAX_ROWS;  // rows in shared memory
constexpr int kSums = 16;
constexpr int kCopyBatch = 4;                // the copy: 32-row groups a pass
constexpr float kTikhonov = 1e-6f;

// The sums of v[k] over the warp by a fixed xor-shuffle tree: every lane
// gets the same bits (a + b == b + a).
template <int n>
__device__ __forceinline__ void warp_sums(float (&v)[n]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
}

// Each row n < N of a problem, valid flags V and coordinates P, Q [N, 3],
// as put(m, r): r its six coordinates (source, then target), m its place
// among the valid rows in index order; invalid rows are not read. start(M)
// first, with their count M. Warp w takes the rows of its segment [w seg,
// (w + 1) seg) (seg a multiple of 32): it counts its valid rows, the
// warps' counts go through `part` and one barrier, then it places its rows
// by ballots from its base, kCopyBatch groups of 32 rows a pass with the
// pass's loads first (as csrc/sc2_refine.cu's copy_valid).
template <class Start, class Put>
__device__ __forceinline__ void copy_valid(const float* __restrict__ P,
                                           const float* __restrict__ Q,
                                           const bool* __restrict__ V, int N,
                                           int* part, Start start, Put put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = ((N + kWarps - 1) / kWarps + 31) & ~31;
  const int n0 = min(N, warp * seg), n1 = min(N, n0 + seg);
  int c = 0;
  for (int n = n0 + lane; n < n1; n += 32) c += V[n];
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
  if (lane == 0) part[warp] = c;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int x = part[w];
    base += w < warp ? x : 0;
    total += x;
  }
  start(total);
  const unsigned below = (1u << lane) - 1u;
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
      if (v[k]) put(base + __popc(bal & below), r[k]);
      base += __popc(bal);
    }
  }
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

// x of (M + 1e-6 I) x = v from the 16 sums: Gaussian elimination with
// partial pivoting (the first row of largest |entry|), then back
// substitution. Every index is a constant after unrolling, so the system
// stays in registers.
__device__ __forceinline__ void solve6(const float (&S)[kSums],
                                       float (&x)[6]) {
  const float sa = S[0], sx = S[1], sy = S[2], sz = S[3], sxx = S[4],
              syy = S[5], szz = S[6], sxy = S[7], sxz = S[8], syz = S[9];
  const float e = kTikhonov, d = __fadd_rn(sa, kTikhonov);
  float A[6][7] = {
      {__fadd_rn(__fadd_rn(syy, szz), e), -sxy, -sxz, 0.f, -sz, sy, S[13]},
      {-sxy, __fadd_rn(__fadd_rn(sxx, szz), e), -syz, sz, 0.f, -sx, S[14]},
      {-sxz, -syz, __fadd_rn(__fadd_rn(sxx, syy), e), -sy, sx, 0.f, S[15]},
      {0.f, sz, -sy, d, 0.f, 0.f, S[10]},
      {-sz, 0.f, sx, 0.f, d, 0.f, S[11]},
      {sy, -sx, 0.f, 0.f, 0.f, d, S[12]}};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i != p) continue;
#pragma unroll
      for (int j = k; j < 7; ++j) {
        const float tmp = A[k][j];
        A[k][j] = A[i][j];
        A[i][j] = tmp;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = __fdiv_rn(A[i][k], A[k][k]);
#pragma unroll
      for (int j = k + 1; j < 7; ++j)
        A[i][j] = __fsub_rn(A[i][j], __fmul_rn(l, A[k][j]));
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j)
      s = __fsub_rn(s, __fmul_rn(A[i][j], x[j]));
    x[i] = __fdiv_rn(s, A[i][i]);
  }
}

// Rc (row-major 3 x 3) = rz(x2) ry(x1) rx(x0): the rz ry product's rows
// (a0, a1, a2) = (cz cy, -sz, cz sy), (sz cy, cz, sz sy), (-sy, 0, cy),
// then each row times rx as (a0, a1 cx + a2 sx, a2 cx - a1 sx).
__device__ __forceinline__ void step_rotation(const float (&x)[6],
                                              float (&Rc)[9]) {
  const float cx = cosf(x[0]), sx = sinf(x[0]);
  const float cy = cosf(x[1]), sy = sinf(x[1]);
  const float cz = cosf(x[2]), sz = sinf(x[2]);
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

// Problem blockIdx.x's rows live in six arrays of ld floats at R (source
// x, y, z, target x, y, z): dynamic shared memory of L rows where M <= L,
// else the problem's [6][N] part of `spill`.
__global__ void __launch_bounds__(kThreads) irls(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const bool* __restrict__ valid, int N, int L, int iters,
    float* __restrict__ spill, float* __restrict__ trans_out) {
  extern __shared__ float stage[];          // [6][L]
  __shared__ float part[2][kSums][kWarps];
  __shared__ int ipart[kWarps];
  const int t = threadIdx.x, b = blockIdx.x;
  const int lane = t & 31, warp = t >> 5;
  float* R = stage;
  int ld = L, M = 0;
  copy_valid(
      src + 3ll * b * N, tgt + 3ll * b * N, valid + (long long)b * N, N,
      ipart,
      [&](int total) {
        M = total;
        if (M > L) {
          R = spill + 6ll * b * N;
          ld = N;
        }
      },
      [&](int m, const float* r) {
        for (int k = 0; k < 6; ++k) R[k * ld + m] = r[k];
      });
  __syncthreads();
  float *sx = R, *sy = R + ld, *sz = R + 2 * ld;
  const float *tx = R + 3 * ld, *ty = R + 4 * ld, *tz = R + 5 * ld;

  // round 0's sums: weight 1 at every valid row
  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0.f;
  for (int m = t; m < M; m += kThreads)
    row_terms(s, 1.f, sx[m], sy[m], sz[m], tx[m], ty[m], tz[m]);

  float T[12] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f,
                 0.f, 0.f, 0.f};         // R row-major, then t
  float par = 1.f;
  for (int i = 0; i < iters; ++i) {
    if (i > 0 && i % 5 == 0) par = __fmul_rn(par, 0.5f);
    // the block's sums: a warp's tree, the partials, one barrier, the
    // same tree over the partials in every warp
    warp_sums(s);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < kSums; ++k) part[i & 1][k][warp] = s[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      s[k] = lane < kWarps ? part[i & 1][k][lane] : 0.f;
    warp_sums(s);
    float x[6], Rc[9];
    solve6(s, x);
    step_rotation(x, Rc);
    // T = Tc T
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
    if (i == iters - 1) break;
    // warp the rows in place, their weights, the next round's sums
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;
    for (int m = t; m < M; m += kThreads) {
      const float px = sx[m], py = sy[m], pz = sz[m];
      const float wx = __fadd_rn(dot3(Rc, 0, px, py, pz), x[3]);
      const float wy = __fadd_rn(dot3(Rc, 1, px, py, pz), x[4]);
      const float wz = __fadd_rn(dot3(Rc, 2, px, py, pz), x[5]);
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
  }
  if (t < 16) {
    const int r = t >> 2, c = t & 3;
    const float last = c == 3 ? 1.f : 0.f;          // the row [0, 0, 0, 1]
    trans_out[(long long)b * 16 + t] =
        r == 3 ? last : (c == 3 ? T[9 + r] : T[3 * r + c]);
  }
}

}  // namespace

// K19: src / tgt [B, N, 3] f32, valid [B, N] bool -> trans_out [B, 4, 4]
// f32 after `iters` rounds. `spill`: [B, 6, N] f32 where N > kMaxRows (the
// rows of a problem that shared memory cannot hold), else may be null. One
// launch.
extern "C" int eyoc_est_quad_linear_robust(const float* src, const float* tgt,
                                           const bool* valid, int B, int N,
                                           int iters, float* spill,
                                           float* trans_out,
                                           cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N < 0 || iters < 1) return cudaErrorInvalidValue;
  const int L = N < kMaxRows ? N : kMaxRows;
  if (N > L && spill == nullptr) return cudaErrorInvalidValue;
  const int smem = 6 * L * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      irls, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  irls<<<B, kThreads, smem, stream>>>(src, tgt, valid, N, L, iters, spill,
                                      trans_out);
  return cudaGetLastError();
}
