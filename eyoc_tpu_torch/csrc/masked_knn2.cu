// Two variants of K2 (masked_argmin.cu) at feature width 32, in one source:
//
// K8 masked_knn2: the two nearest valid refs of every valid query, squared
// L2, for a batch of independent problems in one launch. Replaces
// eyoc_tpu/ops/knn.py masked_knn with k=2 (:58-65): the first minimum of
// the Gram-form distance row plus a +1e30 bias at masked refs, then that
// column set to 1e30 and the argmin again. Semantics kept: the pair is the
// top two under the (distance, index) order, so the lowest index wins a
// tie and an equal-distance ref with a higher index comes second; an
// invalid query returns (1e30, 0) in both places; a place that no valid
// ref fills reads (1e30, 0), which is what JAX returns there (every masked
// distance reads 1e30 in f32, and the lowest index at 1e30 is 0). Its
// main-path call is the labeling's mutual matching with
// feature_filter="Lowe": both directions of every pair, 2B problems of
// 16384 x 16384 x 32 at the published batch.
//
// K9 masked_argmin_excl: K2 with a spatial exclusion, for the
// hardest-negative mining with safe_radius > 0 (eyoc_tpu/training/
// loss.py:97-111): the nearest candidate feature of each anchor among the
// candidates whose coordinates lie at least r from the anchor's partner
// (squared distance >= r^2). Returns that index and its distance, or
// (1e30, 0) and a flag when every candidate was excluded (JAX's argmin over
// an all-1e9 row gives 0). The exclusion test is the direct form here, the
// Gram form (pdist2) in JAX and the plain version, so the two can differ
// where |d^2 - r^2| is within rounding; chip_smoke.py counts such tests.
//
// What bounds them: 2 Nq Nr 32 flops per problem against a few MB of
// inputs (K8: 16 x 16384^2 x 32 on the labeling path; K9: 8192 x 2048 x 32
// with 3 more coordinates per pair): operations, f32 on CUDA cores. The
// distances are direct sums of squared differences, no Gram form, no TF32.
// Design, as K2's D = 32 path:
// - a thread holds up to R = 4 queries in registers (32 features each, K9
//   also the partner's 3 coordinates) and a running top-K list per query;
//   a block stages 64 refs (eight float4 each, K9 its coordinates beside
//   them) in shared memory, so one 16-byte broadcast load feeds 4 queries;
// - only valid pairs are computed: a block compacts its tile's valid
//   queries into registers and each staged tile's valid refs into shared
//   memory, in index order (a ballot a warp); a null mask means all valid;
// - a query tile takes every qtiles-th query and a split every splits-th
//   tile of 64 refs, so that each block gets its share of the valid prefix;
// - within a split the refs arrive in increasing index order, so a strict
//   compare keeps the lowest index on ties; the splits' lists are written
//   as partials and the last block of a query tile (a ticket counter from
//   kernels.ticket, which it resets) merges them in split order under the
//   (distance, index) compare: the same bits on every call, and the same
//   answer as one sweep in index order.
// - the [Nq, Nr] matrix never exists.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 4;                  // queries a thread holds
constexpr int kTR = 64;                // refs a block stages at once
constexpr int kQ = kThreads * kR;      // queries a tile holds
constexpr int kD = 32;                 // feature width
constexpr float kBig = 1e30f;

// Slots of the valid entries among the N entries at(e), e < cnt, in order
// of e (mask == nullptr: all valid): a ballot a warp, the warps' counts
// added in order. pos[e] is the slot of entry e, or -1; returns the count.
template <int N, typename At>
__device__ __forceinline__ int compact(const uint8_t* mask, At at, int cnt,
                                       int* s_warp, int* pos) {
  constexpr int P = (N + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31;
  unsigned m[P];
  bool ok[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int e = u * kThreads + threadIdx.x;
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
    const int e = u * kThreads + threadIdx.x;
    if (e < N) {
      int base = 0;
      for (int w = 0; w < (e >> 5); ++w) base += s_warp[w];
      pos[e] = ok[u] ? base + __popc(m[u] & ((1u << lane) - 1u)) : -1;
    }
  }
  return total;
}

// The valid refs j0 .. j0 + cnt - 1 in shared memory, compacted in index
// order, with their coordinates when EXCL; stage() returns their count.
struct RefTile {
  float4 c[kTR][8];
  float4 xyz[kTR];     // (x, y, z, 0), K9 only
  int index[kTR];
  int warp_n[kTR / 32];
  int pos[kTR];

  template <bool EXCL>
  __device__ __forceinline__ int stage(const float* r, const uint8_t* rmask,
                                       const float* rxyz, int j0, int cnt) {
    const int n = compact<kTR>(
        rmask, [j0](int e) { return j0 + e; }, cnt, warp_n, pos);
    __syncthreads();   // every pos[] before the copies
    const float4* r4 = reinterpret_cast<const float4*>(r) + (size_t)j0 * 8;
    for (int e = threadIdx.x; e < cnt * 8; e += kThreads) {
      const int at = pos[e >> 3];
      if (at >= 0) c[at][e & 7] = r4[e];
    }
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const int at = pos[e];
      if (at >= 0) {
        index[at] = j0 + e;
        if constexpr (EXCL) {
          const float* p = rxyz + (size_t)(j0 + e) * 3;
          xyz[at] = make_float4(p[0], p[1], p[2], 0.f);
        }
      }
    }
    return n;
  }
};

// (da, ia) before (db, ib) in the (distance, index) order
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// a candidate into a top-K list under the (distance, index) order
template <int K>
__device__ __forceinline__ void merge_in(float d, int i, float (&bd)[K],
                                         int (&bi)[K]) {
  if (before(d, i, bd[0], bi[0])) {
    if constexpr (K == 2) {
      bd[1] = bd[0];
      bi[1] = bi[0];
    }
    bd[0] = d;
    bi[0] = i;
  } else {
    if constexpr (K == 2) {
      if (before(d, i, bd[1], bi[1])) {
        bd[1] = d;
        bi[1] = i;
      }
    }
  }
}

// the running top-K of the first RK queries a thread holds over the n
// staged refs, which come in increasing index order: a strict compare
// keeps the lowest index on ties
template <int RK, int K, bool EXCL>
__device__ __forceinline__ void sweep(const RefTile& t, int n,
                                      const float (&qv)[kR][kD],
                                      const float (&px)[kR][3], float r2,
                                      float (&bd)[kR][K], int (&bi)[kR][K]) {
#pragma unroll 1
  for (int jj = 0; jj < n; ++jj) {
    float acc[RK];
#pragma unroll
    for (int k = 0; k < RK; ++k) acc[k] = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float4 c = t.c[jj][g];
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        float d = qv[k][4 * g] - c.x;
        acc[k] = fmaf(d, d, acc[k]);
        d = qv[k][4 * g + 1] - c.y;
        acc[k] = fmaf(d, d, acc[k]);
        d = qv[k][4 * g + 2] - c.z;
        acc[k] = fmaf(d, d, acc[k]);
        d = qv[k][4 * g + 3] - c.w;
        acc[k] = fmaf(d, d, acc[k]);
      }
    }
    const int j = t.index[jj];
    float4 cx = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (EXCL) cx = t.xyz[jj];
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      if constexpr (EXCL) {
        const float dx = px[k][0] - cx.x;
        const float dy = px[k][1] - cx.y;
        const float dz = px[k][2] - cx.z;
        if (fmaf(dz, dz, fmaf(dy, dy, dx * dx)) < r2) continue;
      }
      if (acc[k] < bd[k][0]) {
        if constexpr (K == 2) {
          bd[k][1] = bd[k][0];
          bi[k][1] = bi[k][0];
        }
        bd[k][0] = acc[k];
        bi[k][0] = j;
      } else {
        if constexpr (K == 2) {
          if (acc[k] < bd[k][1]) {
            bd[k][1] = acc[k];
            bi[k][1] = j;
          }
        }
      }
    }
  }
}

template <int K, bool EXCL>
__device__ __forceinline__ void sweep_rk(int rk, const RefTile& t, int n,
                                         const float (&qv)[kR][kD],
                                         const float (&px)[kR][3], float r2,
                                         float (&bd)[kR][K],
                                         int (&bi)[kR][K]) {
  switch (rk) {
    case 1: sweep<1, K, EXCL>(t, n, qv, px, r2, bd, bi); break;
    case 2: sweep<2, K, EXCL>(t, n, qv, px, r2, bd, bi); break;
    case 3: sweep<3, K, EXCL>(t, n, qv, px, r2, bd, bi); break;
    default: sweep<4, K, EXCL>(t, n, qv, px, r2, bd, bi); break;
  }
}

// q [batch, nq, 32], r [batch, nr, 32]; K9 (EXCL) adds qxyz [batch, nq, 3]
// and rxyz [batch, nr, 3]. out_d / out_i [batch, nq, K].
template <int K, bool EXCL>
__global__ void __launch_bounds__(kThreads) knn_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ r, const uint8_t* __restrict__ rmask,
    const float* __restrict__ qxyz, const float* __restrict__ rxyz, float r2,
    int nq, int nr, float* __restrict__ part_d, int* __restrict__ part_i,
    int* __restrict__ ticket, float* __restrict__ out_d,
    int* __restrict__ out_i, uint8_t* __restrict__ out_flag) {
  __shared__ RefTile tile;
  __shared__ int s_qwarp[kQ / 32];
  __shared__ int s_qpos[kQ];
  __shared__ int s_qidx[kQ];
  __shared__ bool s_last;
  const int b = blockIdx.z, splits = gridDim.y, qtiles = gridDim.x;
  q += (size_t)b * nq * kD;
  r += (size_t)b * nr * kD;
  if (qmask != nullptr) qmask += (size_t)b * nq;
  if (rmask != nullptr) rmask += (size_t)b * nr;
  if constexpr (EXCL) {
    qxyz += (size_t)b * nq * 3;
    rxyz += (size_t)b * nr * 3;
  }
  out_d += (size_t)b * nq * K;
  out_i += (size_t)b * nq * K;
  part_d += (size_t)b * splits * nq * K;
  part_i += (size_t)b * splits * nq * K;
  // this tile's queries: x, x + qtiles, x + 2 qtiles, ...
  const int x = blockIdx.x;
  const int in_tile = nq > x ? min(kQ, (nq - x + qtiles - 1) / qtiles) : 0;

  // the valid queries, compacted: thread t holds slots t + 128 k, k < rk
  const int nv = compact<kQ>(
      qmask, [x, qtiles](int m) { return x + qtiles * m; }, in_tile,
      s_qwarp, s_qpos);
  for (int m = threadIdx.x; m < in_tile; m += kThreads)
    if (s_qpos[m] >= 0) s_qidx[s_qpos[m]] = x + qtiles * m;
  __syncthreads();
  const int rk = (nv + kThreads - 1) / kThreads;
  float qv[kR][kD];
  float px[kR][3];
  int qidx[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int slot = threadIdx.x + kThreads * k;
    qidx[k] = slot < nv ? s_qidx[slot] : -1;
    const int at = qidx[k] < 0 ? 0 : qidx[k];
    const float4* p = reinterpret_cast<const float4*>(q + (size_t)at * kD);
#pragma unroll
    for (int g = 0; g < kD / 4; ++g) {
      const float4 t = qidx[k] >= 0 ? p[g] : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[k][4 * g] = t.x;
      qv[k][4 * g + 1] = t.y;
      qv[k][4 * g + 2] = t.z;
      qv[k][4 * g + 3] = t.w;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
      px[k][d] = (EXCL && qidx[k] >= 0) ? qxyz[(size_t)at * 3 + d] : 0.f;
  }

  float bd[kR][K];
  int bi[kR][K];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[k][s] = INFINITY;
      bi[k][s] = 0;
    }
  }
  // this split's ref tiles: y, y + splits, y + 2 splits, ...
  if (rk > 0) {
    for (int j0 = blockIdx.y * kTR; j0 < nr; j0 += splits * kTR) {
      const int n =
          tile.stage<EXCL>(r, rmask, rxyz, j0, min(kTR, nr - j0));
      __syncthreads();
      sweep_rk<K, EXCL>(rk, tile, n, qv, px, r2, bd, bi);
      __syncthreads();
    }
  }

  if (splits > 1) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (qidx[k] >= 0) {
        const size_t at = ((size_t)blockIdx.y * nq + qidx[k]) * K;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          part_d[at + s] = bd[k][s];
          part_i[at + s] = bi[k][s];
        }
      }
    }
    // the last block of this query tile merges the splits, in split order
    int* tk = ticket + (size_t)b * qtiles + x;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(tk, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kR; ++k) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        bd[k][s] = INFINITY;
        bi[k][s] = 0;
      }
    }
    for (int sp = 0; sp < splits; ++sp) {
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (qidx[k] < 0) continue;
        const size_t at = ((size_t)sp * nq + qidx[k]) * K;
#pragma unroll
        for (int s = 0; s < K; ++s)
          merge_in<K>(__ldcg(part_d + at + s), __ldcg(part_i + at + s),
                      bd[k], bi[k]);
      }
    }
    if (threadIdx.x == 0) *tk = 0;
  }

  // the tile's answers: its valid queries, then (1e30, 0) for the others
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (qidx[k] >= 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const bool found = bd[k][s] < INFINITY;
        out_d[(size_t)qidx[k] * K + s] = found ? bd[k][s] : kBig;
        out_i[(size_t)qidx[k] * K + s] = found ? bi[k][s] : 0;
      }
      if constexpr (EXCL) out_flag[qidx[k]] = bd[k][0] < INFINITY ? 0 : 1;
    }
  }
  for (int m = threadIdx.x; m < in_tile; m += kThreads) {
    if (s_qpos[m] < 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_d[(size_t)(x + qtiles * m) * K + s] = kBig;
        out_i[(size_t)(x + qtiles * m) * K + s] = 0;
      }
      if constexpr (EXCL) out_flag[x + qtiles * m] = 1;
    }
  }
}

template <int K, bool EXCL>
int launch(const void* q, const void* qmask, const void* r, const void* rmask,
           const void* qxyz, const void* rxyz, float r2, int batch, int nq,
           int nr, int splits, void* part, void* ticket, void* out_d,
           void* out_i, void* out_flag, cudaStream_t s) {
  if (batch <= 0 || nq <= 0) return 0;
  if (splits < 1 || nr < 0 || batch > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)r) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int qtiles = (nq + kQ - 1) / kQ;
  const size_t np = (size_t)batch * splits * nq * K;
  dim3 grid(qtiles, splits, batch);
  knn_kernel<K, EXCL><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(qmask),
      static_cast<const float*>(r), static_cast<const uint8_t*>(rmask),
      static_cast<const float*>(qxyz), static_cast<const float*>(rxyz), r2,
      nq, nr, static_cast<float*>(part), static_cast<int*>(part) + np,
      static_cast<int*>(ticket), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<uint8_t*>(out_flag));
  return (int)cudaGetLastError();
}

template <int K, bool EXCL>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, knn_kernel<K, EXCL>, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// blocks of K8 (excl = 0) or K9 (excl = 1) that the current device holds at
// once (occupancy x SMs), for the caller's choice of splits; 0 on an error
extern "C" int eyoc_masked_knn2_resident(int excl) {
  return excl ? resident_blocks<1, true>() : resident_blocks<2, false>();
}

// K8. q [batch, nq, 32], r [batch, nr, 32] f32, 16-byte aligned; masks
// bool [batch, nq] / [batch, nr]. part: 4 * batch * splits * nq words of
// scratch (the split lists' distances, then their indices; unused when
// splits == 1); ticket: batch * ceil(nq / 512) ints, zero between calls
// (the kernel leaves them at zero); splits from ops/knn.py:k2_plan.
// out_d [batch, nq, 2] f32, out_i [batch, nq, 2] int32.
extern "C" int eyoc_masked_knn2(const void* q, const void* qmask,
                                const void* r, const void* rmask, int batch,
                                int nq, int nr, int splits, void* part,
                                void* ticket, void* out_d, void* out_i,
                                void* stream) {
  return launch<2, false>(q, qmask, r, rmask, nullptr, nullptr, 0.f, batch,
                          nq, nr, splits, part, ticket, out_d, out_i, nullptr,
                          static_cast<cudaStream_t>(stream));
}

// K9. anchors q [nq, 32] with partner coordinates qxyz [nq, 3], candidates
// r [nr, 32] with coordinates rxyz [nr, 3], f32, every row valid; r2 the
// squared exclusion radius. part: 2 * splits * nq words; ticket as K8.
// out_d [nq] f32 (the squared feature distance, or 1e30 when every
// candidate was excluded), out_i [nq] int32 (0 then), out_flag [nq] bool
// (every candidate was excluded).
extern "C" int eyoc_masked_argmin_excl(const void* q, const void* r,
                                       const void* qxyz, const void* rxyz,
                                       float r2, int nq, int nr, int splits,
                                       void* part, void* ticket, void* out_d,
                                       void* out_i, void* out_flag,
                                       void* stream) {
  return launch<1, true>(q, nullptr, r, nullptr, qxyz, rxyz, r2, 1, nq, nr,
                         splits, part, ticket, out_d, out_i, out_flag,
                         static_cast<cudaStream_t>(stream));
}
