// K2 masked_argmin: masked brute-force 1-nearest neighbour, squared L2, for
// a batch of independent (query set, reference set) problems in one launch.
//
// Replaces eyoc_tpu/ops/knn.py masked_argmin (:79) / masked_knn with k=1,
// which tiles the [Nq, Nr] distance matrix through a Gram-form matmul and
// an argmin per tile, and its vmap over the batch in
// eyoc_tpu/training/pipeline.py gt_positive_pairs (:110-119). Semantics
// kept: a ref that is masked out costs +1e30 (so it only wins when every
// ref is masked), ties go to the lowest ref index, and an invalid query
// returns (1e30, 0).
//
// What bounds it: 2*Nq*Nr*D flops per problem (5000 x 5000 x 32 on the
// eval path, 8 x 16384 x 16384 x 3 for the GT pairs of a train step)
// against a few MB of inputs: operations, f32 on CUDA cores. The distance
// is the direct sum of squared differences, no Gram form and no TF32: the
// coordinates reach 76 m, where the Gram form's cancellation is ~1e-3 m^2
// against GT validity at d^2 < 0.45^2.
// Design:
// - Register blocking: a thread holds up to R queries (R = 8 at D = 3, 4
//   at D = 32) and a running (min, argmin) for each. A block stages a tile
//   of references in shared memory as float4: (x, y, z, index) at D = 3,
//   eight float4 and the index beside them at D = 32. One 16-byte broadcast
//   load feeds every query a thread holds.
// - Other widths: the caller pads the features with zero columns to the
//   next of 3, 32, 64, 128 and 256 (ops/knn.py:k2_width), which adds an
//   exact +0 to every distance. The wider instances are the D = 32 code
//   with D / 4 float4 a staged ref, R = 2 at D = 64 and 1 above (the
//   queries a thread holds stay at 128 floats up to D = 128), and tiles
//   of 32 refs.
// - Only valid pairs are computed. A masked ref costs +1e30, so it can
//   only win when no ref is valid, and then the answer is the first ref at
//   1e30 (plain version and JAX alike): the kernel writes (1e30, 0) for a
//   query that found no valid ref, and for an invalid query. So a block
//   compacts the valid queries of its tile into its threads' registers and
//   the valid refs of each staged tile into shared memory, both in index
//   order (a ballot a warp, the warps' counts added in order), and runs
//   the sweep for as many queries a thread as it holds.
// - The valid voxels of a cloud are a prefix of its rows, so contiguous
//   tiles would give some blocks all the valid pairs and others none. A
//   query tile takes every qtiles-th query and a split every splits-th tile
//   of 256 (D = 3) or 64 (D = 32) refs, so each block gets its share.
// - The references are split over gridDim.y so that a few thousand queries
//   still fill the card, as many splits as let every block be resident at
//   once (one wave); the batch is gridDim.z.
// - One launch per call: each block writes its split's (min, argmin)
//   partials, and the last block of a query tile to finish (a ticket
//   counter per tile, from kernels.ticket, which the block resets) reduces
//   the splits in split order, taking a split's pair when its distance is
//   smaller or equal with a smaller index, which keeps the lowest index on
//   ties. No float atomics: the same bits on every call.
// - The [Nq, Nr] matrix never exists.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 1e30f;

// queries a thread holds at most (R) and refs a block stages at once (TR)
template <int D>
struct Shape;
template <>
struct Shape<3> {
  static constexpr int R = 8, TR = 256;
};
template <>
struct Shape<32> {
  static constexpr int R = 4, TR = 64;
};
template <>
struct Shape<64> {
  static constexpr int R = 2, TR = 32;
};
template <>
struct Shape<128> {
  static constexpr int R = 1, TR = 32;
};
template <>
struct Shape<256> {
  static constexpr int R = 1, TR = 32;
};

// Slots of the valid entries among the N entries mask[at(e)], e < cnt, in
// order of e: a ballot a warp of 32 entries, the warps' counts added in
// order. pos[e] is the slot of entry e, or -1; returns the count.
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
    ok[u] = e < cnt && mask[at(e)] != 0;
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
// order; stage() returns their count, which D = 3 pads to a multiple of 4
// with refs at infinity (they never win).
template <int D, int TR>
struct RefTile;

template <int TR>
struct RefTile<3, TR> {
  float4 c[TR];   // (x, y, z, index)
  int warp_n[TR / 32];
  int pos[TR];
  __device__ __forceinline__ int stage(const float* r, const uint8_t* rmask,
                                       int j0, int cnt) {
    const int n = compact<TR>(
        rmask, [j0](int e) { return j0 + e; }, cnt, warp_n, pos);
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      if (pos[e] >= 0) {   // this thread's own pos[e]
        const float* p = r + (size_t)(j0 + e) * 3;
        c[pos[e]] = make_float4(p[0], p[1], p[2], __int_as_float(j0 + e));
      }
    }
    for (int e = n + threadIdx.x; e < ((n + 3) & ~3); e += kThreads)
      c[e] = make_float4(INFINITY, 0.f, 0.f, __int_as_float(0));
    return n;
  }
};

// D a multiple of 32: G = D / 4 float4 a ref
template <int D, int TR>
struct RefTile {
  static constexpr int G = D / 4;
  float4 c[TR][G];
  int index[TR];
  int warp_n[TR / 32];
  int pos[TR];
  __device__ __forceinline__ int stage(const float* r, const uint8_t* rmask,
                                       int j0, int cnt) {
    const int n = compact<TR>(
        rmask, [j0](int e) { return j0 + e; }, cnt, warp_n, pos);
    __syncthreads();   // every pos[] before the copies
    const float4* r4 = reinterpret_cast<const float4*>(r) + (size_t)j0 * G;
    for (int e = threadIdx.x; e < cnt * G; e += kThreads) {
      const int at = pos[e / G];
      if (at >= 0) c[at][e % G] = r4[e];
    }
    for (int e = threadIdx.x; e < cnt; e += kThreads)
      if (pos[e] >= 0) index[pos[e]] = j0 + e;
    return n;
  }
};

// the running (min, argmin) of the first RK queries a thread holds over the
// n staged refs (rounded up to 4 at D = 3: the pads never win)
template <int RK, int R>
__device__ __forceinline__ void sweep(const RefTile<3, 256>& t, int n,
                                      const float (&qv)[R][3],
                                      float (&best)[R], int (&bi)[R]) {
  for (int j4 = 0; j4 < n; j4 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 c = t.c[j4 + u];
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        const float dx = qv[k][0] - c.x;
        const float dy = qv[k][1] - c.y;
        const float dz = qv[k][2] - c.z;
        const float key = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        if (key < best[k]) {
          best[k] = key;
          bi[k] = __float_as_int(c.w);
        }
      }
    }
  }
}

template <int RK, int R, int D, int TR>
__device__ __forceinline__ void sweep(const RefTile<D, TR>& t, int n,
                                      const float (&qv)[R][D],
                                      float (&best)[R], int (&bi)[R]) {
#pragma unroll 1
  for (int jj = 0; jj < n; ++jj) {
    float acc[RK];
#pragma unroll
    for (int k = 0; k < RK; ++k) acc[k] = 0.f;
#pragma unroll
    for (int g = 0; g < D / 4; ++g) {
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
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      if (acc[k] < best[k]) {
        best[k] = acc[k];
        bi[k] = j;
      }
    }
  }
}

// the sweep for the rk (<= R, the same in the whole block) queries that
// each thread holds
template <int D, int R, typename Tile>
__device__ __forceinline__ void sweep_rk(int rk, const Tile& t, int n,
                                         const float (&qv)[R][D],
                                         float (&best)[R], int (&bi)[R]) {
  if constexpr (R < 4) {              // the wider instances: R = 1, 2
    if (rk == 1)
      sweep<1>(t, n, qv, best, bi);
    else
      sweep<R>(t, n, qv, best, bi);
  } else {
    switch (rk) {
      case 1: sweep<1>(t, n, qv, best, bi); break;
      case 2: sweep<2>(t, n, qv, best, bi); break;
      case 3: sweep<3>(t, n, qv, best, bi); break;
      case 4: sweep<4>(t, n, qv, best, bi); break;
      default:
        if constexpr (R > 4) {
          switch (rk) {
            case 5: sweep<5>(t, n, qv, best, bi); break;
            case 6: sweep<6>(t, n, qv, best, bi); break;
            case 7: sweep<7>(t, n, qv, best, bi); break;
            default: sweep<R>(t, n, qv, best, bi); break;
          }
        }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) argmin_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ r, const uint8_t* __restrict__ rmask, int nq,
    int nr, float* __restrict__ part_d, int* __restrict__ part_i,
    int* __restrict__ ticket, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  constexpr int R = Shape<D>::R, TR = Shape<D>::TR, Q = kThreads * R;
  __shared__ RefTile<D, TR> tile;
  __shared__ int s_qwarp[Q / 32];
  __shared__ int s_qpos[Q];
  __shared__ int s_qidx[Q];
  __shared__ bool s_last;
  const int b = blockIdx.z, splits = gridDim.y, qtiles = gridDim.x;
  q += (size_t)b * nq * D;
  qmask += (size_t)b * nq;
  r += (size_t)b * nr * D;
  rmask += (size_t)b * nr;
  out_d += (size_t)b * nq;
  out_i += (size_t)b * nq;
  part_d += (size_t)b * splits * nq;
  part_i += (size_t)b * splits * nq;
  // this tile's queries: x, x + qtiles, x + 2 qtiles, ... (m < Q of them)
  const int x = blockIdx.x;
  const int in_tile = nq > x ? min(Q, (nq - x + qtiles - 1) / qtiles) : 0;

  // the valid queries, compacted: thread t holds slots t + 128 k, k < rk
  const int nv = compact<Q>(
      qmask, [x, qtiles](int m) { return x + qtiles * m; }, in_tile,
      s_qwarp, s_qpos);
  for (int m = threadIdx.x; m < in_tile; m += kThreads)
    if (s_qpos[m] >= 0) s_qidx[s_qpos[m]] = x + qtiles * m;
  __syncthreads();
  const int rk = (nv + kThreads - 1) / kThreads;
  float qv[R][D];
  int qidx[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int slot = threadIdx.x + kThreads * k;
    qidx[k] = slot < nv ? s_qidx[slot] : -1;
    const float* p = q + (size_t)(qidx[k] < 0 ? 0 : qidx[k]) * D;
    if constexpr (D % 4 == 0) {
#pragma unroll
      for (int g = 0; g < D / 4; ++g) {
        const float4 t = qidx[k] >= 0 ? reinterpret_cast<const float4*>(p)[g]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[k][4 * g] = t.x;
        qv[k][4 * g + 1] = t.y;
        qv[k][4 * g + 2] = t.z;
        qv[k][4 * g + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) qv[k][d] = qidx[k] >= 0 ? p[d] : 0.f;
    }
  }

  float best[R];
  int bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    best[k] = INFINITY;
    bi[k] = 0;
  }
  // this split's ref tiles: y, y + splits, y + 2 splits, ...
  if (rk > 0) {
    for (int j0 = blockIdx.y * TR; j0 < nr; j0 += splits * TR) {
      const int n = tile.stage(r, rmask, j0, min(TR, nr - j0));
      __syncthreads();
      sweep_rk<D, R>(rk, tile, n, qv, best, bi);
      __syncthreads();
    }
  }

  if (splits > 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (qidx[k] >= 0) {
        part_d[(size_t)blockIdx.y * nq + qidx[k]] = best[k];
        part_i[(size_t)blockIdx.y * nq + qidx[k]] = bi[k];
      }
    }
    // the last block of this query tile reduces the splits
    int* tk = ticket + (size_t)b * qtiles + x;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(tk, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      best[k] = INFINITY;
      bi[k] = 0;
    }
    constexpr int S = 16 / R;   // splits whose partials load at once
    for (int s0 = 0; s0 < splits; s0 += S) {
      float d[S][R];
      int ix[S][R];
#pragma unroll
      for (int u = 0; u < S; ++u) {   // every load of a batch first
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int s = s0 + u < splits ? s0 + u : s0;
          const size_t at = (size_t)s * nq + (qidx[k] < 0 ? 0 : qidx[k]);
          d[u][k] = __ldcg(part_d + at);
          ix[u][k] = __ldcg(part_i + at);
        }
      }
#pragma unroll
      for (int u = 0; u < S; ++u) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (s0 + u < splits &&
              (d[u][k] < best[k] ||
               (d[u][k] == best[k] && ix[u][k] < bi[k]))) {
            best[k] = d[u][k];
            bi[k] = ix[u][k];
          }
        }
      }
    }
    if (threadIdx.x == 0) *tk = 0;
  }

  // the tile's answers: its valid queries, then (1e30, 0) for the others
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (qidx[k] >= 0) {
      const bool found = best[k] < INFINITY;
      out_d[qidx[k]] = found ? best[k] : kBig;
      out_i[qidx[k]] = found ? bi[k] : 0;
    }
  }
  for (int m = threadIdx.x; m < in_tile; m += kThreads) {
    if (s_qpos[m] < 0) {
      out_d[x + qtiles * m] = kBig;
      out_i[x + qtiles * m] = 0;
    }
  }
}

template <int D>
int launch(const void* q, const void* qmask, const void* r, const void* rmask,
           int batch, int nq, int nr, int splits, void* part, void* ticket,
           void* out_d, void* out_i, cudaStream_t s) {
  constexpr int Q = kThreads * Shape<D>::R;
  const int qtiles = (nq + Q - 1) / Q;
  const size_t np = (size_t)batch * splits * nq;
  dim3 grid(qtiles, splits, batch);
  argmin_kernel<D><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(qmask),
      static_cast<const float*>(r), static_cast<const uint8_t*>(rmask), nq,
      nr, static_cast<float*>(part), static_cast<int*>(part) + np,
      static_cast<int*>(ticket), static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

template <int D>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, argmin_kernel<D>, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// blocks of the dim's kernel that the current device holds at once
// (occupancy x SMs), for the caller's choice of splits; 0 on an error
extern "C" int eyoc_masked_argmin_resident(int dim) {
  switch (dim) {
    case 3: return resident_blocks<3>();
    case 32: return resident_blocks<32>();
    case 64: return resident_blocks<64>();
    case 128: return resident_blocks<128>();
    case 256: return resident_blocks<256>();
    default: return 0;
  }
}

// q [batch, nq, dim], r [batch, nr, dim] f32 (16-byte aligned at dim >=
// 32), masks bool; dim 3, 32, 64, 128 or 256. part: 2 * batch * splits * nq words of scratch
// (the split minima, then their indices; unused when splits == 1);
// ticket: batch * ceil(nq / (128 R)) ints, zero between calls (the kernel
// leaves them at zero); splits >= 1 is chosen by the caller (ops/knn.py:
// k2_plan). out_d [batch, nq] f32, out_i [batch, nq] int32.
extern "C" int eyoc_masked_argmin(const void* q, const void* qmask,
                                  const void* r, const void* rmask, int batch,
                                  int nq, int nr, int dim, int splits,
                                  void* part, void* ticket, void* out_d,
                                  void* out_i, void* stream) {
  if (batch <= 0 || nq <= 0) return 0;
  if (splits < 1 || nr < 0 || batch > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 3:
      return launch<3>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                       ticket, out_d, out_i, s);
    case 32:
    case 64:
    case 128:
    case 256:
      if (((uintptr_t)q | (uintptr_t)r) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      if (dim == 32)
        return launch<32>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                          ticket, out_d, out_i, s);
      if (dim == 64)
        return launch<64>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                          ticket, out_d, out_i, s);
      if (dim == 128)
        return launch<128>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                           ticket, out_d, out_i, s);
      return launch<256>(q, qmask, r, rmask, batch, nq, nr, splits, part,
                         ticket, out_d, out_i, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
