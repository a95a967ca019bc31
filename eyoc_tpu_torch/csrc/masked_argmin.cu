// K2 masked_argmin: masked brute-force 1-nearest neighbour, squared L2.
//
// Replaces eyoc_tpu/ops/knn.py masked_argmin (:79) / masked_knn with k=1,
// which tiles the [Nq, Nr] distance matrix through a Gram-form matmul and
// an argmin per tile. Semantics kept: a ref that is masked out costs
// +1e30 (so it only wins when every ref is masked), ties go to the lowest
// ref index, and an invalid query returns (1e30, 0).
//
// What bounds it: 2*Nq*Nr*D flops (5000 x 5000 x 32 on the main path,
// 1.6 GFLOP) against 1.3 MB of inputs: operations, f32 on CUDA cores.
// Design: one thread per query keeps its row in registers and a running
// (min, argmin); a block stages 64 reference rows at a time in shared
// memory, read as broadcasts. The distance is the direct sum of squared
// differences (no Gram cancellation). The [Nq, Nr] matrix never exists.
// The references are split over gridDim.y so that ~5000 queries still fill
// the card; a second kernel reduces the per-split partials in split order,
// which keeps the lowest index on ties.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileR = 64;
constexpr float kBig = 1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads) argmin_partial(
    const float* __restrict__ q, int nq, const float* __restrict__ r,
    const uint8_t* __restrict__ rmask, int nr, int chunk,
    float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float rs[kTileR][D];
  __shared__ float rb[kTileR];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int start = blockIdx.y * chunk;
  const int end = min(nr, start + chunk);

  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = (qi < nq) ? q[(size_t)qi * D + d] : 0.f;

  float best = INFINITY;
  int best_i = 0;
  for (int j0 = start; j0 < end; j0 += kTileR) {
    const int nt = min(kTileR, end - j0);
    for (int e = threadIdx.x; e < nt * D; e += kThreads)
      rs[e / D][e % D] = r[(size_t)j0 * D + e];
    for (int e = threadIdx.x; e < nt; e += kThreads)
      rb[e] = rmask[j0 + e] ? 0.f : kBig;
    __syncthreads();
    for (int jj = 0; jj < nt; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float diff = qv[d] - rs[jj][d];
        s = fmaf(diff, diff, s);
      }
      const float key = s + rb[jj];
      if (key < best) {
        best = key;
        best_i = j0 + jj;
      }
    }
    __syncthreads();
  }
  if (qi < nq) {
    part_d[(size_t)blockIdx.y * nq + qi] = best;
    part_i[(size_t)blockIdx.y * nq + qi] = best_i;
  }
}

__global__ void argmin_reduce(const float* __restrict__ part_d,
                              const int* __restrict__ part_i, int splits,
                              const uint8_t* __restrict__ qmask, int nq,
                              float* __restrict__ out_d,
                              int* __restrict__ out_i) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float best = part_d[qi];
  int best_i = part_i[qi];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(size_t)s * nq + qi];
    if (d < best) {
      best = d;
      best_i = part_i[(size_t)s * nq + qi];
    }
  }
  const bool ok = qmask[qi] != 0;
  out_d[qi] = ok ? best : kBig;
  out_i[qi] = ok ? best_i : 0;
}

}  // namespace

// part_d / part_i are [splits, nq] scratch; splits >= 1 is chosen by the
// caller (ops/knn.py:_splits).
extern "C" int eyoc_masked_argmin(const void* q, const void* qmask, int nq,
                                  const void* r, const void* rmask, int nr,
                                  int dim, int splits, void* part_d,
                                  void* part_i, void* out_d, void* out_i,
                                  void* stream) {
  if (nq <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int chunk = (nr + splits - 1) / splits;
  dim3 grid((nq + kThreads - 1) / kThreads, splits);
  auto* pq = static_cast<const float*>(q);
  auto* pr = static_cast<const float*>(r);
  auto* prm = static_cast<const uint8_t*>(rmask);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  switch (dim) {
    case 3:
      argmin_partial<3><<<grid, kThreads, 0, s>>>(pq, nq, pr, prm, nr, chunk,
                                                  pd, pi);
      break;
    case 32:
      argmin_partial<32><<<grid, kThreads, 0, s>>>(pq, nq, pr, prm, nr, chunk,
                                                   pd, pi);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  argmin_reduce<<<(nq + 255) / 256, 256, 0, s>>>(
      pd, pi, splits, static_cast<const uint8_t*>(qmask), nq,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
