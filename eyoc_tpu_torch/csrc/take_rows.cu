// K6 take_rows: row gather with a zero sentinel, and its backward.
//
// Replaces the row gather that the TPU probes under proto/ compute with
// pl.pallas_call (proto_pallas_gather.py:62-156 pallas_rowloop,
// pallas_rowloop_vmem, pallas_rowloop8, pallas_rowloop_tiled, pallas_take2;
// proto_pallas_gather2.py:57-108 pallas_ds, pallas_dma, pallas_taa;
// proto_pallas_bisect.py:30-89), i.e. the halo gather _take_pad0
// (eyoc_tpu/sparse/brick_conv.py:89-92) and jnp.take(F, idx, axis=0) in the
// loss (eyoc_tpu/training/loss.py:85-95):
//
//   forward   out[i, :] = src[idx[i], :]   (idx outside [0, N) -> zero row)
//   backward  dsrc[idx[i], :] += dout[i, :] (f32 in and out; duplicates
//             accumulate)
//
// What bounds it: bytes. The gather moves each output row once and each
// gathered source row once; it has no arithmetic. On the TPU the probes
// fought a sequential grid and VMEM indexing; here every row is
// independent. Design: each row goes to a group of 2^lg neighbouring
// threads (the smallest power of two that covers the row's 16-byte words,
// at most a warp), which read its index once and copy neighbouring 16-byte
// words (8-, 4- or 2-byte words when the row width or the pointers do not
// allow 16), so a warp reads whole 128-byte lines of the gathered rows.
// A thread finds its row and word by shifts, with no division, and the
// grid has one group per row. Any row width and element type of 2 or more
// bytes is taken.
// The backward adds with Hopper's vector float atomics (atomicAdd on
// float4 or float2, sm_90) where the width and alignment allow, else
// scalar ones: the loss samples with replacement, so several output rows
// can hit one source row. The order of those adds is not fixed, so the
// result can differ from run to run in the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// threads per row: the least power of two >= units, at most 32
int row_lanes_log2(int units) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < units) ++lg;
  return lg;
}

unsigned grid_for(int n_rows, int lg) {
  const long per_block = kThreads >> lg;
  return (unsigned)((n_rows + per_block - 1) / per_block);
}

template <typename U>
__global__ void __launch_bounds__(kThreads) gather_rows(
    const U* __restrict__ src, int n_src, const int* __restrict__ idx,
    int n_out, int units, int lg, U* __restrict__ out) {
  const int i = (int)blockIdx.x * (kThreads >> lg) + (threadIdx.x >> lg);
  if (i >= n_out) return;
  const int r = __ldg(idx + i);
  const bool ok = r >= 0 && r < n_src;
  const U* s = src + (size_t)(ok ? r : 0) * units;
  U* d = out + (size_t)i * units;
  for (int u = threadIdx.x & ((1 << lg) - 1); u < units; u += 1 << lg)
    d[u] = ok ? __ldg(s + u) : U{};
}

template <int V>
__global__ void __launch_bounds__(kThreads) scatter_add_rows(
    const float* __restrict__ dout, const int* __restrict__ idx, int n_out,
    int cols, int n_src, int lg, float* __restrict__ dsrc) {
  const int i = (int)blockIdx.x * (kThreads >> lg) + (threadIdx.x >> lg);
  if (i >= n_out) return;
  const int r = __ldg(idx + i);
  if (r < 0 || r >= n_src) return;
  const float* s = dout + (size_t)i * cols;
  float* d = dsrc + (size_t)r * cols;
  const int units = cols / V;
  for (int u = threadIdx.x & ((1 << lg) - 1); u < units; u += 1 << lg) {
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(d) + u,
                __ldg(reinterpret_cast<const float4*>(s) + u));
    } else if constexpr (V == 2) {
      atomicAdd(reinterpret_cast<float2*>(d) + u,
                __ldg(reinterpret_cast<const float2*>(s) + u));
    } else {
      atomicAdd(d + u, __ldg(s + u));
    }
  }
}

template <typename U>
void launch_gather(const void* src, int n_src, const int* idx, int n_out,
                   int row_bytes, void* out, cudaStream_t s) {
  const int units = row_bytes / (int)sizeof(U);
  const int lg = row_lanes_log2(units);
  gather_rows<U><<<grid_for(n_out, lg), kThreads, 0, s>>>(
      static_cast<const U*>(src), n_src, idx, n_out, units, lg,
      static_cast<U*>(out));
}

template <int V>
void launch_scatter(const float* dout, const int* idx, int n_out, int cols,
                    int n_src, float* dsrc, cudaStream_t s) {
  const int lg = row_lanes_log2(cols / V);
  scatter_add_rows<V><<<grid_for(n_out, lg), kThreads, 0, s>>>(
      dout, idx, n_out, cols, n_src, lg, dsrc);
}

}  // namespace

// src [n_src, row_bytes] and out [n_out, row_bytes] as raw bytes; idx
// [n_out] int32. row_bytes must be even.
extern "C" int eyoc_take_rows(const void* src, int n_src, const void* idx,
                              int n_out, int row_bytes, void* out,
                              void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return 0;
  if (row_bytes % 2 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* pidx = static_cast<const int*>(idx);
  const uintptr_t align = (uintptr_t)src | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    launch_gather<uint4>(src, n_src, pidx, n_out, row_bytes, out, s);
  else if (row_bytes % 8 == 0 && align % 8 == 0)
    launch_gather<uint2>(src, n_src, pidx, n_out, row_bytes, out, s);
  else if (row_bytes % 4 == 0 && align % 4 == 0)
    launch_gather<uint32_t>(src, n_src, pidx, n_out, row_bytes, out, s);
  else
    launch_gather<uint16_t>(src, n_src, pidx, n_out, row_bytes, out, s);
  return (int)cudaGetLastError();
}

// dout [n_out, cols] f32, idx [n_out] int32; dsrc [n_src, cols] f32 is
// set to zeros here (one memset on the stream, cheaper on the host than a
// separate zeros call), then takes the sums.
extern "C" int eyoc_take_rows_backward(const void* dout, const void* idx,
                                       int n_out, int cols, int n_src,
                                       void* dsrc, void* stream) {
  if (n_src <= 0 || cols <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(dsrc, 0, (size_t)n_src * cols * sizeof(float), s);
  if (err != cudaSuccess || n_out <= 0) return (int)err;
  auto* pd = static_cast<const float*>(dout);
  auto* pidx = static_cast<const int*>(idx);
  auto* ps = static_cast<float*>(dsrc);
  const uintptr_t align = (uintptr_t)dout | (uintptr_t)dsrc;
  if (cols % 4 == 0 && align % 16 == 0)
    launch_scatter<4>(pd, pidx, n_out, cols, n_src, ps, s);
  else if (cols % 2 == 0 && align % 8 == 0)
    launch_scatter<2>(pd, pidx, n_out, cols, n_src, ps, s);
  else
    launch_scatter<1>(pd, pidx, n_out, cols, n_src, ps, s);
  return (int)cudaGetLastError();
}
