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
// independent, so the design is the plain one: a grid-stride loop in
// which neighbouring threads copy neighbouring 16-byte words of a row
// (8-, 4- or 2-byte words when the row width or the pointers do not allow
// 16), so that a warp reads whole 128-byte lines of each gathered row.
// Any row width and element type of 2 or more bytes is taken.
// The backward adds with f32 atomics: the loss samples with replacement,
// so several output rows can hit one source row. The order of those adds
// is not fixed, so the result can differ from run to run in the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132 * 16;

template <typename U>
__global__ void __launch_bounds__(kThreads) gather_rows(
    const U* __restrict__ src, int n_src, const int* __restrict__ idx,
    int n_out, int units, U* __restrict__ out) {
  const long total = (long)n_out * units;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int i = (int)(e / units);
    const int u = (int)(e - (long)i * units);
    const int r = __ldg(idx + i);
    out[e] = (r >= 0 && r < n_src) ? src[(size_t)r * units + u] : U{};
  }
}

__global__ void __launch_bounds__(kThreads) scatter_add_rows(
    const float* __restrict__ dout, const int* __restrict__ idx, int n_out,
    int cols, int n_src, float* __restrict__ dsrc) {
  const long total = (long)n_out * cols;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int i = (int)(e / cols);
    const int c = (int)(e - (long)i * cols);
    const int r = __ldg(idx + i);
    if (r >= 0 && r < n_src) atomicAdd(dsrc + (size_t)r * cols + c, dout[e]);
  }
}

unsigned grid_for(long total) {
  const long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                        : kMaxBlocks);
}

template <typename U>
void launch_gather(const void* src, int n_src, const int* idx, int n_out,
                   int row_bytes, void* out, cudaStream_t s) {
  const int units = row_bytes / (int)sizeof(U);
  gather_rows<U><<<grid_for((long)n_out * units), kThreads, 0, s>>>(
      static_cast<const U*>(src), n_src, idx, n_out, units,
      static_cast<U*>(out));
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

// dout [n_out, cols] f32, idx [n_out] int32; dsrc [n_src, cols] f32 must
// hold zeros (or the sum to add to).
extern "C" int eyoc_take_rows_backward(const void* dout, const void* idx,
                                       int n_out, int cols, int n_src,
                                       void* dsrc, void* stream) {
  if (n_out <= 0 || cols <= 0) return 0;
  scatter_add_rows<<<grid_for((long)n_out * cols), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const int*>(idx), n_out,
      cols, n_src, static_cast<float*>(dsrc));
  return (int)cudaGetLastError();
}
