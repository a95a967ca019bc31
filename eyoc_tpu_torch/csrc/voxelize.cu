// K10 voxelize: quantize, Morton-encode, sort and compact B clouds at once.
//
// Replaces eyoc_tpu/sparse/voxelize.py:24 `voxelize` (its (key, idx) sort
// at :43, the compaction sort at :62) and the Morton encode it calls
// (eyoc_tpu/sparse/morton.py:71), vmapped over the clouds of a batch by
// eyoc_tpu/training/pipeline.py:70-78:
//
//   coords = floor(xyz / voxel)          (IEEE f32 division, as torch)
//   key    = Morton(coords + shift) or INVALID (masked, out of window)
//   sort by (key, point index); the first point of each key is the voxel;
//   the first `cap` voxels of a cloud, in key order, and their count.
//
// Two launches around one torch.sort of the B*P int64 keys:
// - voxel_keys, one thread a point, packs (cloud << (31 + pbits)) |
//   (key << pbits) | point: the keys are distinct, so one unstable sort
//   orders every cloud by (key, index), as the JAX sort does;
// - voxel_compact, one block a cloud, walks the cloud's sorted keys in
//   tiles: first-occurrence flags, an exclusive scan of their counts, and
//   each first point written at its rank (below cap) with its xyz, coords,
//   point index and level-0 Morton key; the rows past the count are pads.
//
// What bounds it: bytes (the points once, the keys three times through the
// sort, the voxels once); the compaction walks a cloud in one block, which
// is enough while a call holds 1 or 8 clouds. No --use_fast_math: an
// approximate quotient moves a point that lies on a voxel face into the
// next voxel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalid = 0x7FFFFFFF;
constexpr int kKeyThreads = 256;
constexpr int kThreads = 1024;     // voxel_compact: one block a cloud
constexpr int kItems = 8;          // sorted keys a thread takes per tile

__device__ __forceinline__ int spread3(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ int compact3(int v) {
  v &= 0x09249249;
  v = (v | (v >> 2)) & 0x030C30C3;
  v = (v | (v >> 4)) & 0x0300F00F;
  v = (v | (v >> 8)) & 0x030000FF;
  v = (v | (v >> 16)) & 0x3FF;
  return v;
}

// Exclusive prefix sum of v over the block (blockDim.x == kThreads) in
// shared memory; `total` gets the block's sum.
__device__ int block_exclusive_scan(int v, int* sh, int& total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += add;
    __syncthreads();
  }
  total = sh[kThreads - 1];
  const int incl = sh[t];
  __syncthreads();
  return incl - v;
}

// Point p of cloud b is valid where p < counts[b].
__global__ void __launch_bounds__(kKeyThreads) voxel_keys(
    const float* __restrict__ xyz, const int* __restrict__ counts, int B,
    int P, float voxel, int bx, int by, int bz, int pbits,
    long long* __restrict__ keys) {
  const long long e = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  if (e >= (long long)B * P) return;
  const int b = (int)(e / P);
  const int p = (int)(e - (long long)b * P);
  int key = kInvalid;
  if (p < __ldg(counts + b)) {
    const int hx = 1 << (bx - 1), hy = 1 << (by - 1), hz = 1 << (bz - 1);
    const int cx = (int)floorf(__fdiv_rn(__ldg(xyz + 3 * e), voxel));
    const int cy = (int)floorf(__fdiv_rn(__ldg(xyz + 3 * e + 1), voxel));
    const int cz = (int)floorf(__fdiv_rn(__ldg(xyz + 3 * e + 2), voxel));
    // the window [-g/2, g/2) of morton.in_window, tested before the shift
    if (cx >= -hx && cx < hx && cy >= -hy && cy < hy && cz >= -hz &&
        cz < hz)
      key = (spread3(cx + hx) << 2) | (spread3(cy + hy) << 1) |
            spread3(cz + hz);
  }
  keys[e] = ((long long)b << (31 + pbits)) | ((long long)key << pbits) | p;
}

__global__ void __launch_bounds__(kThreads) voxel_compact(
    const long long* __restrict__ sorted, const float* __restrict__ xyz,
    int P, int cap, int pbits, int sx, int sy, int sz,
    int* __restrict__ coords,
    float* __restrict__ out_xyz, bool* __restrict__ out_mask,
    int* __restrict__ count, int* __restrict__ src, int* __restrict__ keys) {
  __shared__ int sh[kThreads];
  const int b = blockIdx.x;
  const long long* seg = sorted + (long long)b * P;
  const long long imask = (1LL << pbits) - 1;
  const long long row0 = (long long)b * cap;
  int carry = 0;                    // first points before this tile
  for (int base = 0; base < P; base += kThreads * kItems) {
    const int i0 = base + threadIdx.x * kItems;
    int key[kItems], idx[kItems];
    bool first[kItems];
    // the key before this thread's first one (none at the cloud's start)
    int prev = i0 > 0 && i0 < P ? (int)((seg[i0 - 1] >> pbits) & kInvalid)
                                : -1;
    int c = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j;
      first[j] = false;
      if (i < P) {
        const long long k = seg[i];
        key[j] = (int)((k >> pbits) & kInvalid);
        idx[j] = (int)(k & imask);
        first[j] = key[j] != kInvalid && key[j] != prev;
        prev = key[j];
        c += first[j];
      }
    }
    int total;
    int pos = carry + block_exclusive_scan(c, sh, total);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (!first[j]) continue;
      if (pos < cap) {
        const long long r = row0 + pos;
        const int k = key[j];
        const long long pt = (long long)b * P + idx[j];
        keys[r] = k;
        src[r] = idx[j];
        out_mask[r] = true;
        coords[3 * r] = compact3(k >> 2) - sx;
        coords[3 * r + 1] = compact3(k >> 1) - sy;
        coords[3 * r + 2] = compact3(k) - sz;
        out_xyz[3 * r] = __ldg(xyz + 3 * pt);
        out_xyz[3 * r + 1] = __ldg(xyz + 3 * pt + 1);
        out_xyz[3 * r + 2] = __ldg(xyz + 3 * pt + 2);
      }
      ++pos;
    }
    carry += total;
  }
  const int n = carry < cap ? carry : cap;
  if (threadIdx.x == 0) count[b] = n;
  for (int i = n + threadIdx.x; i < cap; i += kThreads) {
    const long long r = row0 + i;
    keys[r] = kInvalid;
    src[r] = P;
    out_mask[r] = false;
    coords[3 * r] = coords[3 * r + 1] = coords[3 * r + 2] = 0;
    out_xyz[3 * r] = out_xyz[3 * r + 1] = out_xyz[3 * r + 2] = 0.0f;
  }
}

}  // namespace

// xyz [B, P, 3] f32; counts [B] int32; keys [B * P] int64. bits: the
// window's bits per axis (1..10).
extern "C" int eyoc_voxel_keys(const void* xyz, const void* counts, int B,
                               int P, float voxel, int bx, int by, int bz,
                               int pbits, void* keys, void* stream) {
  const long long n = (long long)B * P;
  if (n <= 0) return 0;
  if (bx < 1 || bx > 10 || by < 1 || by > 10 || bz < 1 || bz > 10)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kKeyThreads - 1) / kKeyThreads);
  voxel_keys<<<blocks, kKeyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(counts), B, P,
      voxel, bx, by, bz, pbits, static_cast<long long*>(keys));
  return (int)cudaGetLastError();
}

// sorted [B * P] int64 (voxel_keys' keys, sorted); outputs per cloud b at
// rows [b * cap, (b + 1) * cap): coords [., 3] int32, xyz [., 3] f32, mask
// bool, src int32, keys int32; count [B] int32. (sx, sy, sz): the shift.
extern "C" int eyoc_voxel_compact(const void* sorted, const void* xyz, int B,
                                  int P, int cap, int pbits, int sx, int sy,
                                  int sz, void* coords, void* out_xyz,
                                  void* mask, void* count, void* src,
                                  void* keys, void* stream) {
  if (B <= 0 || cap <= 0) return 0;
  voxel_compact<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted), static_cast<const float*>(xyz),
      P, cap, pbits, sx, sy, sz, static_cast<int*>(coords),
      static_cast<float*>(out_xyz), static_cast<bool*>(mask),
      static_cast<int*>(count), static_cast<int*>(src),
      static_cast<int*>(keys));
  return (int)cudaGetLastError();
}
