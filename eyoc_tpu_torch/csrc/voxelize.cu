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
//   orders every cloud by (key, index), as the JAX sort does. Its threads
//   also write every output row as a pad (the compaction overwrites the
//   voxel rows) and zero the compaction's look-back state;
// - voxel_compact, one block a tile of a cloud's sorted keys over a 1-D
//   grid of (cloud, tile), the tiles taken in ticket order: first-occurrence
//   flags (the tile's first key against the key before the tile), a block
//   scan of their counts, the tile's exclusive prefix within its cloud by a
//   decoupled look-back, and each first point written at its rank (below
//   cap) with its xyz, coords, point index and level-0 Morton key; the
//   cloud's last tile writes its voxel count.
//
// What bounds it: bytes (the points once, the keys three times through the
// sort, the voxels once); the compaction spreads a cloud over P / tile
// blocks, so one cloud fills the card as eight do. No --use_fast_math: an
// approximate quotient moves a point that lies on a voxel face into the
// next voxel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalid = 0x7FFFFFFF;
constexpr int kKeyThreads = 256;
constexpr int kThreads = 256;      // voxel_compact: one block a tile
// a look-back status word: flag (aggregate, inclusive prefix) | value
constexpr unsigned kAggregate = 1u << 30, kInclusive = 2u << 30,
                   kValue = kAggregate - 1;
constexpr int kWindow = 32;          // status words a look-back round reads

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

// The decoupled look-back, by the whole block: thread 0 publishes the
// tile's aggregate; each round the first kWindow threads read the status
// words of the kWindow tiles before the round's start, and thread 0 adds
// them from the nearest back: an aggregate adds and goes on, an inclusive
// prefix adds and ends, an unpublished word ends the round (read again
// from there). Thread 0 then publishes the inclusive prefix; every thread
// gets the exclusive one. Tiles are taken in ticket order, so every
// predecessor is running or done. `win` and `st` are shared memory.
__device__ int look_back(unsigned* status, int tile, int agg, unsigned* win,
                         int* st) {
  const int t = threadIdx.x;
  if (t == 0) {
    atomicExch(status + tile, (tile == 0 ? kInclusive : kAggregate) |
                                  (unsigned)agg);
    st[0] = 0;                                   // the exclusive prefix
    st[1] = tile - 1;                            // the next tile to read
  }
  __syncthreads();
  while (st[1] >= 0) {
    const int j = st[1];
    if (t < kWindow)
      win[t] = j - t >= 0
                   ? (unsigned)*reinterpret_cast<volatile unsigned*>(
                         status + j - t)
                   : (unsigned)kInclusive;
    __syncthreads();
    if (t == 0) {
      int i = 0;
      for (; i < kWindow; ++i) {
        const unsigned s = win[i];
        if ((s & ~kValue) == 0) break;            // not published yet
        st[0] += (int)(s & kValue);
        if (s & kInclusive) {
          i = j + 1;                             // done: st[1] becomes -1
          break;
        }
      }
      st[1] = j - i;
    }
    __syncthreads();
  }
  const int excl = st[0];
  if (t == 0 && tile > 0)
    atomicExch(status + tile, kInclusive | (unsigned)(excl + agg));
  __syncthreads();
  return excl;
}

// Point p of cloud b is valid where p < counts[b]. Thread e also writes
// output row e as a pad (e < B * cap) and zeroes status[e] (e < nstatus).
__global__ void __launch_bounds__(kKeyThreads) voxel_keys(
    const float* __restrict__ xyz, const int* __restrict__ counts, int B,
    int P, float voxel, int bx, int by, int bz, int pbits,
    long long* __restrict__ keys, int cap, int* __restrict__ coords,
    float* __restrict__ out_xyz, bool* __restrict__ out_mask,
    int* __restrict__ src, int* __restrict__ out_keys,
    unsigned* __restrict__ status, int nstatus) {
  const long long e = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  if (e < (long long)B * P) {
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
  if (e < (long long)B * cap) {
    out_keys[e] = kInvalid;
    src[e] = P;
    out_mask[e] = false;
    coords[3 * e] = coords[3 * e + 1] = coords[3 * e + 2] = 0;
    out_xyz[3 * e] = out_xyz[3 * e + 1] = out_xyz[3 * e + 2] = 0.0f;
  }
  if (e < nstatus) status[e] = 0;
}

// One block a tile of `tile` sorted keys of one cloud; the clouds' tiles
// are numbered b * nt + t and taken by ticket (status[B * nt]).
__global__ void __launch_bounds__(kThreads) voxel_compact(
    const long long* __restrict__ sorted, const float* __restrict__ xyz,
    int P, int cap, int pbits, int tile, int nt, int sx, int sy, int sz,
    int* __restrict__ coords, float* __restrict__ out_xyz,
    bool* __restrict__ out_mask, int* __restrict__ count,
    int* __restrict__ src, int* __restrict__ keys,
    unsigned* __restrict__ status, int* __restrict__ ticket) {
  __shared__ int sh[kThreads];
  __shared__ unsigned win[kWindow];
  __shared__ int st[2], s_g;
  if (threadIdx.x == 0) s_g = atomicAdd(ticket, 1);
  __syncthreads();
  const int b = s_g / nt, t = s_g - b * nt;
  const long long* seg = sorted + (long long)b * P;
  const long long imask = (1LL << pbits) - 1;
  const long long row0 = (long long)b * cap;
  // this thread's keys [i0, i1) of the tile [lo, hi)
  const int lo = t * tile, hi = min(lo + tile, P);
  const int per = (tile + kThreads - 1) / kThreads;
  const int i0 = min(lo + (int)threadIdx.x * per, hi);
  const int i1 = min(i0 + per, hi);
  // the key before this thread's first one (none at the cloud's start)
  const int prev0 = i0 > 0 && i0 < i1
                        ? (int)((seg[i0 - 1] >> pbits) & kInvalid)
                        : -1;
  int c = 0;
  for (int i = i0, prev = prev0; i < i1; ++i) {
    const int k = (int)((seg[i] >> pbits) & kInvalid);
    c += k != kInvalid && k != prev;
    prev = k;
  }
  int total;
  const int excl = block_exclusive_scan(c, sh, total);
  const int before = look_back(status + (long long)b * nt, t, total, win,
                               st);
  if (threadIdx.x == 0 && t == nt - 1) count[b] = min(before + total, cap);
  int pos = before + excl;
  for (int i = i0, prev = prev0; i < i1 && pos < cap; ++i) {
    const long long key = seg[i];
    const int k = (int)((key >> pbits) & kInvalid);
    if (k != kInvalid && k != prev) {
      const long long r = row0 + pos;
      const int idx = (int)(key & imask);
      const long long pt = (long long)b * P + idx;
      keys[r] = k;
      src[r] = idx;
      out_mask[r] = true;
      coords[3 * r] = compact3(k >> 2) - sx;
      coords[3 * r + 1] = compact3(k >> 1) - sy;
      coords[3 * r + 2] = compact3(k) - sz;
      out_xyz[3 * r] = __ldg(xyz + 3 * pt);
      out_xyz[3 * r + 1] = __ldg(xyz + 3 * pt + 1);
      out_xyz[3 * r + 2] = __ldg(xyz + 3 * pt + 2);
      ++pos;
    }
    prev = k;
  }
}

}  // namespace

// xyz [B, P, 3] f32; counts [B] int32; keys [B * P] int64. bits: the
// window's bits per axis (1..10). The outputs of voxel_compact (cap rows a
// cloud) are written as pads, and status [nstatus] int32 is zeroed.
extern "C" int eyoc_voxel_keys(const void* xyz, const void* counts, int B,
                               int P, float voxel, int bx, int by, int bz,
                               int pbits, void* keys, int cap, void* coords,
                               void* out_xyz, void* mask, void* src,
                               void* out_keys, void* status, int nstatus,
                               void* stream) {
  if (bx < 1 || bx > 10 || by < 1 || by > 10 || bz < 1 || bz > 10 ||
      B < 0 || P < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  long long n = (long long)B * P;
  if ((long long)B * cap > n) n = (long long)B * cap;
  if (nstatus > n) n = nstatus;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kKeyThreads - 1) / kKeyThreads);
  voxel_keys<<<blocks, kKeyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(counts), B, P,
      voxel, bx, by, bz, pbits, static_cast<long long*>(keys), cap,
      static_cast<int*>(coords), static_cast<float*>(out_xyz),
      static_cast<bool*>(mask), static_cast<int*>(src),
      static_cast<int*>(out_keys), static_cast<unsigned*>(status), nstatus);
  return (int)cudaGetLastError();
}

// sorted [B * P] int64 (voxel_keys' keys, sorted); outputs per cloud b at
// rows [b * cap, (b + 1) * cap): coords [., 3] int32, xyz [., 3] f32, mask
// bool, src int32, keys int32; count [B] int32. (sx, sy, sz): the shift.
// tile: sorted keys a block; status: the B * nt + 1 int32 that voxel_keys
// zeroed (nt = max(1, ceil(P / tile)) look-back words a cloud, a ticket).
extern "C" int eyoc_voxel_compact(const void* sorted, const void* xyz, int B,
                                  int P, int cap, int pbits, int tile,
                                  int sx, int sy, int sz, void* coords,
                                  void* out_xyz, void* mask, void* count,
                                  void* src, void* keys, void* status,
                                  void* stream) {
  if (B <= 0) return 0;
  if (tile <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const int nt = P > 0 ? (P + tile - 1) / tile : 1;
  unsigned* st = static_cast<unsigned*>(status);
  voxel_compact<<<B * nt, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted), static_cast<const float*>(xyz),
      P, cap, pbits, tile, nt, sx, sy, sz, static_cast<int*>(coords),
      static_cast<float*>(out_xyz), static_cast<bool*>(mask),
      static_cast<int*>(count), static_cast<int*>(src),
      static_cast<int*>(keys), st, reinterpret_cast<int*>(st + B * nt));
  return (int)cudaGetLastError();
}
