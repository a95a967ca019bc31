// K11 brick_pyramid: every level of the brick pyramid of B clouds.
//
// Replaces eyoc_tpu/sparse/bricks.py:232 `build_pyramid`, with its
// :91 `_skeleton` and :148 `_neighbors`:
//
//   per level l, per cloud: level-l voxels (keys sorted within the cloud)
//   grouped into 2x2x2 bricks by first-occurrence flags and a prefix count
//   -> bkeys, bmask, bseg, occ, cellslot, valid voxels (bricks past the
//   brick capacity dropped); level l+1's voxels are level l's bricks;
//   nbr6: the brick at each face offset, up_slots: the level-(l+1) cell
//   of the brick at each offset in {0,1}^3 (the transposed conv's window).
//
// Two launches:
// - skeleton, one block a cloud, walks the levels in turn (level l+1 reads
//   the bricks level l just wrote, in the same block): a brick's row is
//   its rank among the cloud's first-occurrence flags, a voxel's brick
//   rank the inclusive count of flags up to it, minus one. The block also
//   counts the cloud's valid level-0 voxels.
// - lookups, one thread a (brick row, lookup) of every level, j-major so
//   that neighbouring threads take neighbouring rows: the neighbour's
//   Morton key is binary-searched among the cloud's brick keys, sorted
//   with INVALID last (13 steps at a brick capacity of 5120). The JAX
//   package and the plain version resolve the lookups through a dense
//   z-column grid of B*GX*GY*GZ int32 per level (134 MB at level 0 for
//   B = 8, bits (9, 9, 7)); this needs none. An out-of-window offset finds
//   nothing, under the same per-level grid_dims range tests.
//
// What bounds it: bytes and the launch path; a cloud's skeleton is one
// block, enough for 1 or 8 clouds a call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalid = 0x7FFFFFFF;
constexpr int kPbMask = (1 << 14) - 1;   // parent overflow (bricks.py)
constexpr int kMaxLevels = 8;
constexpr int kThreads = 1024;           // skeleton: one block a cloud
constexpr int kItems = 4;
constexpr int kLookupThreads = 256;
constexpr int kRecord = 15;              // int64s a level in the table

struct Level {
  int cap, bc, gx, gy, gz;    // voxel and brick capacity of a cloud, the
                              // brick lattice's grid_dims
  const int* keys_in;         // [B * cap] level-l voxel keys
  const bool* mask_in;
  int* bkeys;                 // [B * bc]
  bool* bmask;
  int* bseg;
  bool* occ;                  // [B * bc * 8]
  int* cellslot;              // [B * cap]
  bool* valid;                // [B * cap]
  int* nbr6;                  // [6, B * bc]
  int* up;                    // [B * bc, 8], null at the deepest level
};

struct Pyramid {
  Level lv[kMaxLevels];
  long long start[kMaxLevels + 1];   // lookups: first thread of a level
  int L, B;
};

// lookup j: the 6 faces, the rest of the positive octant, then the brick
// itself (bricks.py LOOKUP + (0, 0, 0)); its octant cell of up_slots, or -1
__constant__ int kOff[11][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                {0, 1, 0},  {0, 0, -1}, {0, 0, 1},
                                {0, 1, 1},  {1, 0, 1}, {1, 1, 0},
                                {1, 1, 1},  {0, 0, 0}};
__constant__ int kOct[11] = {-1, 4, -1, 2, -1, 1, 3, 5, 6, 7, 0};

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

// Exclusive prefix sum of v over the block (blockDim.x == kThreads).
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

// Level l+1 reads level l's bricks, written by other threads of this
// block: plain loads (no __ldg), ordered by __syncthreads.
__global__ void __launch_bounds__(kThreads) skeleton(const Pyramid pyr,
                                                     int* counts) {
  __shared__ int sh[kThreads];
  __shared__ int n_valid;
  const int b = blockIdx.x, t = threadIdx.x;
  if (t == 0) n_valid = 0;
  for (int l = 0; l < pyr.L; ++l) {
    const Level& lv = pyr.lv[l];
    const int bc = lv.bc, cap = lv.cap;
    const int nb8 = pyr.B * bc * 8;
    for (int r = t; r < bc; r += kThreads) {
      const int row = b * bc + r;
      lv.bkeys[row] = kInvalid;
      lv.bmask[row] = false;
      lv.bseg[row] = b;
    }
    for (int c = t; c < 8 * bc; c += kThreads) lv.occ[b * bc * 8 + c] = false;
    __syncthreads();
    const int* keys = lv.keys_in + (long long)b * cap;
    const bool* mask = lv.mask_in + (long long)b * cap;
    int carry = 0;                  // first-occurrence flags before the tile
    for (int base = 0; base < cap; base += kThreads * kItems) {
      const int i0 = base + t * kItems;
      int key[kItems], bk[kItems];
      bool m[kItems], first[kItems];
      int prev = -1;                // the brick key before (none at start)
      if (i0 > 0 && i0 < cap)
        prev = mask[i0 - 1] ? keys[i0 - 1] >> 3 : kInvalid;
      int c = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j;
        m[j] = first[j] = false;
        if (i < cap) {
          m[j] = mask[i];
          key[j] = keys[i];
          bk[j] = m[j] ? key[j] >> 3 : kInvalid;
          first[j] = m[j] && bk[j] != prev;
          prev = bk[j];
          c += first[j];
        }
      }
      int total;
      int cnt = carry + block_exclusive_scan(c, sh, total);
      int nv = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j;
        if (i >= cap) break;
        cnt += first[j];            // inclusive count: the brick's rank + 1
        const int rank = cnt - 1;
        if (first[j] && rank < bc) {
          lv.bkeys[b * bc + rank] = bk[j];
          lv.bmask[b * bc + rank] = true;
        }
        const bool ok = m[j] && rank >= 0 && rank < bc;
        const int slot = ok ? (b * bc + rank) * 8 + (key[j] & 7) : nb8;
        lv.cellslot[(long long)b * cap + i] = slot;
        lv.valid[(long long)b * cap + i] = ok;
        if (ok) {
          lv.occ[slot] = true;
          ++nv;
        }
      }
      if (l == 0 && nv) atomicAdd(&n_valid, nv);
      carry += total;
    }
    __syncthreads();                // this level's bricks: the next voxels
  }
  if (t == 0) counts[b] = n_valid;
}

__global__ void __launch_bounds__(kLookupThreads) lookups(const Pyramid pyr) {
  const long long e = (long long)blockIdx.x * kLookupThreads + threadIdx.x;
  if (e >= pyr.start[pyr.L]) return;
  int l = 0;
  while (e >= pyr.start[l + 1]) ++l;
  const Level& lv = pyr.lv[l];
  const int bc = lv.bc, nbtot = pyr.B * bc;
  const long long el = e - pyr.start[l];
  const int j = (int)(el / nbtot);
  const int row = (int)(el - (long long)j * nbtot);
  const int seg = row / bc;
  const bool valid = lv.bmask[row];
  const int key = __ldg(lv.bkeys + row);
  const int bx = compact3(key >> 2), by = compact3(key >> 1),
            bz = compact3(key);
  const int ox = kOff[j][0], oy = kOff[j][1], oz = kOff[j][2];
  bool found = false;
  int nrow = row;
  if (j == 10) {
    found = valid;
  } else if (valid) {
    const int nx = bx + ox, ny = by + oy, nz = bz + oz;
    if (nx >= 0 && nx < lv.gx && ny >= 0 && ny < lv.gy && nz >= 0 &&
        nz < lv.gz) {
      const int nkey = (spread3(nx) << 2) | (spread3(ny) << 1) | spread3(nz);
      const int* keys = lv.bkeys + seg * bc;
      int lo = 0, n = bc;           // lower bound of nkey in the cloud
      while (n > 0) {
        const int half = n >> 1;
        if (__ldg(keys + lo + half) < nkey) {
          lo += half + 1;
          n -= half + 1;
        } else {
          n = half;
        }
      }
      found = lo < bc && __ldg(keys + lo) == nkey;
      nrow = seg * bc + lo;
    }
  }
  if (j < 6) lv.nbr6[(long long)j * nbtot + row] = found ? nrow : nbtot;
  const int ci = kOct[j];
  if (lv.up == nullptr || ci < 0) return;
  // the parent brick of the brick found, within its cloud: level l+1's
  // cellslot of that row >> 3, or kPbMask where the parent overflowed
  const Level& nx = pyr.lv[l + 1];
  const int cap_next = nx.bc, nb8_next = pyr.B * cap_next * 8;
  int pb = kPbMask;
  if (found) {
    const int cs = __ldg(nx.cellslot + nrow);
    pb = cs >= nb8_next ? kPbMask : (cs >> 3) % cap_next;
  }
  const int cell = (((bx + ox) & 1) << 2) | (((by + oy) & 1) << 1) |
                   ((bz + oz) & 1);
  lv.up[(long long)row * 8 + ci] =
      found && pb < cap_next ? (seg * cap_next + pb) * 8 + cell : nb8_next;
}

}  // namespace

// table: L records of kRecord int64 (the wrapper's order): cap, bc, gx, gy,
// gz, keys_in, mask_in, bkeys, bmask, bseg, occ, cellslot, valid, nbr6, up
// (0 at the deepest level). counts [B] int32: valid level-0 voxels.
extern "C" int eyoc_brick_pyramid(const long long* table, int B, int L,
                                  void* counts, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Pyramid pyr;
  pyr.L = L;
  pyr.B = B;
  pyr.start[0] = 0;
  for (int l = 0; l < L; ++l) {
    const long long* r = table + l * kRecord;
    Level& lv = pyr.lv[l];
    lv.cap = (int)r[0];
    lv.bc = (int)r[1];
    lv.gx = (int)r[2];
    lv.gy = (int)r[3];
    lv.gz = (int)r[4];
    lv.keys_in = reinterpret_cast<const int*>(r[5]);
    lv.mask_in = reinterpret_cast<const bool*>(r[6]);
    lv.bkeys = reinterpret_cast<int*>(r[7]);
    lv.bmask = reinterpret_cast<bool*>(r[8]);
    lv.bseg = reinterpret_cast<int*>(r[9]);
    lv.occ = reinterpret_cast<bool*>(r[10]);
    lv.cellslot = reinterpret_cast<int*>(r[11]);
    lv.valid = reinterpret_cast<bool*>(r[12]);
    lv.nbr6 = reinterpret_cast<int*>(r[13]);
    lv.up = reinterpret_cast<int*>(r[14]);
    if (lv.bc <= 0 || lv.cap <= 0 || (l + 1 < L) != (lv.up != nullptr))
      return (int)cudaErrorInvalidValue;
    pyr.start[l + 1] = pyr.start[l] + (long long)(lv.up ? 11 : 6) * B * lv.bc;
  }
  auto s = static_cast<cudaStream_t>(stream);
  skeleton<<<B, kThreads, 0, s>>>(pyr, static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = pyr.start[L];
  lookups<<<(unsigned)((n + kLookupThreads - 1) / kLookupThreads),
            kLookupThreads, 0, s>>>(pyr);
  return (int)cudaGetLastError();
}
