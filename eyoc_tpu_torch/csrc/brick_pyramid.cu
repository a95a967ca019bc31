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
// - skeleton: every level in one pass over the level-0 rows, one block a
//   tile of `tile` rows of a cloud (tiles taken in ticket order). A level-l
//   brick is a run of level-0 rows, and it is written by the row where it
//   first occurs: row i starts a level-0 brick where it is valid and its
//   brick key differs from row i-1's (or row i-1 is masked), and a level-l
//   brick (l >= 1) where it starts a level-(l-1) brick and key >> 3(l+1)
//   differs from that of the last valid row before it (the voxel before
//   it at level l has that key, whatever the mask). Its rank is the count
//   of such rows up to it, minus one. The ranks are counted without the
//   capacities: a capacity cut at level k drops a suffix of every level
//   above it (ranks are monotone), so a row's ranks are valid where every
//   lower level's rank is below its capacity. Fields scanned: the valid
//   rows and the L start counts, 16 bits each within a tile (a block scan
//   by warp shuffles), chained across tiles by a decoupled look-back, one
//   chain a field, in status words that carry the call's epoch (zeroed
//   once per device, nothing to clear between calls). Every output byte
//   is written once: level-0 rows by their tile, bricks and level-(l+1)
//   voxels below the count n_l by their first row, the rows from n_l to
//   the capacity by the block that learns n_l (the block of the first row
//   past a lower level's cut, else the cloud's last block), bseg by a
//   share of every block. Each brick also notes its first voxel row.
// - lookups, one thread a (brick row, lookup) of every level, j-major so
//   that neighbouring threads take neighbouring rows: the neighbour's
//   Morton key is binary-searched among the cloud's brick keys, sorted
//   with INVALID last (13 steps at a brick capacity of 5120); of equal
//   keys (a masked row splits a brick) the last, as the grid keeps.
//   The JAX package and the plain version resolve the lookups through a
//   dense z-column grid of B*GX*GY*GZ int32 per level (134 MB at level 0
//   for B = 8, bits (9, 9, 7)); this needs none. An out-of-window offset
//   finds nothing, under the same per-level grid_dims range tests. The
//   brick's own lookup also walks its voxels from the first one (a
//   contiguous run of the level's voxel rows) and writes its 8 occupancy
//   bytes at once.
//
// What bounds it: bytes and the launch path; the skeleton spreads a cloud
// over cap / tile blocks, so one cloud fills as many SMs as eight do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kInvalid = 0x7FFFFFFF;
constexpr int kPbMask = (1 << 14) - 1;   // parent overflow (bricks.py)
constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;            // skeleton: one block a tile
constexpr int kWarps = kThreads / 32;
constexpr int kLookupThreads = 256;
constexpr int kRecord = 16;              // int64s a level in the table
// a look-back status word: epoch << 32 | flag | value (30 bits)
constexpr u64 kAggregate = 1ull << 30, kInclusive = 2ull << 30,
              kValue = kAggregate - 1;

struct Level {
  int cap, bc, gx, gy, gz;    // voxel and brick capacity of a cloud, the
                              // brick lattice's grid_dims
  const int* keys_in;         // [B * cap] level-l voxel keys
  const bool* mask_in;
  int* bkeys;                 // [B * bc]
  bool* bmask;
  int* bseg;
  bool* occ;                  // [B * bc * 8], 8-byte aligned
  int* cellslot;              // [B * cap]
  bool* valid;                // [B * cap]
  int* nbr6;                  // [6, B * bc]
  int* up;                    // [B * bc, 8], null at the deepest level
  int* first;                 // [B * bc] the brick's first voxel row
};

struct Pyramid {
  Level lv[kMaxLevels];
  long long start[kMaxLevels + 1];   // lookups: first thread of a level
  int L, B;
};

// lookup j: the 6 faces, the brick itself, the rest of the positive octant
// (bricks.py LOOKUP and (0, 0, 0)); its octant cell of up_slots, or -1
__constant__ int kOff[11][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                {0, 1, 0},  {0, 0, -1}, {0, 0, 1},
                                {0, 0, 0},  {0, 1, 1}, {1, 0, 1},
                                {1, 1, 0},  {1, 1, 1}};
__constant__ int kOct[11] = {-1, 4, -1, 2, -1, 1, 0, 3, 5, 6, 7};
constexpr int kSelf = 6;

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

// The first of the n sorted keys that exceeds nkey (n if none).
__device__ __forceinline__ int upper_bound(const int* keys, int n, int nkey) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(keys + lo + half) <= nkey) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The fields a level-0 row adds to: bit 0 a valid row, bit 1 + l a row
// where a level-l brick starts. pm, pk: row i-1's mask and key (pm false
// at the cloud's first row); has, lvk: the last valid row before i.
template <int L>
__device__ __forceinline__ unsigned row_fields(bool m, int key, bool pm,
                                               int pk, bool has, int lvk) {
  if (!m) return 0;
  if (pm && (key >> 3) == (pk >> 3)) return 1u;
  unsigned f = 3u;
#pragma unroll
  for (int l = 1; l < L; ++l) {
    const int s = 3 * (l + 1);
    if (has && (key >> s) == (lvk >> s)) break;
    f |= 2u << l;
  }
  return f;
}

__device__ __forceinline__ int field(const u64* w, int f) {
  return (int)((w[f >> 2] >> (16 * (f & 3))) & 0xFFFF);
}

// Exclusive prefix sums of the W packed words over the block (every thread
// calls); `total` gets the block's sums. `sh` holds kWarps * W words.
template <int W>
__device__ __forceinline__ void block_scan(const u64* v, u64* excl,
                                           u64* total, u64* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 inc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) inc[k] = v[k];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const u64 o = __shfl_sync(0xFFFFFFFFu, inc[k], lane - off);
      if (lane >= off) inc[k] += o;
    }
  }
  if (lane == 31)
#pragma unroll
    for (int k = 0; k < W; ++k) sh[warp * W + k] = inc[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < W; ++k) {
    u64 before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const u64 s = sh[w * W + k];
      if (w < warp) before += s;
      all += s;
    }
    excl[k] = before + inc[k] - v[k];
    total[k] = all;
  }
  __syncthreads();
}

// The largest v over the threads before this one (-1 if none); `sh` holds
// kWarps ints.
__device__ int block_max_before(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_sync(0xFFFFFFFFu, inc, lane - off);
    if (lane >= off) inc = max(inc, o);
  }
  int before = __shfl_sync(0xFFFFFFFFu, inc, lane - 1);
  if (lane == 0) before = -1;
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, sh[w]);
  __syncthreads();
  return before;
}

// The exclusive prefix of field f before tile `tile` of a cloud, by one
// warp (every lane calls; lane 0 publishes the tile's aggregate first and
// its inclusive prefix last). Each round the lanes read the words of the
// 32 tiles before the round's start and walk them from the nearest: an
// aggregate adds and goes on, an inclusive prefix adds and ends, a word of
// another epoch (not published yet) ends the round, read again from there.
__device__ unsigned look_back(u64* status, int tile, int F, int f,
                              unsigned agg, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const u64 tag = (u64)epoch << 32;
  if (lane == 0)
    atomicExch(status + (long long)tile * F + f,
               tag | (tile == 0 ? kInclusive : kAggregate) | agg);
  unsigned excl = 0;
  int j = tile - 1;
  while (j >= 0) {
    const int at = j - lane;
    const u64 s =
        at >= 0 ? *reinterpret_cast<volatile u64*>(status + (long long)at * F
                                                   + f)
                : tag | kInclusive;
    int i = 0;
    bool done = false;
    for (; i < 32; ++i) {
      const u64 w = __shfl_sync(0xFFFFFFFFu, s, i);
      if ((w >> 32) != epoch || (w & (kAggregate | kInclusive)) == 0) break;
      excl += (unsigned)(w & kValue);
      if (w & kInclusive) {
        done = true;
        break;
      }
    }
    if (done) break;
    j -= i;
  }
  if (lane == 0 && tile > 0)
    atomicExch(status + (long long)tile * F + f,
               tag | kInclusive | (u64)(excl + agg));
  return excl;
}

// ok_l(x): every level below l keeps the rank counted in x.
__device__ __forceinline__ bool kept_below(const Pyramid& pyr, const int* x,
                                           int l) {
#pragma unroll
  for (int k = 0; k < l; ++k)
    if (x[1 + k] > pyr.lv[k].bc) return false;
  return true;
}

// Tiles are numbered b * nt + t and taken by ticket (state[0], reset by
// the last block to take one); status: [B * nt, L + 1] words. One
// instance a level count, so that the fields live in registers.
template <int L>
__global__ void __launch_bounds__(kThreads) skeleton(
    const Pyramid pyr, int tile, int nt, unsigned epoch,
    unsigned* __restrict__ ticket, u64* __restrict__ status,
    int* __restrict__ counts) {
  constexpr int F = L + 1, W = (F + 3) / 4;
  __shared__ u64 sh[kWarps * W];
  __shared__ int sh_max[kWarps];
  __shared__ unsigned s_prefix[F];
  __shared__ int s_fill[L];
  __shared__ int s_g, s_before, s_need;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_g = (int)atomicAdd(ticket, 1u);
    if (s_g == pyr.B * nt - 1) atomicExch(ticket, 0u);
    s_need = 0;
    s_before = -1;
  }
  if (t < L) s_fill[t] = -1;
  __syncthreads();
  const int b = s_g / nt, tt = s_g - b * nt;
  const Level& l0 = pyr.lv[0];
  const int cap = l0.cap;
  const int* keys = l0.keys_in + (long long)b * cap;
  const bool* mask = l0.mask_in + (long long)b * cap;
  // this thread's rows [i0, i1) of the tile [lo, hi)
  const int lo = tt * tile, hi = min(lo + tile, cap);
  const int per = (tile + kThreads - 1) / kThreads;
  const int i0 = min(lo + t * per, hi), i1 = min(i0 + per, hi);

  // bseg: a share of every level's rows
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const Level& lv = pyr.lv[l];
    const int r0 = (int)((long long)lv.bc * tt / nt),
              r1 = (int)((long long)lv.bc * (tt + 1) / nt);
    for (int r = r0 + t; r < r1; r += kThreads) lv.bseg[b * lv.bc + r] = b;
  }

  // the last valid row before each thread's rows: within the tile by a
  // block scan; before the tile (for the thread with the tile's first
  // valid row) by warp 0, 32 rows a round back from the tile's start
  int lastv = -1;
  for (int i = i0; i < i1; ++i)
    if (mask[i]) lastv = i;
  int before = block_max_before(lastv, sh_max);
  if (before < 0 && lastv >= 0 && lo > 0) s_need = 1;
  __syncthreads();
  if (warp == 0 && s_need) {
    int found = -1;
    for (int base = lo - 1; base >= 0 && found < 0; base -= 32) {
      const int i = base - lane;
      int c = i >= 0 && mask[i] ? i : -1;
      for (int off = 16; off > 0; off >>= 1)
        c = max(c, __shfl_xor_sync(0xFFFFFFFFu, c, off));
      found = c;
    }
    if (lane == 0) s_before = found;
  }
  __syncthreads();
  if (before < 0) before = s_before;

  // the fields of this thread's rows, then their prefix within the tile
  const bool pm0 = i0 > 0 && i0 < i1 && mask[i0 - 1];
  const int pk0 = pm0 ? keys[i0 - 1] : 0;
  const int lvk0 = before >= 0 ? keys[before] : 0;
  u64 mine[W] = {}, excl[W], total[W];       // 16-bit fields, 4 a word
  {
    bool pm = pm0, has = before >= 0;
    int pk = pk0, lvk = lvk0;
    for (int i = i0; i < i1; ++i) {
      const bool m = mask[i];
      const int key = keys[i];
      const unsigned fl = row_fields<L>(m, key, pm, pk, has, lvk);
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (fl >> f & 1) mine[f >> 2] += 1ull << (16 * (f & 3));
      pm = m;
      pk = key;
      if (m) {
        has = true;
        lvk = key;
      }
    }
  }
  block_scan<W>(mine, excl, total, sh);

  // each field's prefix before the tile
  for (int f = warp; f < F; f += kWarps) {
    const unsigned p = look_back(status + (long long)b * nt * F, tt, F, f,
                                 (unsigned)field(total, f), epoch);
    if (lane == 0) s_prefix[f] = p;
  }
  __syncthreads();

  int cnt[F], ex[F];
#pragma unroll
  for (int f = 0; f < F; ++f) cnt[f] = (int)s_prefix[f] + field(excl, f);
  if (tt == nt - 1 && t == 0) {
    // the cloud's totals: the counts of the levels that no lower cut ends
    int tot[F];
#pragma unroll
    for (int f = 0; f < F; ++f) tot[f] = (int)s_prefix[f] + field(total, f);
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (kept_below(pyr, tot, l)) s_fill[l] = min(pyr.lv[l].bc, tot[1 + l]);
    if (kept_below(pyr, tot, 1)) counts[b] = tot[0];
  }
  {
    bool pm = pm0, has = before >= 0;
    int pk = pk0, lvk = lvk0;
    const int bc0 = l0.bc, nb80 = pyr.B * bc0 * 8;
    for (int i = i0; i < i1; ++i) {
      const bool m = mask[i];
      const int key = keys[i];
      const unsigned fl = row_fields<L>(m, key, pm, pk, has, lvk);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        ex[f] = cnt[f];
        cnt[f] += fl >> f & 1;
      }
      const long long row = (long long)b * cap + i;
      const bool ok = m && cnt[1] <= bc0;
      l0.cellslot[row] = ok ? (b * bc0 + cnt[1] - 1) * 8 + (key & 7) : nb80;
      l0.valid[row] = ok;
      if (fl & 2u) {
        // the first row past a lower level's cut: n_l for the fill, and
        // the valid level-0 rows before it
#pragma unroll
        for (int l = 1; l < L; ++l)
          if (kept_below(pyr, ex, l) && !kept_below(pyr, cnt, l))
            s_fill[l] = min(pyr.lv[l].bc, ex[1 + l]);
        if (ex[1] <= bc0 && cnt[1] > bc0) counts[b] = ex[0];
      }
      // the bricks this row starts, up to the first level past its cut
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const Level& lv = pyr.lv[l];
        if (!(fl >> (1 + l) & 1) || cnt[1 + l] > lv.bc) break;
        const int r = b * lv.bc + cnt[1 + l] - 1;
        const int bk = key >> (3 * (l + 1));
        lv.bkeys[r] = bk;
        lv.bmask[r] = true;
        lv.first[r] = l == 0 ? (int)row : b * pyr.lv[l - 1].bc + cnt[l] - 1;
        if (l + 1 < L) {          // level l+1's voxel r
          const Level& nx = pyr.lv[l + 1];
          const bool okn = cnt[2 + l] <= nx.bc;
          nx.cellslot[r] = okn ? (b * nx.bc + cnt[2 + l] - 1) * 8 + (bk & 7)
                               : pyr.B * nx.bc * 8;
          nx.valid[r] = okn;
        }
      }
      pm = m;
      pk = key;
      if (m) {
        has = true;
        lvk = key;
      }
    }
  }
  __syncthreads();
  // the rows from n_l to the capacity: no brick, no level-(l+1) voxel
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int n = s_fill[l];
    if (n < 0) continue;
    const Level& lv = pyr.lv[l];
    const bool next = l + 1 < L;
    const int sent = next ? pyr.B * pyr.lv[l + 1].bc * 8 : 0;
    for (int r = b * lv.bc + n + t; r < (b + 1) * lv.bc; r += kThreads) {
      lv.bkeys[r] = kInvalid;
      lv.bmask[r] = false;
      if (next) {
        pyr.lv[l + 1].cellslot[r] = sent;
        pyr.lv[l + 1].valid[r] = false;
      }
    }
  }
}

// One thread a (brick row, lookup j) of every level, j-major so that
// neighbouring threads take neighbouring rows.
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
  if (j == kSelf) {
    // the brick's voxels: a run of the level's voxel rows from its first
    u64 occ = 0;
    if (valid) {
      const int end = (seg + 1) * lv.cap;
      for (int v = __ldg(lv.first + row);
           v < end && lv.mask_in[v] && (__ldg(lv.keys_in + v) >> 3) == key;
           ++v)
        occ |= 1ull << (8 * (__ldg(lv.keys_in + v) & 7));
    }
    *reinterpret_cast<u64*>(lv.occ + (long long)row * 8) = occ;
  }
  const int bx = compact3(key >> 2), by = compact3(key >> 1),
            bz = compact3(key);
  const int ox = kOff[j][0], oy = kOff[j][1], oz = kOff[j][2];
  bool found = false;
  int nrow = row;
  if (j == kSelf) {
    found = valid;
  } else if (valid) {
    const int nx = bx + ox, ny = by + oy, nz = bz + oz;
    if (nx >= 0 && nx < lv.gx && ny >= 0 && ny < lv.gy && nz >= 0 &&
        nz < lv.gz) {
      const int nkey = (spread3(nx) << 2) | (spread3(ny) << 1) | spread3(nz);
      const int* keys = lv.bkeys + seg * bc;
      // the last brick of key nkey in the cloud (the grid's scatter keeps
      // the last of equal keys): the upper bound of nkey, minus one
      const int ub = upper_bound(keys, bc, nkey);
      found = ub > 0 && __ldg(keys + ub - 1) == nkey;
      nrow = seg * bc + ub - 1;
    }
  }
  if (j < 6) lv.nbr6[(long long)j * nbtot + row] = found ? nrow : nbtot;
  const int ci = kOct[j];
  if (lv.up == nullptr || ci < 0) return;
  // the parent brick of the brick found, within its cloud: level l+1's
  // cellslot of that row >> 3, or none where the parent overflowed
  const Level& nx = pyr.lv[l + 1];
  const int cap_next = nx.bc, nb8_next = pyr.B * cap_next * 8;
  int slot = nb8_next;
  if (found) {
    const int cs = __ldg(nx.cellslot + nrow);
    const int cell = (((bx + ox) & 1) << 2) | (((by + oy) & 1) << 1) |
                     ((bz + oz) & 1);
    if (cs < nb8_next)
      slot = (seg * cap_next + (cs >> 3) % cap_next) * 8 + cell;
  }
  lv.up[(long long)row * 8 + ci] = slot;
}

typedef void (*SkeletonFn)(const Pyramid, int, int, unsigned, unsigned*,
                           u64*, int*);
const SkeletonFn kSkeleton[kMaxLevels] = {
    skeleton<1>, skeleton<2>, skeleton<3>, skeleton<4>,
    skeleton<5>, skeleton<6>, skeleton<7>, skeleton<8>};

}  // namespace

// table: L records of kRecord int64 (the wrapper's order): cap, bc, gx, gy,
// gz, keys_in, mask_in, bkeys, bmask, bseg, occ, cellslot, valid, nbr6, up
// (0 at the deepest level), first. tile: level-0 rows a skeleton block
// (1..65535). state: int64 words zeroed once per device: a ticket, then B
// * ceil(cap0 / tile) * (L + 1) look-back words; epoch: this call's tag,
// not 0 and not that of an earlier call on the same words. counts [B]
// int32: valid level-0 voxels.
extern "C" int eyoc_brick_pyramid(const long long* table, int B, int L,
                                  int tile, unsigned epoch, void* state,
                                  void* counts, void* stream) {
  if (L < 1 || L > kMaxLevels || tile < 1 || tile > 0xFFFF || epoch == 0)
    return (int)cudaErrorInvalidValue;
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
    lv.first = reinterpret_cast<int*>(r[15]);
    if (lv.bc <= 0 || lv.cap <= 0 || (l + 1 < L) != (lv.up != nullptr) ||
        (r[10] & 7) != 0 || (l > 0 && lv.cap != pyr.lv[l - 1].bc))
      return (int)cudaErrorInvalidValue;
    pyr.start[l + 1] =
        pyr.start[l] + (long long)(lv.up ? 11 : 7) * B * lv.bc;
  }
  const int nt = (pyr.lv[0].cap + tile - 1) / tile;
  auto s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<u64*>(state);
  const SkeletonFn skel = kSkeleton[L - 1];
  skel<<<B * nt, kThreads, 0, s>>>(
      pyr, tile, nt, epoch, reinterpret_cast<unsigned*>(words), words + 1,
      static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = pyr.start[L];
  lookups<<<(unsigned)((n + kLookupThreads - 1) / kLookupThreads),
            kLookupThreads, 0, s>>>(pyr);
  return (int)cudaGetLastError();
}
