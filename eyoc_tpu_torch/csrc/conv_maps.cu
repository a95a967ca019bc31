// K12 conv_maps: every gather map of a ResUNet forward, and the per-tap
// inverses of a train forward, from the brick pyramid.
//
// Replaces eyoc_tpu/sparse/brick_conv.py:95 `halo_parts`, the halo that
// the JAX convs (conv_same, conv_down, conv_up) gather around each brick,
// in the port's form: gather maps [M_out, T] int32 of voxel rows, the
// input row count M_in where a tap reads nothing (see sparse/brick_conv.py):
//
//   same (k^3 taps, level l): output voxel o at cell u of brick B reads
//     the voxel at u + off, reached from B by the z hop, then the y hop,
//     then the x hop through nbr6; an absent brick on the way drops the
//     tap (the dropped diagonal taps of brick_conv.py:20-29);
//   down (27 taps, level l -> l+1): output brick r reads cells [-1, 1]^3
//     of its own base, the same way;
//   up (27 taps, level l+1 -> l): fine cell u of brick B, tap off, reads
//     the coarse voxel at up_slots[B, c] with c = (u - off) / 2 where u -
//     off is 0 or 2 on every axis.
//
// Two launches:
// - tables: cell -> voxel row of every level (an empty cell, per occ, and
//   the sentinel cell take M_l; each valid voxel writes its row at its
//   cell: the two sets of writes are disjoint, so one pass needs no fill
//   before the scatter); the inverses filled with their sentinel, eight
//   words a thread; the entry table (below); the collision count zeroed;
// - maps: one block a run of `rows` output rows of a group of maps that
//   share their rows: a level's voxels (same3, the first conv at level 0,
//   up from level l+1) or a level's bricks (down). The rows of a brick's
//   voxels are contiguous (sorted keys), so the block resolves the
//   neighbourhood of each brick in its run once: the 27 bricks at offsets
//   in [-1, 1]^3, by the same hops (z, then y, then x through nbr6; an
//   absent brick on the way leaves the diagonal absent), and stages their
//   8 cells' voxel rows in shared memory as the 6 x 6 x 6 cube of cells
//   around the brick (a down map's row is its own brick and needs the 8
//   bricks at offsets in [-1, 0]^3), and the coarse voxels of the brick's
//   8 up_slots. The k = 5 first conv stays within one brick of its own:
//   cells 0-1 plus offsets -2..2 lie in -2..3. An entry's index in the
//   cube is its row's base plus its tap's offset (an up map's, its slot
//   from the entry table), and four consecutive entries go out as one
//   16-byte store into the contiguous [rows, T] map. With inverses, each
//   entry that reads a voxel claims inv[voxel, tap] by atomicCAS from the
//   sentinel (a thread's four claims go out together); a claim that finds
//   another row there is a collision, counted on the device. The wrapper
//   copies that count to a pinned host word behind an event, and the conv
//   backward raises on it before it first reads an inverse: the call does
//   not wait for it.
//
// What bounds it: bytes (the maps written once, the pyramid's small
// tables read through L2) and the latency of the hops; no float work. One
// block serves every map of its rows, so a level's rows pay the hops once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxRows = 32;              // output rows a maps block
constexpr int kMaxSegs = 48;
constexpr int kMaxGroups = 2 * kMaxLevels;
constexpr int kLevelRecord = 7;
constexpr int kMapRecord = 7;
constexpr int kFillWords = 8;             // inverse sentinels a thread

enum Kind { kSame = 0, kDown = 1, kUp = 2 };      // the wrapper's map kinds
enum Item { kCells = 0, kVoxels = 1, kFill = 2, kEntries = 3 };

// A brick's stage is the 6 x 6 x 6 cube of cells around it, the cells of
// the bricks at offsets in [-1, 1]^3, at (x * 6 + y) * 6 + z for cell
// coordinates in 0..5 (the brick's own cells at 2..3): a row at cell u
// reads tap o at u + o + 2, so an entry's index is the row's base plus the
// tap's offset, and neighbouring taps read neighbouring words.
// The entry table: each tap's offset for k = 3 and 5; for an up map, each
// (fine cell u, tap) its up slot c, or -1 (no coarse voxel under it).
constexpr int kTab3 = 0, kTab5 = 27, kTabUp = kTab5 + 125,
              kTabSize = kTabUp + 8 * 27;
constexpr int kCube = 6 * 6 * 6;

struct Level {
  int nbtot, m;               // brick rows, voxel rows
  const int* nbr6;            // [6, nbtot]
  const int* cellslot;        // [m], sentinel nbtot * 8
  const bool* occ;            // [nbtot * 8]
  const int* up;              // [nbtot, 8] or null
  int* c2v;                   // [nbtot * 8 + 8], 32-byte aligned
};

// the tables launch: a run of items (a level's cells or voxels, an
// inverse to fill, the entry table), starting at block `start`
struct Seg {
  int kind, level, fill;
  int* out;
  long long n, start;
};

struct TableWork {
  Level lv[kMaxLevels];
  Seg seg[kMaxSegs];
  int n_seg;
};

// one map of a group: its output, its inverse (or null), taps, entry
// table, input rows (the sentinel of its entries), whether it reads the
// up stage
struct Map {
  int* out;
  int* inv;
  int taps, tab, m_in, up;
};

// maps over the same output rows of one level: its voxels or its bricks
struct Group {
  int level, rows, down, n_maps;
  Map map[3];
  long long start;
};

struct MapWork {
  Level lv[kMaxLevels];
  Group g[kMaxGroups];
  int n_groups;
};

__device__ __forceinline__ int table_entry(int e) {
  const bool up = e >= kTabUp;
  const int k = e < kTab5 || up ? 3 : 5;
  const int base = up ? kTabUp : e < kTab5 ? kTab3 : kTab5;
  const int T = k * k * k, u = (e - base) / T, tap = (e - base) % T;
  const int r = k >> 1;
  const int o[3] = {tap / (k * k) - r, (tap / k) % k - r, tap % k - r};
  if (!up) return ((o[0] + 2) * 6 + o[1] + 2) * 6 + o[2] + 2;
  const int c[3] = {u >> 2, (u >> 1) & 1, u & 1};
  int idx = 0;              // tap o of fine cell c reads slot (c - o) / 2
  for (int a = 0; a < 3; ++a) {
    const int d = c[a] - o[a];
    if (d != 0 && d != 2) return -1;
    idx = idx * 2 + (d >> 1);
  }
  return idx;
}

__global__ void __launch_bounds__(kThreads) tables(const TableWork w,
                                                   int* collisions) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *collisions = 0;
  int s = 0;
  while (s + 1 < w.n_seg && (long long)blockIdx.x >= w.seg[s + 1].start) ++s;
  const Seg& sg = w.seg[s];
  const long long e = (blockIdx.x - sg.start) * kThreads + threadIdx.x;
  if (sg.kind == kFill) {
    // kFillWords sentinels a thread, four at a time, neighbouring threads
    // on neighbouring words
    const int4 f = make_int4(sg.fill, sg.fill, sg.fill, sg.fill);
    const long long base = (blockIdx.x - sg.start) * kThreads * kFillWords;
#pragma unroll
    for (int j = 0; j < kFillWords / 4; ++j) {
      const long long q = base + 4 * (j * kThreads + threadIdx.x);
      if (q + 4 <= sg.n) {
        *reinterpret_cast<int4*>(sg.out + q) = f;
      } else {
        for (long long i = q; i < sg.n && i < q + 4; ++i) sg.out[i] = sg.fill;
      }
    }
    return;
  }
  if (e >= sg.n) return;
  if (sg.kind == kEntries) {
    sg.out[e] = table_entry((int)e);
    return;
  }
  const Level& lv = w.lv[sg.level];
  const int nb8 = lv.nbtot * 8;
  if (sg.kind == kCells) {
    if (e == nb8 || !lv.occ[e]) lv.c2v[e] = lv.m;
  } else {
    const int cs = __ldg(lv.cellslot + e);
    if (cs >= 0 && cs < nb8) lv.c2v[cs] = (int)e;
  }
}

constexpr int kStage = (kMaxRows * 27 + kThreads - 1) / kThreads;

__global__ void __launch_bounds__(kThreads) maps(const MapWork w, int rows,
                                                 const int* __restrict__ tab,
                                                 int* collisions) {
  __shared__ int s_base[kMaxRows];        // each row's cube index of cell 0
  __shared__ int s_row[kMaxRows];         // each row's run << 3 | cell
  __shared__ int s_run_brick[kMaxRows];
  __shared__ short s_tab[kTabSize];       // the entry table
  __shared__ int s_vox[kMaxRows * kCube];
  __shared__ int s_up[kMaxRows * 8];
  __shared__ int s_runs;
  int gi = 0;
  while (gi + 1 < w.n_groups && (long long)blockIdx.x >= w.g[gi + 1].start)
    ++gi;
  const Group& g = w.g[gi];
  const Level& lv = w.lv[g.level];
  const int t = threadIdx.x;
  const int o0 = (int)(blockIdx.x - g.start) * rows;
  const int nrows = min(rows, g.rows - o0);
  if (t < 32) {
    // warp 0: each row's brick and cell, and its run of one brick (a scan
    // of the rows where the brick changes)
    int brick = lv.nbtot, cell = 0;
    if (t < nrows) {
      if (g.down) {                   // output row r is brick r, cell 0
        brick = o0 + t;
      } else {
        const int cs = __ldg(lv.cellslot + o0 + t);
        if (cs >= 0 && cs < lv.nbtot * 8) {
          brick = cs >> 3;
          cell = cs & 7;
        }
      }
    }
    const int prev = __shfl_sync(0xFFFFFFFFu, brick, t - 1);
    const int start = t < nrows && (t == 0 || brick != prev);
    int runs = start;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_sync(0xFFFFFFFFu, runs, t - off);
      if (t >= off) runs += o;
    }
    if (t < nrows) {
      s_row[t] = (runs - 1) << 3 | cell;
      s_base[t] = (runs - 1) * kCube +
                  ((cell >> 2) * 6 + ((cell >> 1) & 1)) * 6 + (cell & 1);
      if (start) s_run_brick[runs - 1] = brick;
    }
    if (t == 31) s_runs = runs;
  }
  bool nbrs = false, ups = false;
  for (int m = 0; m < g.n_maps; ++m) {
    nbrs = nbrs || !g.map[m].up;
    ups = ups || g.map[m].up;
  }
#pragma unroll
  for (int j = 0; j < (kTabSize + kThreads - 1) / kThreads; ++j) {
    const int q = t + j * kThreads;           // the loads go out together
    if (q < kTabSize) s_tab[q] = (short)__ldg(tab + q);
  }
  __syncthreads();
  const int runs = s_runs;
  // the 27 bricks around each brick (the z hop, then y, then x; a brick
  // past an absent one is absent) and the voxel rows of their cells, and
  // the coarse voxel under each of the brick's 8 up_slots: kStage items a
  // thread, one dependent step at a time, so that a step's loads go out
  // together
  int b[kStage];
#pragma unroll
  for (int j = 0; j < kStage; ++j) {
    const int e = t + j * kThreads, n = e % 27;
    const bool need = nbrs && e < runs * 27 &&
                      (!g.down || (n / 9 < 2 && (n / 3) % 3 < 2 &&
                                   n % 3 < 2));
    b[j] = need ? s_run_brick[e / 27] : lv.nbtot;
  }
  int up_slot = 0;
  const bool up_item = ups && t < runs * 8;
  if (up_item) {
    const int ub = s_run_brick[t >> 3];
    up_slot = ub < lv.nbtot ? __ldg(lv.up + (long long)ub * 8 + (t & 7))
                            : w.lv[g.level + 1].nbtot * 8;
  }
#pragma unroll
  for (int axis = 2; axis >= 0; --axis) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int n = (t + j * kThreads) % 27;
      const int d = (axis == 0 ? n / 9 : axis == 1 ? (n / 3) % 3 : n % 3) - 1;
      if (d != 0 && b[j] < lv.nbtot)
        b[j] = __ldg(lv.nbr6 + (long long)(2 * axis + (d > 0)) * lv.nbtot +
                     b[j]);
    }
    if (axis == 2 && up_item) s_up[t] = w.lv[g.level + 1].c2v[up_slot];
  }
  if (nbrs) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int e = t + j * kThreads;
      if (e >= runs * 27) break;
      int4 lo = make_int4(lv.m, lv.m, lv.m, lv.m), hi = lo;
      if (b[j] < lv.nbtot) {
        const int4* src = reinterpret_cast<const int4*>(lv.c2v + b[j] * 8);
        lo = src[0];
        hi = src[1];
      }
      // brick offset n's cells in the cube: x = 2 dx + cx + 2, ...
      const int n = e % 27;
      int* dst = s_vox + e / 27 * kCube +
                 ((n / 9 * 2) * 6 + (n / 3) % 3 * 2) * 6 + n % 3 * 2;
      const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int c = 0; c < 8; ++c)
        dst[((c >> 2) * 6 + ((c >> 1) & 1)) * 6 + (c & 1)] = v[c];
    }
  }
  __syncthreads();
  // each map's entries [o0 * T, (o0 + nrows) * T), four consecutive ones a
  // thread: one 16-byte store, and claims that go out together
  int coll = 0;
  for (int m = 0; m < g.n_maps; ++m) {
    const Map& mp = g.map[m];
    const int T = mp.taps;
    const short* tb = s_tab + mp.tab;
    int* out = mp.out + (long long)o0 * T;
    const int n = nrows * T;
    const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (int q = 4 * t; q < n; q += 4 * kThreads) {
      int v[4], rr[4], tt[4];
      int r = q / T, tap = q - r * T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rr[j] = r;
        tt[j] = tap;
        if (++tap == T) {
          tap = 0;
          ++r;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rj = min(rr[j], nrows - 1);
        if (mp.up) {
          const int row = s_row[rj];
          const int i = tb[(row & 7) * T + tt[j]];
          v[j] = i >= 0 ? s_up[(row >> 3) * 8 + i] : mp.m_in;
        } else {
          v[j] = s_vox[s_base[rj] + tb[tt[j]]];
        }
      }
      if (mp.inv != nullptr) {
        int old[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool claim = q + j < n && v[j] >= 0 && v[j] < mp.m_in;
          old[j] = claim ? atomicCAS(mp.inv + (long long)v[j] * T + tt[j],
                                     g.rows, o0 + rr[j])
                         : g.rows;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) coll += old[j] != g.rows;
      }
      if (vec && q + 4 <= n) {
        *reinterpret_cast<int4*>(out + q) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && q + j < n; ++j) out[q + j] = v[j];
      }
    }
  }
  if (coll) atomicAdd(collisions, coll);
}

long long item_blocks(long long n) { return (n + kThreads - 1) / kThreads; }

// append a run of items; returns false when the table is full
bool push(TableWork& w, long long& blocks, Seg s, long long nblocks) {
  if (w.n_seg == kMaxSegs) return false;
  s.start = blocks;
  blocks += nblocks;
  if (s.n > 0) w.seg[w.n_seg++] = s;
  return true;
}

}  // namespace

// levels: L records of kLevelRecord int64: nbtot, m, nbr6, cellslot, occ,
// up_slots (0 where no up map reads it), c2v ([nbtot * 8 + 8] int32, out,
// 32-byte aligned). maps: n_maps records of kMapRecord int64: kind (0
// same, 1 down, 2 up), level (the fine one for up), k, rows, m_in, out
// ([rows, k^3] int32), inv ([m_in, 27] int32, 16-byte aligned, or 0); at
// most one same map of each k, one up and one down map a level. rows:
// output rows a maps block (1..32). table: kTabSize int32 (scratch, the
// entry table). collisions: one int32 (out).
extern "C" int eyoc_conv_maps(const long long* levels, int L,
                              const long long* maps_table, int n_maps,
                              int rows, void* table, void* collisions,
                              void* stream) {
  if (L < 1 || L > kMaxLevels || n_maps < 0 || rows < 1 || rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  TableWork a;
  MapWork b;
  a.n_seg = b.n_groups = 0;
  long long blocks_a = 0;
  auto* tab = static_cast<int*>(table);
  push(a, blocks_a, Seg{kEntries, 0, 0, tab, kTabSize, 0},
       item_blocks(kTabSize));
  int vox_group[kMaxLevels];
  for (int l = 0; l < L; ++l) {
    const long long* r = levels + l * kLevelRecord;
    Level lv;
    lv.nbtot = (int)r[0];
    lv.m = (int)r[1];
    lv.nbr6 = reinterpret_cast<const int*>(r[2]);
    lv.cellslot = reinterpret_cast<const int*>(r[3]);
    lv.occ = reinterpret_cast<const bool*>(r[4]);
    lv.up = reinterpret_cast<const int*>(r[5]);
    lv.c2v = reinterpret_cast<int*>(r[6]);
    if (r[6] & 31) return (int)cudaErrorInvalidValue;
    a.lv[l] = b.lv[l] = lv;
    vox_group[l] = -1;
    const long long ncells = (long long)lv.nbtot * 8 + 1;
    if (!push(a, blocks_a, Seg{kCells, l, 0, nullptr, ncells, 0},
              item_blocks(ncells)) ||
        !push(a, blocks_a, Seg{kVoxels, l, 0, nullptr, lv.m, 0},
              item_blocks(lv.m)))
      return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_maps; ++i) {
    const long long* r = maps_table + i * kMapRecord;
    const int kind = (int)r[0], l = (int)r[1], k = (int)r[2];
    const int out_rows = (int)r[3], m_in = (int)r[4];
    Map mp;
    mp.out = reinterpret_cast<int*>(r[5]);
    mp.inv = reinterpret_cast<int*>(r[6]);
    mp.taps = k * k * k;
    mp.tab = kind == kUp ? kTabUp : k == 5 ? kTab5 : kTab3;
    mp.m_in = m_in;
    mp.up = kind == kUp;
    const bool bad_up = kind == kUp &&
                        (l + 1 >= L || a.lv[l].up == nullptr);
    if (kind < kSame || kind > kUp || l < 0 || l >= L || bad_up ||
        (kind != kSame && k != 3) || (k != 3 && k != 5) ||
        (mp.inv && (mp.taps != 27 || (r[6] & 15) != 0)))
      return (int)cudaErrorInvalidValue;
    // the group of the map's rows: the level's voxels, or a down map's own
    int gi = kind == kDown ? -1 : vox_group[l];
    if (gi < 0) {
      if (b.n_groups == kMaxGroups) return (int)cudaErrorInvalidValue;
      gi = b.n_groups++;
      b.g[gi].level = l;
      b.g[gi].rows = out_rows;
      b.g[gi].down = kind == kDown;
      b.g[gi].n_maps = 0;
      if (kind != kDown) vox_group[l] = gi;
    }
    Group& g = b.g[gi];
    if (g.rows != out_rows || g.n_maps == 3)
      return (int)cudaErrorInvalidValue;
    g.map[g.n_maps++] = mp;
    if (mp.inv != nullptr) {
      const long long n = (long long)m_in * mp.taps;
      if (!push(a, blocks_a, Seg{kFill, l, out_rows, mp.inv, n, 0},
                item_blocks((n + kFillWords - 1) / kFillWords)))
        return (int)cudaErrorInvalidValue;
    }
  }
  long long blocks_b = 0;
  for (int gi = 0; gi < b.n_groups; ++gi) {
    b.g[gi].start = blocks_b;
    blocks_b += (b.g[gi].rows + rows - 1) / rows;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto* coll = static_cast<int*>(collisions);
  tables<<<(unsigned)blocks_a, kThreads, 0, st>>>(a, coll);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks_b == 0) return (int)err;
  maps<<<(unsigned)blocks_b, kThreads, 0, st>>>(b, rows, tab, coll);
  return (int)cudaGetLastError();
}
