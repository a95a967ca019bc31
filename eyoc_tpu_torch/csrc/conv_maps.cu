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
//   before the scatter); the inverses filled with their sentinel; the
//   collision count zeroed;
// - maps: one thread an (output row, tap) of every map, in row-major
//   order, so the outputs are contiguous [M_out, T] int32. With inverses,
//   each entry that reads a voxel claims inv[voxel, tap] by atomicCAS
//   from the sentinel; a claim that finds another row there is a
//   collision, counted on the device. The wrapper reads that count once a
//   call and raises, as invert_map does.
//
// What bounds it: bytes (the maps written once, the pyramid's small
// tables read through L2); no float work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxSegs = 40;
constexpr int kLevelRecord = 7;
constexpr int kMapRecord = 7;

enum Kind { kSame = 0, kDown = 1, kUp = 2, kCells = 3, kVoxels = 4,
            kFill = 5 };

struct Level {
  int nbtot, m;               // brick rows, voxel rows
  const int* nbr6;            // [6, nbtot]
  const int* cellslot;        // [m], sentinel nbtot * 8
  const bool* occ;            // [nbtot * 8]
  const int* up;              // [nbtot, 8] or null
  int* c2v;                   // [nbtot * 8 + 1]
};

// a run of work items: a map (rows x taps entries), a level's cells or
// voxels, or an inverse to fill; it starts at block `start`
struct Seg {
  int kind, level, k, taps, rows, m_in;
  int* out;
  int* inv;
  long long n, start;
};

struct Work {
  Level lv[kMaxLevels];
  Seg seg[kMaxSegs];
  int n_seg;
};

__device__ __forceinline__ int tap_source(const Level& lv, int brick, int ux,
                                          int uy, int uz, int t, int k) {
  const int r = k >> 1;
  const int p[3] = {ux + t / (k * k) - r, uy + (t / k) % k - r,
                    uz + t % k - r};
  const int cell = ((p[0] & 1) << 2) | ((p[1] & 1) << 1) | (p[2] & 1);
  int b = brick;
  for (int axis = 2; axis >= 0; --axis) {   // the z hop first, then y, x
    const int d = p[axis] >> 1;             // -1, 0 or 1
    if (d != 0 && b < lv.nbtot)
      b = __ldg(lv.nbr6 + (long long)(2 * axis + (d > 0)) * lv.nbtot + b);
  }
  return lv.c2v[b < lv.nbtot ? b * 8 + cell : lv.nbtot * 8];
}

__device__ __forceinline__ const Seg& find_seg(const Work& w) {
  int s = 0;
  while (s + 1 < w.n_seg && (long long)blockIdx.x >= w.seg[s + 1].start) ++s;
  return w.seg[s];
}

__global__ void __launch_bounds__(kThreads) tables(const Work w,
                                                   int* collisions) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *collisions = 0;
  const Seg& sg = find_seg(w);
  const long long e = (blockIdx.x - sg.start) * kThreads + threadIdx.x;
  if (e >= sg.n) return;
  if (sg.kind == kFill) {
    sg.out[e] = sg.rows;
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

__global__ void __launch_bounds__(kThreads) maps(const Work w,
                                                 int* collisions) {
  const Seg& sg = find_seg(w);
  const long long e = (blockIdx.x - sg.start) * kThreads + threadIdx.x;
  if (e >= sg.n) return;
  const int o = (int)(e / sg.taps);
  const int t = (int)(e - (long long)o * sg.taps);
  const Level& lv = w.lv[sg.level];
  int v;
  if (sg.kind == kDown) {
    v = tap_source(lv, o, 0, 0, 0, t, 3);
  } else {
    const int cs = __ldg(lv.cellslot + o);
    const int ux = (cs >> 2) & 1, uy = (cs >> 1) & 1, uz = cs & 1;
    const int brick = cs >> 3;
    if (sg.kind == kSame) {
      v = tap_source(lv, brick, ux, uy, uz, t, sg.k);
    } else {                          // kUp: level l+1 into level l
      const Level& cl = w.lv[sg.level + 1];
      const int ex = ux - (t / 9 - 1), ey = uy - ((t / 3) % 3 - 1),
                ez = uz - (t % 3 - 1);
      if ((ex == 0 || ex == 2) && (ey == 0 || ey == 2) &&
          (ez == 0 || ez == 2)) {
        const int c = (ex >> 1) * 4 + (ey >> 1) * 2 + (ez >> 1);
        const int slot = brick < lv.nbtot
                             ? __ldg(lv.up + (long long)brick * 8 + c)
                             : cl.nbtot * 8;
        v = cl.c2v[slot];
      } else {
        v = cl.m;
      }
    }
  }
  sg.out[e] = v;
  if (sg.inv != nullptr && v >= 0 && v < sg.m_in) {
    const int old = atomicCAS(sg.inv + (long long)v * sg.taps + t, sg.rows, o);
    if (old != sg.rows) atomicAdd(collisions, 1);
  }
}

// append a run of n items; returns false when the table is full
bool push(Work& w, long long& blocks, Seg s) {
  if (w.n_seg == kMaxSegs) return false;
  s.start = blocks;
  blocks += (s.n + kThreads - 1) / kThreads;
  if (s.n > 0) w.seg[w.n_seg++] = s;
  return true;
}

}  // namespace

// levels: L records of kLevelRecord int64: nbtot, m, nbr6, cellslot, occ,
// up_slots (0 where no up map reads it), c2v ([nbtot * 8 + 1] int32, out).
// maps: n_maps records of kMapRecord int64: kind (0 same, 1 down, 2 up),
// level (the fine one for up), k, rows, m_in, out ([rows, k^3] int32), inv
// ([m_in, 27] int32 or 0). collisions: one int32 (out).
extern "C" int eyoc_conv_maps(const long long* levels, int L,
                              const long long* maps_table, int n_maps,
                              void* collisions, void* stream) {
  if (L < 1 || L > kMaxLevels || n_maps < 0) return (int)cudaErrorInvalidValue;
  Work a, b;
  a.n_seg = b.n_seg = 0;
  long long blocks_a = 0, blocks_b = 0;
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
    a.lv[l] = b.lv[l] = lv;
    Seg cells = {kCells, l, 0, 0, 0, 0, nullptr, nullptr,
                 (long long)lv.nbtot * 8 + 1, 0};
    Seg vox = {kVoxels, l, 0, 0, 0, 0, nullptr, nullptr, (long long)lv.m, 0};
    if (!push(a, blocks_a, cells) || !push(a, blocks_a, vox))
      return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_maps; ++i) {
    const long long* r = maps_table + i * kMapRecord;
    Seg s;
    s.kind = (int)r[0];
    s.level = (int)r[1];
    s.k = (int)r[2];
    s.taps = s.k * s.k * s.k;
    s.rows = (int)r[3];
    s.m_in = (int)r[4];
    s.out = reinterpret_cast<int*>(r[5]);
    s.inv = reinterpret_cast<int*>(r[6]);
    s.n = (long long)s.rows * s.taps;
    const bool bad_up = s.kind == kUp &&
                        (s.level + 1 >= L || a.lv[s.level].up == nullptr);
    if (s.kind < kSame || s.kind > kUp || s.level < 0 || s.level >= L ||
        bad_up || (s.kind != kSame && s.k != 3) || (s.inv && s.taps != 27))
      return (int)cudaErrorInvalidValue;
    if (!push(b, blocks_b, s)) return (int)cudaErrorInvalidValue;
    if (s.inv != nullptr) {
      Seg fill = {kFill, s.level, 0, 0, s.rows, 0, s.inv, nullptr,
                  (long long)s.m_in * s.taps, 0};
      if (!push(a, blocks_a, fill)) return (int)cudaErrorInvalidValue;
    }
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto* coll = static_cast<int*>(collisions);
  tables<<<(unsigned)blocks_a, kThreads, 0, st>>>(a, coll);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks_b == 0) return (int)err;
  maps<<<(unsigned)blocks_b, kThreads, 0, st>>>(b, coll);
  return (int)cudaGetLastError();
}
