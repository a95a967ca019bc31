// K4: SC2-PCR's second-order compatibility on the seed rows, as exact
// integer counts, and the k1 columns of each seed row that the consensus
// keeps.
//
// Replaces eyoc_tpu/registration/sc2pcr.py:sc2_pcr (:296-300), which builds
// the [N, N] bf16 masks `hard` and `hard_tight` and runs the
// [S, N] @ [N, N] product on the matrix unit, and the k1 top-k of its
// consumer _seed_transforms (:165-169):
//
//   SC2[s, j] = hard[seed_s, j] * sum_k tight[seed_s, k] * tight[k, j]
//   hard = valid pair & |dS - dT| < d,  tight = valid pair & |dS - dT| < d/2
//   key[s, j] = valid[j] ? SC2[s, j] : -1
//   idx[s, :] = the k columns of largest key, by (key desc, j asc)
//
// What bounds it: S * N * N binary multiply-adds (1000 x 5000 x 5000 =
// 25 G on the main path), i.e. operations; the bound is taken at the int8
// tensor-core rate. No [S, N] tensor is needed: the consumer keeps k1 = 30
// columns a row.
// Design:
// - pack_masks: tight and hard packed into [Np, Wp] uint32 rows each (Wp =
//   ceil(N / 256) * 8 words, Np = 32 Wp rows; rows past N and words past
//   ceil(N / 32) are zero). Both are symmetric (|a - b| and |b - a| are the
//   same bits), so a warp takes a 32 x 32 block (I, J) of the upper
//   triangle (one warp a block, in row order): a ballot per row gives the
//   words of rows 32 I.. at word J, and the bits each lane collects over
//   the 32 rows the words of rows 32 J.. at word I. Each unordered pair is
//   tested once, for both thresholds. Distances use the _rn intrinsics in
//   the order sqrt((dx*dx + dy*dy) + dz*dz), so the threshold tests match
//   the plain version bit for bit.
// - The product on tensor cores: column j of the product is row j of the
//   tight packing, so a seed row and a column are both packed rows, the
//   row.col operands of mma.sync.m16n8k256.b1.and.popc: 256 binary
//   products a lane pair of words, summed exactly in s32. (On the H100 it
//   issues at the rate of the s8 m16n8k32, so it does 8x the products of
//   an int8 MMA; profile_k4_mma.py measures both.) A block holds 64 seed
//   rows (all words) in shared memory and walks 64-column tiles of its
//   split of the columns, each tile's 64 rows (all words) copied in by
//   cp.async while the previous tile's selection runs; 16 warps, each a
//   16 x 16 corner of the tile. The words a lane feeds into a register are
//   the same for A and B, which is all the sum over k needs. The epilogue
//   takes `hard` from the seed rows' packed words over the tile.
// - sc2_seed_counts stores the [S, N] f32 counts. sc2_seed_topk stores none:
//   each key becomes the composite ((key + 1) << 16) | (65535 - j), larger
//   is better and no two are equal (N < 65536), and a warp keeps, for each
//   of its 4 seed rows, the split's best k composites in its lanes (sorted,
//   one a lane). A half-tile of 32 composites in which one beats a row's
//   k-th is merged in: sorted by a bitonic network, reversed, met lane by
//   lane with the list, and the bitonic result merged.
// - A third launch merges each seed row's split lists (one warp a row, one
//   lane a list head, the best head by __reduce_max_sync, k times). Exact
//   by the argument of _chunked_topk: an element of the global top k is in
//   the top k of its split. Two launches for the counts, three for the
//   top k; the splits are chosen by the caller so that the product's
//   blocks are one wave (registration/sc2pcr.py:k4_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // seed rows per block
constexpr int kBN = 64;          // columns per tile
constexpr int kWarpsM = 4;       // warps over the tile's rows ...
constexpr int kWarpsN = 4;       // ... and columns in the product
constexpr int kWarps = kWarpsM * kWarpsN;
constexpr int kThreads = 32 * kWarps;
constexpr int kMI = kBM / kWarpsM / 16;    // m16 tiles a warp
constexpr int kNI = kBN / kWarpsN / 8;     // n8 tiles a warp
constexpr int kRows = kBM / kWarps;        // seed rows a warp selects for
constexpr int kKeyStride = kBN + 8;
constexpr int kMaxK = 32;        // a lane per list entry
constexpr int kMaxSplits = 32;   // a lane per split list in the merge
constexpr int kMergeWarps = 8;
constexpr int kPackWarps = 8;

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz)));
}

// shared-memory words per packed row: a multiple of 8 that is 8 or 24 mod
// 32, so the 64-bit loads of rows g = 0..3 of a half-warp hit distinct banks
__host__ __device__ __forceinline__ int row_stride(int wp) {
  return wp % 16 == 0 ? wp + 8 : wp;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int wp) {
  return (size_t)(kBM + kBN) * row_stride(wp) * 4 +
         (size_t)kBM * kKeyStride * 4;
}

// One warp per 32 x 32 block (I, J), I <= J, of the padded matrices (the
// blocks of the upper triangle, row by row: every warp has one), both
// thresholds from one distance test a pair. The block's 32 rows are staged
// in shared memory, (x, y, z, valid) of src and (x, y, z) of tgt.
__global__ void __launch_bounds__(32 * kPackWarps) pack_masks(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const uint8_t* __restrict__ valid, int n, int wp, float hard_thr,
    float tight_thr, uint32_t* __restrict__ tight,
    uint32_t* __restrict__ hard) {
  __shared__ float4 s_rows[kPackWarps][32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long t = (long)blockIdx.x * kPackWarps + warp;
  if (t >= (long)wp * (wp + 1) / 2) return;  // whole warps exit together
  // row I of the triangle starts at pair I wp - I (I - 1) / 2
  auto start = [wp](long I) { return I * wp - I * (I - 1) / 2; };
  const float b = 2.f * wp + 1.f;
  long I = (long)((b - sqrtf(fmaxf(b * b - 8.f * (float)t, 0.f))) * 0.5f);
  while (I > 0 && start(I) > t) --I;
  while (start(I + 1) <= t) ++I;
  const int J = (int)(I + t - start(I));
  const int i = 32 * (int)I + lane, j = 32 * J + lane;
  const bool vi = i < n && valid[i];
  const bool vj = j < n && valid[j];
  s_rows[warp][lane][0] = vi ? make_float4(src[3 * i], src[3 * i + 1],
                                           src[3 * i + 2], 1.f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  s_rows[warp][lane][1] = vi ? make_float4(tgt[3 * i], tgt[3 * i + 1],
                                           tgt[3 * i + 2], 0.f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  float sx = 0.f, sy = 0.f, sz = 0.f, tx = 0.f, ty = 0.f, tz = 0.f;
  if (vj) {
    sx = src[3 * j], sy = src[3 * j + 1], sz = src[3 * j + 2];
    tx = tgt[3 * j], ty = tgt[3 * j + 1], tz = tgt[3 * j + 2];
  }
  __syncwarp();
  uint32_t trow = 0, tcol = 0, hrow = 0, hcol = 0;
  if (32 * I < n) {
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const float4 a = s_rows[warp][r][0], c = s_rows[warp][r][1];
      // every lane computes (an invalid row or column is zeros), so the
      // unrolled rows interleave
      const float d = fabsf(__fsub_rn(dist3(a.x, a.y, a.z, sx, sy, sz),
                                      dist3(c.x, c.y, c.z, tx, ty, tz)));
      const bool ok = vj && a.w != 0.f;
      const uint32_t wt = __ballot_sync(0xffffffffu, ok && d < tight_thr);
      const uint32_t wh = __ballot_sync(0xffffffffu, ok && d < hard_thr);
      if (lane == r) trow = wt, hrow = wh;
      tcol |= ((wt >> lane) & 1u) << r;
      hcol |= ((wh >> lane) & 1u) << r;
    }
  }
  tight[(size_t)i * wp + J] = trow;
  hard[(size_t)i * wp + J] = hrow;
  if (I != J) {
    tight[(size_t)j * wp + I] = tcol;
    hard[(size_t)j * wp + I] = hcol;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// kRowsIn packed rows into sm (row stride `stride` words): rows[r], or
// first + r when rows is null; a row index < 0 is a zero row
template <int kRowsIn>
__device__ __forceinline__ void stage_rows(uint32_t* sm, int stride,
                                           const uint32_t* bits, int wp,
                                           const int* rows, int first) {
  const int chunks = wp / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kRowsIn * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    uint32_t* dst = sm + r * stride + 4 * c;
    const int row = rows ? rows[r] : first + r;
    if (row >= 0)
      cp_async16(dst, bits + (size_t)row * wp + 4 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The warp's corner of the tile's counts: acc[mi][ni][q] is row
// 16 (kMI wm + mi) + g (+ 8 for q >= 2), column 8 (kNI wn + ni) + 2 tig +
// (q & 1), for wm = warp / kWarpsN, wn = warp % kWarpsN.
__device__ __forceinline__ void tile_counts(const uint32_t* sA,
                                            const uint32_t* sB, int stride,
                                            int wp, int (&acc)[kMI][kNI][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;
  const uint32_t* pa = sA + (16 * kMI * wm + g) * stride + 2 * tig;
  const uint32_t* pb = sB + (8 * kNI * wn + g) * stride + 2 * tig;
#pragma unroll 2
  for (int w0 = 0; w0 < wp; w0 += 8) {
    uint2 a[kMI][2], b[kNI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      a[mi][0] = *reinterpret_cast<const uint2*>(pa + (16 * mi) * stride + w0);
      a[mi][1] =
          *reinterpret_cast<const uint2*>(pa + (16 * mi + 8) * stride + w0);
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
      b[ni] = *reinterpret_cast<const uint2*>(pb + (8 * ni) * stride + w0);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
        mma_b1(acc[mi][ni], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y,
               b[ni].x, b[ni].y);
  }
}

// v sorted descending over the warp's lanes (a bitonic network)
__device__ __forceinline__ uint32_t warp_sort_desc(uint32_t v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool desc = (lane & size) == 0;  // size 32: every lane
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool lower = (lane & stride) == 0;
      v = lower == desc ? max(v, o) : min(v, o);
    }
  }
  return v;
}

// The best k of a descending list (lanes 0..k-1, 0 past k) and a batch of
// 32 (a lane each), as a descending list: the batch sorted, reversed and
// met lane by lane with the list (the best 32 of both, a bitonic
// sequence), then a bitonic merge.
__device__ __forceinline__ uint32_t merge_batch(uint32_t list, uint32_t v,
                                                int lane, int k) {
  v = warp_sort_desc(v, lane);
  uint32_t m = max(list, __shfl_sync(0xffffffffu, v, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, m, stride);
    m = (lane & stride) == 0 ? max(m, o) : min(m, o);
  }
  return lane < k ? m : 0u;
}

// Block (group, split): seed rows 64 group.., the column tiles of the split.
// kTopk: each row's best k composites of the split to cand[s][split][k];
// else the counts to out[s][j] as f32.
template <bool kTopk>
__global__ void __launch_bounds__(kThreads, 2) seed_product(
    const uint32_t* __restrict__ tight, const uint32_t* __restrict__ hard,
    int wp, const int* __restrict__ seeds, int ns,
    const uint8_t* __restrict__ valid, int n, int k,
    uint32_t* __restrict__ cand, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_row[kBM];
  __shared__ uint32_t s_hard[kBM][kBN / 32];
  const int stride = row_stride(wp);
  uint32_t* sA = smem;
  uint32_t* sB = sA + kBM * stride;
  uint32_t* sKey = sB + kBN * stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int s0 = blockIdx.x * kBM;
  const int splits = gridDim.y, split = blockIdx.y;
  const int tiles = (n + kBN - 1) / kBN;
  const int t_begin = (int)((long)tiles * split / splits);
  const int t_end = (int)((long)tiles * (split + 1) / splits);

  if (threadIdx.x < kBM) {
    const int s = s0 + threadIdx.x;
    s_row[threadIdx.x] = s < ns ? seeds[s] : -1;
  }
  __syncthreads();
  stage_rows<kBM>(sA, stride, tight, wp, s_row, 0);
  // each tile: its 64 tight rows, and the seed rows' hard words over it
  auto stage_tile = [&](int t) {
    stage_rows<kBN>(sB, stride, tight, wp, nullptr, t * kBN);
    if (threadIdx.x < kBM * (kBN / 32)) {
      const int r = threadIdx.x / (kBN / 32), w = threadIdx.x % (kBN / 32);
      const int i = s_row[r];
      s_hard[r][w] = i >= 0 ? hard[(size_t)i * wp + t * (kBN / 32) + w] : 0u;
    }
  };
  stage_tile(t_begin);

  // the warp's rows' lists: lane l holds entry l (0 = empty)
  uint32_t list[kRows], theta[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) list[rr] = theta[rr] = 0u;

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kBN;
    cp_async_wait_all();
    __syncthreads();
    int acc[kMI][kNI][4];
    tile_counts(sA, sB, stride, wp, acc);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 16 * (kMI * wm + mi) + g + 8 * (q >> 1);
          const int cl = 8 * (kNI * wn + ni) + 2 * tig + (q & 1);
          const int j = j0 + cl;
          const bool h = (s_hard[r][cl >> 5] >> (cl & 31)) & 1u;
          const int cnt = h ? acc[mi][ni][q] : 0;  // hard holds both valids
          if constexpr (kTopk) {
            uint32_t c = 0u;  // a padded column: below every real one
            if (j < n) {
              const int key = valid[j] ? cnt : -1;
              c = ((uint32_t)(key + 1) << 16) | (uint32_t)(0xffff - j);
            }
            sKey[r * kKeyStride + cl] = c;
          } else {
            if (s0 + r < ns && j < n)
              out[(size_t)(s0 + r) * n + j] = (float)cnt;
          }
        }
    __syncthreads();  // sB and s_hard are free, sKey is full
    if (t + 1 < t_end) stage_tile(t + 1);
    if constexpr (kTopk) {
      // the warp's rows kRows warp ..: merge each half-tile of composites
      // into the lists when one of them beats a row's k-th
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t mine[kRows];
        bool any = false;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          mine[rr] = sKey[(kRows * warp + rr) * kKeyStride + 32 * half + lane];
          any |= mine[rr] > theta[rr];
        }
        if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          list[rr] = merge_batch(list[rr], mine[rr], lane, k);
          theta[rr] = __shfl_sync(0xffffffffu, list[rr], k - 1);
        }
      }
    }
  }
  if constexpr (kTopk) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int s = s0 + kRows * warp + rr;
      if (s < ns && lane < k)
        cand[((size_t)s * splits + split) * k + lane] = list[rr];
    }
  }
}

// One warp per seed row: the k best of its split lists, in order.
__global__ void __launch_bounds__(32 * kMergeWarps) merge_splits(
    const uint32_t* __restrict__ cand, int ns, int splits, int k,
    int* __restrict__ idx) {
  __shared__ uint32_t s_cand[kMergeWarps][kMaxSplits * kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kMergeWarps + warp;
  if (s >= ns) return;  // whole warps exit together
  const int len = splits * k;
  uint32_t* mine = s_cand[warp];
  for (int e = lane; e < len; e += 32) mine[e] = cand[(size_t)s * len + e];
  __syncwarp();
  int pos = 0;
  uint32_t head = lane < splits ? mine[lane * k] : 0u;
  uint32_t out = 0u;
  for (int t = 0; t < k; ++t) {
    const uint32_t best = __reduce_max_sync(0xffffffffu, head);
    if (lane == t) out = best;
    if (head == best && lane < splits) {
      ++pos;
      head = pos < k ? mine[lane * k + pos] : 0u;
    }
  }
  if (lane < k) idx[(size_t)s * k + lane] = 0xffff - (int)(out & 0xffffu);
}

// shared memory a block may take: 227 KB less the static s_row and s_hard
constexpr size_t kSmemMax = 232448 - kBM * 4 - kBM * (kBN / 32) * 4;

// lets the kernel take `bytes` of dynamic shared memory (raised as needed)
template <bool kTopk>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      seed_product<kTopk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

int words(int n) { return (n + 255) / 256 * 8; }

bool bad_shape(int n, int splits) {
  return n >= 65536 || splits < 1 || splits > kMaxSplits ||
         splits > (n + kBN - 1) / kBN || smem_bytes(words(n)) > kSmemMax;
}

// the packing, then the product; bits holds tight, then hard
template <bool kTopk>
int launch(const void* src, const void* tgt, const void* valid, int n,
           const void* seeds, int ns, float hard_thr, float tight_thr, int k,
           int splits, void* bits, void* cand, void* out, cudaStream_t s) {
  const int wp = words(n);
  auto* tight = static_cast<uint32_t*>(bits);
  uint32_t* hard = tight + (size_t)32 * wp * wp;
  auto* pvalid = static_cast<const uint8_t*>(valid);
  const long pairs = (long)wp * (wp + 1) / 2;
  pack_masks<<<(unsigned)((pairs + kPackWarps - 1) / kPackWarps),
               32 * kPackWarps, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt), pvalid,
      n, wp, hard_thr, tight_thr, tight, hard);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (cudaError_t e = allow_smem<kTopk>(smem_bytes(wp))) return (int)e;
  dim3 grid((ns + kBM - 1) / kBM, splits);
  seed_product<kTopk><<<grid, kThreads, smem_bytes(wp), s>>>(
      tight, hard, wp, static_cast<const int*>(seeds), ns, pvalid, n, k,
      static_cast<uint32_t*>(cand), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the product kernel that the current device holds at once
// (occupancy x SMs) for n points, for the caller's choice of splits; 0 on
// an error or an n too large.
extern "C" int eyoc_sc2_seed_resident(int n) {
  int device = 0, sms = 0, per_sm = 0;
  if (n <= 0 || bad_shape(n, 1) ||
      allow_smem<true>(smem_bytes(words(n))) != cudaSuccess ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, seed_product<true>, kThreads, smem_bytes(words(n))) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// src/tgt [n, 3] f32, valid [n] bool, seeds [ns] int32 rows in [0, n);
// bits: 2 * 32 Wp * Wp uint32 scratch, Wp = ceil(n / 256) * 8 (the packed
// tight and hard matrices); splits of the columns, 1..32, from the
// caller's plan; out [ns, n] f32.
extern "C" int eyoc_sc2_seed_counts(const void* src, const void* tgt,
                                    const void* valid, int n,
                                    const void* seeds, int ns, float hard_thr,
                                    float tight_thr, int splits, void* bits,
                                    void* out, void* stream) {
  if (n <= 0 || ns <= 0) return 0;
  if (bad_shape(n, splits)) return (int)cudaErrorInvalidValue;
  return launch<false>(src, tgt, valid, n, seeds, ns, hard_thr, tight_thr, 0,
                       splits, bits, nullptr, out,
                       static_cast<cudaStream_t>(stream));
}

// As eyoc_sc2_seed_counts, then idx [ns, k] int32: each seed row's k
// columns of largest key (valid[j] ? SC2 : -1), by (key desc, j asc);
// 1 <= k <= min(32, n). cand: ns * splits * k uint32 scratch.
extern "C" int eyoc_sc2_seed_topk(const void* src, const void* tgt,
                                  const void* valid, int n, const void* seeds,
                                  int ns, float hard_thr, float tight_thr,
                                  int k, int splits, void* bits, void* cand,
                                  void* idx, void* stream) {
  if (n <= 0 || ns <= 0) return 0;
  if (bad_shape(n, splits) || k < 1 || k > kMaxK || k > n)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (int e = launch<true>(src, tgt, valid, n, seeds, ns, hard_thr, tight_thr,
                           k, splits, bits, cand, nullptr, s))
    return e;
  merge_splits<<<(ns + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
                 s>>>(static_cast<const uint32_t*>(cand), ns, splits, k,
                      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}
