// K5 sparse_conv_wgrad: the weight gradient of K1's gathered convolution,
// on bf16 tensor cores.
//
// Replaces the weight half of the backward that JAX derives for
// eyoc_tpu/sparse/brick_conv.py conv_same / conv_down / conv_up / conv1x1
// and fb_concat (:310-388): there the transpose of the halo matmul
// `H^T @ dY` followed by the transpose of the weight embedding. With the
// port's explicit gather maps the same gradient is, per tap t,
//
//   dW[t, k, n] = sum_o  in[map[o, t], k] * dY[o, n]
//
// in = concat(xa [M_in, Ca], xb [M_in, Cb]) along channels (xb optional, the
// decoder's skip concat), bf16; dY [M_out, Co] bf16; map [M_out, T] int32
// whose values outside [0, M_in) read a zero row; dW [T, Ca+Cb, Co] f32.
//
// What bounds it: at the train step's shapes (ResUNetBN2C at B = 8, 512-
// 131072 output rows, 27 or 125 taps, 1-256 in-channels, 32-256 out) a call
// moves a few MB to ~40 MB (the int32 map and dY at level 0) against at
// most a few GFLOP of tap products that hit a voxel: at the bf16 tensor-core
// peak it is bound by bytes. Per tap it is a GEMM whose K is the output rows
// (up to 131072) and whose M and N are the channels (1-256). K1's tile
// machinery (sparse_conv.cu), transposed:
// - A block owns one tap, one BM x BN tile of dW[t] (BM in-channels, BN
//   out-channels; four warps of BM/2 x BN/2) and one contiguous range of
//   output rows (its row split), which it walks in k-slices of 32 rows.
// - Per k-slice, cp.async copies the gathered input rows [32 x BM] and the
//   matching dY rows [32 x BN] in 16-byte chunks into a ring of four
//   shared-memory stages. A row whose map entry is a sentinel is a zero-fill
//   copy (src-size 0) on both sides, so it reads no bytes. Rows are padded
//   by 16 bytes so that ldmatrix is free of bank conflicts.
// - Both operands are k-major in shared memory (row o, then channel): A is
//   the gathered tile transposed (m = in-channel, k = row) and B is dY, so
//   both feed mma.sync.m16n8k16 (bf16, f32 accumulators) through
//   ldmatrix.trans.
// - Map reads: each thread reads the map entries of its rows one k-slice
//   ahead of the copies that need them (registers, not waited for until the
//   next iteration), so the dependent gather never waits on a map load in
//   the same iteration. A block reads each entry of its column once. The
//   grid puts the taps of one row split next to each other (blockIdx.x is
//   the tap), so the T-strided sectors of the [rows x T] map come from
//   device memory once and from L2 for the neighbouring taps. Staging the
//   whole [rows x T] span in one block would need a set of accumulators for
//   every tap of the group.
// - A k-slice whose 32 rows all read the sentinel copies nothing and is
//   skipped (the ring's __syncthreads is __syncthreads_or of "a row of the
//   slice is live").
// - Narrow inputs (a channel count that is not a multiple of 8: conv1, one
//   input channel, 125 taps) pack the taps into M: per k-slice each row's
//   T*Ci gathered scalars fill one row of a [32 x 128] tile (the padding
//   reads zero), and dW viewed as [T*Ci, Co] (its own memory) is that tile
//   transposed times dY: one product with M = 128 instead of 125 nearly
//   empty ones. There one thread owns one column (one tap and channel), so
//   a warp reads 32 neighbouring map entries of a row: coalesced.
// - Row splits: the host (brick_conv.k5_plan) splits the rows so that a
//   launch has about eight blocks per SM, which hide each other's gather
//   latency. Each split writes an f32 partial (a few MB at most), and a
//   second pass adds the partials in split order, four neighbouring values
//   a thread over all of dW. No float atomics: the same bits on every call.
//   (A last-arriving block that adds every split of its tile alone reads up
//   to a few MB through one SM; conv1's 128 splits made that the tail.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;        // k-slice depth: output rows
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kThreads = 128;  // four warps

struct Params {
  const bf16* xa;
  const bf16* xb;
  const int* nmap;
  const bf16* dy;
  float* part;  // [splits, T*Ci*Co] when splits > 1
  float* out;   // [T, Ci, Co]
  int ca, cb, m_in, taps, m_out, co, splits, rows_per_split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes = 0 fills the 16 bytes with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, bool PACKED>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(const Params p) {
  constexpr int WM = BM / 2, WN = BN / 2;  // 2 x 2 warps
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of m16 x n16");
  static_assert(!PACKED || BM == kThreads, "packed: one column a thread");
  constexpr int MI = WM / 16;
  constexpr int NJ = WN / 8;
  constexpr int kLDA = BM + 8;  // A stage row pitch (one output row)
  constexpr int kLDB = BN + 8;  // B stage row pitch
  constexpr int kAStage = kBK * kLDA;
  constexpr int kBStage = kBK * kLDB;
  constexpr int kACh = BM / 8;                  // 16-byte chunks a row
  constexpr int kBCh = BN / 8;
  constexpr int kAPer = kBK * kACh / kThreads;  // A chunks a thread
  constexpr int kBPer = kBK * kBCh / kThreads;  // B chunks a thread
  static_assert(PACKED || kAPer >= 1, "every row of A has a thread");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kAStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ci = p.ca + p.cb;
  const int ktot = PACKED ? p.taps * ci : ci;  // rows of dW the M walks
  const int tiles_n = (p.co + BN - 1) / BN;
  const int i0 = (blockIdx.y / tiles_n) * BM;
  const int n0 = (blockIdx.y % tiles_n) * BN;
  const int t = PACKED ? 0 : blockIdx.x;
  const int o_begin = blockIdx.z * p.rows_per_split;
  const int o_end = min(p.m_out, o_begin + p.rows_per_split);
  const int n_sl = o_end > o_begin ? (o_end - o_begin + kBK - 1) / kBK : 0;

  // the map entries of this thread's A rows and B rows of one k-slice
  // (-1: sentinel or past the split)
  auto map_of = [&](int o) -> int {
    if (o >= o_end) return -1;
    const int r = __ldg(p.nmap + (size_t)o * p.taps + t);
    return (r >= 0 && r < p.m_in) ? r : -1;
  };
  int ra[PACKED ? 1 : kAPer], rb[PACKED ? 1 : kBPer];
  auto fetch_map = [&](int sl) {
    if constexpr (!PACKED) {
      const int o0 = o_begin + sl * kBK;
#pragma unroll
      for (int j = 0; j < kAPer; ++j)
        ra[j] = sl < n_sl ? map_of(o0 + (tid + j * kThreads) / kACh) : -1;
#pragma unroll
      for (int j = 0; j < kBPer; ++j)
        rb[j] = sl < n_sl ? map_of(o0 + (tid + j * kThreads) / kBCh) : -1;
    }
  };

  // copies of k-slice sl into ring slot `slot`; returns whether a row of
  // this thread's share of the slice is live
  auto load_stage = [&](int sl, int slot) -> bool {
    bf16* a_dst = sA + slot * kAStage;
    bf16* b_dst = sB + slot * kBStage;
    const int o0 = o_begin + sl * kBK;
    bool live = false;
    if constexpr (PACKED) {
      const int kk = tid;  // this thread's column: tap tt, channel c
      const int k = i0 + kk;
      const bool k_in = k < ktot;
      const int tt = k_in ? k / ci : 0;
      const int c = k - tt * ci;
      int rr[kBK];
#pragma unroll
      for (int i = 0; i < kBK; ++i) {
        const int o = o0 + i;
        const int r = k_in && o < o_end
                          ? __ldg(p.nmap + (size_t)o * p.taps + tt)
                          : -1;
        rr[i] = (r >= 0 && r < p.m_in) ? r : -1;
      }
#pragma unroll
      for (int i = 0; i < kBK; ++i) {
        const int r = rr[i];
        bf16 v = __float2bfloat16(0.f);
        if (r >= 0)
          v = c < p.ca ? p.xa[(size_t)r * p.ca + c]
                       : p.xb[(size_t)r * p.cb + (c - p.ca)];
        a_dst[i * kLDA + kk] = v;
      }
#pragma unroll
      for (int j = 0; j < kBPer; ++j) {
        const int e = tid + j * kThreads;
        const int row = e / kBCh;
        const int n = n0 + (e - row * kBCh) * 8;
        const bool ok = o0 + row < o_end && n < p.co;
        cp_async16(b_dst + row * kLDB + (e - row * kBCh) * 8,
                   ok ? p.dy + (size_t)(o0 + row) * p.co + n : p.dy,
                   ok ? 16 : 0);
      }
      live = true;
    } else {
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int e = tid + j * kThreads;
        const int row = e / kACh;
        const int ch = e - row * kACh;
        const int k = i0 + ch * 8;
        const int r = ra[j];
        const bf16* src = p.dy;
        int bytes = 0;
        if (r >= 0 && k < ci) {
          bytes = 16;
          src = k < p.ca ? p.xa + (size_t)r * p.ca + k
                         : p.xb + (size_t)r * p.cb + (k - p.ca);
        }
        live |= r >= 0;
        cp_async16(a_dst + row * kLDA + ch * 8, src, bytes);
      }
#pragma unroll
      for (int j = 0; j < kBPer; ++j) {
        const int e = tid + j * kThreads;
        const int row = e / kBCh;
        const int ch = e - row * kBCh;
        const int n = n0 + ch * 8;
        const bool ok = rb[j] >= 0 && n < p.co;
        cp_async16(b_dst + row * kLDB + ch * 8,
                   ok ? p.dy + (size_t)(o0 + row) * p.co + n : p.dy,
                   ok ? 16 : 0);
      }
    }
    return live;
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int wm = (warp >> 1) * WM;
  const int wn = (warp & 1) * WN;

  // bit `slot`: a row of this thread's share of the slice in that ring
  // slot is live
  unsigned live = 0;
  fetch_map(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_sl && load_stage(s, s)) live |= 1u << s;
    cp_async_commit();
    fetch_map(s + 1);
  }
  for (int s = 0; s < n_sl; ++s) {
    cp_async_wait<kStages - 2>();
    // stage s landed; every warp is done with stage s-1; is a row of
    // slice s live anywhere in the block?
    const int any = __syncthreads_or((live >> (s % kStages)) & 1u);
    const int nxt = s + kStages - 1;
    live &= ~(1u << (nxt % kStages));
    if (nxt < n_sl && load_stage(nxt, nxt % kStages))
      live |= 1u << (nxt % kStages);
    cp_async_commit();
    fetch_map(nxt + 1);
    if (!any) continue;
    const bf16* a_src = sA + (s % kStages) * kAStage;
    const bf16* b_src = sB + (s % kStages) * kBStage;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4_t(af[i], a_src + (ks + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                     kLDA +
                             wm + i * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, b_src + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kLDB +
                         wn + j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // dW rows of this block: flat row (t * Ci + k) of [T*Ci, Co], k < ktot
  const size_t size = (size_t)p.taps * ci * p.co;
  const size_t base = (size_t)t * ci * p.co;
  float* dst = p.splits > 1 ? p.part + (size_t)blockIdx.z * size : p.out;
  // accumulator (i, j): rows g and g + 8 of the m16 tile, columns 2q, 2q+1
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = i0 + wm + i * 16 + g + h * 8;
      if (k >= ktot) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn + j * 8 + 2 * q;
        if (n >= p.co) continue;
        *reinterpret_cast<float2*>(dst + base + (size_t)k * p.co + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// The row split's second pass: out = the partials added in split order,
// four neighbouring values a thread.
__global__ void __launch_bounds__(256) reduce_kernel(const float* part,
                                                     int splits, long size4,
                                                     float* out) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size4) return;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4 s = p4[e];
#pragma unroll 8
  for (int z = 1; z < splits; ++z) {
    const float4 v = p4[z * size4 + e];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  reinterpret_cast<float4*>(out)[e] = s;
}

template <int BM, int BN, bool PACKED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)kStages * kBK * ((BM + 8) + (BN + 8)) * sizeof(bf16);
  static size_t granted = 48 * 1024;  // dynamic shared memory allowed so far
  auto kernel = wgrad_kernel<BM, BN, PACKED>;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const int ci = p.ca + p.cb;
  const int ktot = PACKED ? p.taps * ci : ci;
  const dim3 grid(PACKED ? 1 : p.taps,
                  ((ktot + BM - 1) / BM) * ((p.co + BN - 1) / BN), p.splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, bool PACKED>
cudaError_t by_bn(const Params& p, int bn, cudaStream_t s) {
  if (bn == 32) return launch<BM, 32, PACKED>(p, s);
  if (bn == 64) return launch<BM, 64, PACKED>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// (bm, bn): the dW tile of a block, bm in {32, 64} in-channels (128 rows
// of [T*Ci, Co] for the packed route), bn in {32, 64} out-channels.
// packed: the narrow-input route (any Ca, Cb); otherwise Ca and Cb are
// multiples of 8.
// co is a multiple of 8; xa, xb and dy are 16-byte aligned. splits row
// splits of rows_per_split rows each; with splits > 1, part is [splits, T,
// Ci, Co] f32 scratch (16-byte aligned).
extern "C" int eyoc_sparse_conv_wgrad(const void* xa, int ca, const void* xb,
                                      int cb, int m_in, const void* nmap,
                                      int taps, int m_out, const void* dy,
                                      int co, int splits, int rows_per_split,
                                      int bm, int bn, int packed, void* part,
                                      void* out, void* stream) {
  const int ci = ca + cb;
  if (ci <= 0 || co <= 0 || taps <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (m_out <= 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)taps * ci * co * sizeof(float),
                                s);
  if (co % 8 != 0 || splits < 1 || rows_per_split < 1 ||
      (long)splits * rows_per_split < m_out ||
      (!packed && (ca % 8 != 0 || cb % 8 != 0)) || (packed && bm != 128) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t cp_src =
      (uintptr_t)dy | (packed ? 0 : ((uintptr_t)xa | (uintptr_t)xb));
  if (cp_src % 16 != 0 || ((uintptr_t)out | (uintptr_t)part) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.xa = static_cast<const bf16*>(xa);
  p.xb = static_cast<const bf16*>(xb);
  p.nmap = static_cast<const int*>(nmap);
  p.dy = static_cast<const bf16*>(dy);
  p.part = static_cast<float*>(part);
  p.out = static_cast<float*>(out);
  p.ca = ca;
  p.cb = cb;
  p.m_in = m_in;
  p.taps = taps;
  p.m_out = m_out;
  p.co = co;
  p.splits = splits;
  p.rows_per_split = rows_per_split;
  cudaError_t err = cudaErrorInvalidValue;
  if (packed)
    err = by_bn<128, true>(p, bn, s);
  else if (bm == 32)
    err = by_bn<32, false>(p, bn, s);
  else if (bm == 64)
    err = by_bn<64, false>(p, bn, s);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long size4 = (long)taps * ci * co / 4;  // co % 8 == 0
    reduce_kernel<<<(unsigned)((size4 + 255) / 256), 256, 0, s>>>(
        p.part, splits, size4, p.out);
  }
  return (int)cudaGetLastError();
}
