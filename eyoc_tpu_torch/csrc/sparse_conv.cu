// K1 sparse_conv: gathered sparse convolution on bf16 tensor cores, with a
// fused epilogue.
//
// Replaces eyoc_tpu/sparse/brick_conv.py conv_same / conv_down / conv_up /
// conv1x1 (:310-378) and the decoder skip concat fb_concat (:381). The JAX
// package embeds the 27 taps into a dense 64-cell halo matmul to fit the
// TPU's matrix unit (2.37x the tap FLOPs); here each output row reads its
// inputs through an explicit gather map instead:
//
//   out[o, :] = epilogue( sum_t  in[map[o, t], :] @ W[t] )
//
// in = concat(xa [M_in, Ca], xb [M_in, Cb]) along channels (xb optional, the
// skip concat), bf16; W [T, Ca+Cb, Co] bf16; map [M_out, T] int32 where any
// value outside [0, M_in) reads a zero row (the sentinel is M_in). The sum
// accumulates in f32. Epilogue: + bias[Co] (folded BN, f32), * mask[o]
// (voxel validity), + residual[o, :] (bf16), ReLU, store bf16. The same
// kernel is the conv backward's dX, over the inverse map with W transposed
// per tap.
//
// What bounds it: at the main path's shapes (ResUNetBN2C, 32-256 channels
// over 512-131072 rows, 27 or 125 taps) a call moves 1-70 MB of unique
// bytes (the int32 map [M_out, T] is the largest input at the fine levels,
// W at the coarse ones) against at most a few GFLOP of taps that hit a
// voxel: at the bf16 tensor-core peak it is bound by bytes. The design
// keeps the products off the CUDA cores and reads each gathered row once
// per (tap, k-slice) of a tile:
// - A block owns a BM x BN output tile (128x32, 64x64 or 64x128; four warps
//   of 32x32 or 32x64) and walks a list of (tap, 32-channel k-slice)
//   stages. It first reads its rows' map entries for its taps into shared
//   memory, once, and lists the taps that hit a voxel of the tile; the
//   other taps cost nothing.
// - Per stage, the tile's gathered rows (BM x 32 bf16) and the slice of
//   W[t] (32 x BN) are copied with cp.async 16-byte chunks into a ring of
//   three shared-memory stages; a sentinel row, or a channel past Ci, is a
//   zero-fill copy (src-size 0). Rows are padded by 16 bytes, so that
//   ldmatrix reads eight rows from eight different bank groups. The copy
//   of stage s+2 overlaps the products of stage s; one __syncthreads per
//   stage.
// - Products: mma.sync.m16n8k16 bf16 with f32 accumulators, fed by
//   ldmatrix (A) and ldmatrix.trans (B, kept k-major as W is stored).
// - Narrow inputs (a channel count that is not a multiple of 8: conv1, one
//   input channel, 125 taps) pack the taps into K: output row o's
//   K = T*Ci gathered scalars, zero-padded to a multiple of 32, times W
//   viewed as [T*Ci, Co], which is W's own memory. Four k-slices instead of
//   125 nearly empty ones.
// - Where the row x column tiles do not fill the card (the coarse levels),
//   the host splits the taps over gridDim.z: split s sums taps
//   [s*T/S, (s+1)*T/S) into its own f32 partial, and a second pass adds the
//   partials in split order and applies the epilogue once. Every run gives
//   the same bits; no float atomics.
// The host picks the tile and the split (brick_conv.k1_plan) and passes
// them in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;        // k-slice depth, bf16 values
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kThreads = 128;  // four warps
constexpr int kLDA = kBK + 8;  // A stage row pitch: 80 bytes

struct Params {
  const bf16* xa;
  const bf16* xb;
  const int* nmap;
  const bf16* w;
  const float* bias;
  const uint8_t* mask;
  const bf16* residual;
  bf16* out;
  float* part;
  int ca, cb, m_in, taps, m_out, co, relu, splits;
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
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

// The epilogue of two neighbouring outputs (m, n) and (m, n + 1).
__device__ __forceinline__ void finish2(const Params& p, int m, int n,
                                        float y0, float y1) {
  if (p.bias != nullptr) {
    y0 += p.bias[n];
    y1 += p.bias[n + 1];
  }
  if (p.mask != nullptr && !p.mask[m]) {
    y0 *= 0.f;
    y1 *= 0.f;
  }
  const size_t at = (size_t)m * p.co + n;
  if (p.residual != nullptr) {
    const __nv_bfloat162 r =
        *reinterpret_cast<const __nv_bfloat162*>(p.residual + at);
    y0 += __low2float(r);
    y1 += __high2float(r);
  }
  if (p.relu) {
    y0 = fmaxf(y0, 0.f);
    y1 = fmaxf(y1, 0.f);
  }
  *reinterpret_cast<__nv_bfloat162*>(p.out + at) = __floats2bfloat162_rn(y0, y1);
}

template <int BM, int BN, int WM, int WN, bool PACKED>
__global__ void __launch_bounds__(kThreads) conv_kernel(const Params p) {
  constexpr int kWarpsN = BN / WN;
  static_assert((BM / WM) * kWarpsN == kThreads / 32, "four warps a block");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of m16 x n16");
  constexpr int MI = WM / 16;
  constexpr int NJ = WN / 8;
  constexpr int kLDB = BN + 8;  // B stage row pitch
  constexpr int kAStage = BM * kLDA;
  constexpr int kBStage = kBK * kLDB;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kAStage;
  int* smap = reinterpret_cast<int*>(sB + kStages * kBStage);  // [BM][nt]
  __shared__ int s_nact;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ci = p.ca + p.cb;
  const int t_lo = (int)((long)blockIdx.z * p.taps / p.splits);
  const int nt = (int)((long)(blockIdx.z + 1) * p.taps / p.splits) - t_lo;
  int* act = smap + BM * nt;  // [nt]: flags, then the list of active taps

  int nks, n_st;
  const int ktot = PACKED ? p.taps * ci : ci;  // K of one stage's W rows
  if constexpr (PACKED) {
    nks = (ktot + kBK - 1) / kBK;
    n_st = nks;
  } else {
    for (int e = tid; e < BM * nt; e += kThreads) {
      const int row = e / nt;
      const int m = m0 + row;
      const int r =
          m < p.m_out ? __ldg(p.nmap + (size_t)m * p.taps + t_lo + e - row * nt)
                      : -1;
      smap[e] = (r >= 0 && r < p.m_in) ? r : -1;
    }
    for (int j = tid; j < nt; j += kThreads) act[j] = 0;
    __syncthreads();
    for (int e = tid; e < BM * nt; e += kThreads)
      if (smap[e] >= 0) act[e % nt] = 1;
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int j = 0; j < nt; ++j)
        if (act[j]) act[n++] = j;
      s_nact = n;
    }
    __syncthreads();
    nks = (ci + kBK - 1) / kBK;
    n_st = s_nact * nks;
  }

  auto load_stage = [&](int s, int slot) {
    bf16* a_dst = sA + slot * kAStage;
    bf16* b_dst = sB + slot * kBStage;
    const bf16* wt = p.w;
    int k0;
    if constexpr (PACKED) {
      // a thread keeps one k of the slice (its lane) over every kRows-th
      // row: all its map reads go out before the dependent row reads
      constexpr int kRows = kThreads / kBK;
      k0 = s * kBK;
      const int kk = tid % kBK;
      const int k = k0 + kk;
      const bool k_in = k < ktot;
      const int t = k_in ? k / ci : 0;
      const int c = k - t * ci;
      int rr[BM / kRows];
#pragma unroll
      for (int i = 0; i < BM / kRows; ++i) {
        const int m = m0 + tid / kBK + i * kRows;
        const int r =
            k_in && m < p.m_out ? __ldg(p.nmap + (size_t)m * p.taps + t) : -1;
        rr[i] = (r >= 0 && r < p.m_in) ? r : -1;
      }
#pragma unroll
      for (int i = 0; i < BM / kRows; ++i) {
        const int r = rr[i];
        bf16 v = __float2bfloat16(0.f);
        if (r >= 0)
          v = c < p.ca ? p.xa[(size_t)r * p.ca + c]
                       : p.xb[(size_t)r * p.cb + (c - p.ca)];
        a_dst[(tid / kBK + i * kRows) * kLDA + kk] = v;
      }
    } else {
      const int q = s / nks;
      const int j = act[q];
      k0 = (s - q * nks) * kBK;
      wt = p.w + (size_t)(t_lo + j) * ci * p.co;
      constexpr int kCh = kBK / 8;
      for (int e = tid; e < BM * kCh; e += kThreads) {
        const int row = e / kCh;
        const int ch = e - row * kCh;
        const int k = k0 + ch * 8;
        const int r = smap[row * nt + j];
        const bf16* src = p.w;
        int bytes = 0;
        if (r >= 0 && k < ci) {
          bytes = 16;
          src = k < p.ca ? p.xa + (size_t)r * p.ca + k
                         : p.xb + (size_t)r * p.cb + (k - p.ca);
        }
        cp_async16(a_dst + row * kLDA + ch * 8, src, bytes);
      }
    }
    constexpr int kBCh = BN / 8;
    for (int e = tid; e < kBK * kBCh; e += kThreads) {
      const int kk = e / kBCh;
      const int ch = e - kk * kBCh;
      const int k = k0 + kk;
      const int n = n0 + ch * 8;
      const bool ok = k < ktot && n < p.co;
      cp_async16(b_dst + kk * kLDB + ch * 8,
                 ok ? wt + (size_t)k * p.co + n : p.w, ok ? 16 : 0);
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int wm = (warp / kWarpsN) * WM;
  const int wn = (warp % kWarpsN) * WN;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s-1
    const int nxt = s + kStages - 1;
    if (nxt < n_st) load_stage(nxt, nxt % kStages);
    cp_async_commit();
    const bf16* a_src = sA + (s % kStages) * kAStage;
    const bf16* b_src = sB + (s % kStages) * kBStage;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], a_src + (wm + i * 16 + (lane & 15)) * kLDA + ks +
                           (lane >> 4) * 8);
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

  // accumulator (i, j): rows g and g + 8 of the m16 tile, columns 2q, 2q+1
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= p.m_out) continue;
      float* part = p.splits > 1
                        ? p.part + ((size_t)blockIdx.z * p.m_out + m) * p.co
                        : nullptr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn + j * 8 + 2 * q;
        if (n >= p.co) continue;
        if (part != nullptr)
          *reinterpret_cast<float2*>(part + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        else
          finish2(p, m, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// The tap split's second pass: partials added in split order, then the
// epilogue; one thread per two neighbouring outputs.
__global__ void __launch_bounds__(256) reduce_kernel(const Params p) {
  const long pairs = (long)p.m_out * p.co / 2;
  const long e2 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e2 >= pairs) return;
  const long e = 2 * e2;
  const int m = (int)(e / p.co);
  const int n = (int)(e - (long)m * p.co);
  const size_t plane = (size_t)p.m_out * p.co;
  float2 s = *reinterpret_cast<const float2*>(p.part + e);
  for (int k = 1; k < p.splits; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(p.part + k * plane + e);
    s.x += v.x;
    s.y += v.y;
  }
  finish2(p, m, n, s.x, s.y);
}

template <int BM, int BN, int WM, int WN, bool PACKED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kLDB = BN + 8;
  const int nt_max = PACKED ? 0 : (p.taps + p.splits - 1) / p.splits;
  const size_t smem =
      (size_t)kStages * (BM * kLDA + kBK * kLDB) * sizeof(bf16) +
      (size_t)(BM + 1) * nt_max * sizeof(int);
  static size_t granted = 48 * 1024;  // dynamic shared memory allowed so far
  auto kernel = conv_kernel<BM, BN, WM, WN, PACKED>;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid((p.m_out + BM - 1) / BM, (p.co + BN - 1) / BN, p.splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t dispatch(const Params& p, int bm, int bn, cudaStream_t s) {
  if (bm == 128 && bn == 32) return launch<128, 32, 32, 32, PACKED>(p, s);
  if (bm == 64 && bn == 64) return launch<64, 64, 32, 32, PACKED>(p, s);
  if (bm == 64 && bn == 128) return launch<64, 128, 32, 64, PACKED>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// part: [splits, m_out, co] f32 scratch when splits > 1 (else unused).
// (bm, bn): the tile, one of 128x32, 64x64, 64x128. packed: the narrow-input
// route (any Ca, Cb; splits must be 1); otherwise Ca and Cb are multiples of
// 8. co is a multiple of 8; xa, xb and w are 16-byte aligned.
extern "C" int eyoc_sparse_conv(const void* xa, int ca, const void* xb,
                                int cb, int m_in, const void* nmap, int taps,
                                int m_out, const void* w, int co,
                                const void* bias, const void* mask,
                                const void* residual, int relu, void* out,
                                void* part, int splits, int bm, int bn,
                                int packed, void* stream) {
  if (m_out <= 0 || co <= 0) return 0;
  if (co % 8 != 0 || taps <= 0 || splits < 1 || splits > taps ||
      (packed && splits != 1) || (!packed && (ca % 8 != 0 || cb % 8 != 0)) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t cp_src =
      (uintptr_t)w | (packed ? 0 : ((uintptr_t)xa | (uintptr_t)xb));
  if (cp_src % 16 != 0 || ((uintptr_t)out | (uintptr_t)residual) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.xa = static_cast<const bf16*>(xa);
  p.xb = static_cast<const bf16*>(xb);
  p.nmap = static_cast<const int*>(nmap);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const uint8_t*>(mask);
  p.residual = static_cast<const bf16*>(residual);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.ca = ca;
  p.cb = cb;
  p.m_in = m_in;
  p.taps = taps;
  p.m_out = m_out;
  p.co = co;
  p.relu = relu;
  p.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = packed ? dispatch<true>(p, bm, bn, s)
                           : dispatch<false>(p, bm, bn, s);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long pairs = (long)m_out * co / 2;
    reduce_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
