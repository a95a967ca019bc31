// Tensor-core rate of the GPU it runs on, for the types K4 could use:
// mma.sync b1 (m16n8k256, AND + POPC), s8 (m16n8k32) and, as a yardstick,
// f16 (m16n8k16, f32 sums), each warp running `iters` rounds of 8
// independent MMAs on register operands; and the Hopper warpgroup MMA
// (wgmma, sm_90a) in b1 (m64n256k256, AND + POPC) and s8 (m64n256k32),
// each warpgroup running `iters` rounds of 4 MMAs on operands in shared
// memory. The caller times the launch and divides. Not part of the port:
// profile_k4_mma.py builds and runs it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int kKind>
__global__ void rate(const uint32_t* in, int iters, int* out) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = in[(threadIdx.x + q) & 31];
#pragma unroll
  for (int q = 0; q < 2; ++q) b[q] = in[(threadIdx.x + 4 + q) & 31];
  int c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kKind == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else if (kKind == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) s += c[u][0] ^ c[u][1] ^ c[u][2] ^ c[u][3];
  if (s == 0x7fffffff) out[0] = s;  // keeps the MMAs alive
}

#define EYOC_D8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define EYOC_D128                                                       \
  EYOC_D8(0), EYOC_D8(8), EYOC_D8(16), EYOC_D8(24), EYOC_D8(32),        \
      EYOC_D8(40), EYOC_D8(48), EYOC_D8(56), EYOC_D8(64), EYOC_D8(72),  \
      EYOC_D8(80), EYOC_D8(88), EYOC_D8(96), EYOC_D8(104), EYOC_D8(112), \
      EYOC_D8(120)
#define EYOC_REGS \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// A shared-memory matrix descriptor without swizzle: 16-byte core rows,
// 128 bytes between core matrices along K and 256 along M or N, so an
// m64 or n256 operand of 32-byte rows stays inside 8 KB.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

template <int kKind>
__global__ void __launch_bounds__(128) rate_wgmma(int iters, int* out) {
  __shared__ __align__(128) uint32_t tile[2048];
  for (int i = threadIdx.x; i < 2048; i += 128) tile[i] = i * 0x9E3779B9u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc = smem_desc(tile);
  uint32_t d[128];
#pragma unroll
  for (int q = 0; q < 128; ++q) d[q] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kKind == 3) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
            "{" EYOC_REGS "}, %128, %129, p;\n}\n"
            : EYOC_D128
            : "l"(desc), "l"(desc), "r"(1));
      } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
            "{" EYOC_REGS "}, %128, %129, p;\n}\n"
            : EYOC_D128
            : "l"(desc), "l"(desc), "r"(1));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  uint32_t s = 0;
#pragma unroll
  for (int q = 0; q < 128; ++q) s ^= d[q];
  if (s == 0x7fffffffu) out[0] = static_cast<int>(s);  // keeps the MMAs
}

}  // namespace

// kind 0: b1 m16n8k256, 1: s8 m16n8k32, 2: f16 m16n8k16 (mma.sync; `blocks`
// blocks of `threads` threads, each warp 8 * iters MMAs); 3: b1 m64n256k256,
// 4: s8 m64n256k32 (wgmma; `blocks` warpgroups, each 4 * iters MMAs, and
// `threads` must be 128)
extern "C" int eyoc_mma_rate(int kind, int blocks, int threads, int iters,
                             const void* in, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* pin = static_cast<const uint32_t*>(in);
  auto* pout = static_cast<int*>(out);
  if (kind == 0) rate<0><<<blocks, threads, 0, s>>>(pin, iters, pout);
  else if (kind == 1) rate<1><<<blocks, threads, 0, s>>>(pin, iters, pout);
  else if (kind == 2) rate<2><<<blocks, threads, 0, s>>>(pin, iters, pout);
  else if (kind == 3) rate_wgmma<3><<<blocks, 128, 0, s>>>(iters, pout);
  else rate_wgmma<4><<<blocks, 128, 0, s>>>(iters, pout);
  return (int)cudaGetLastError();
}
