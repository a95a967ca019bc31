// A host stand-in for the part of the CUDA runtime that the port's kernels
// run on the CPU in the tests use (csrc/voxelize.cu, brick_pyramid.cu,
// conv_maps.cu, sc2_nms.cu, sc2_refine.cu, ransac.cu, sc2_power_iteration.cu,
// instance_norm.cu, norm_backward.cu, robust_irls.cu), so that g++ can build
// their sources and the tests can run them.
//
// Blocks run one after another on the calling thread. Each CUDA thread of
// a block is a fiber (ucontext) with its own stack. __syncthreads and the
// warp shuffles switch back to the block's scheduler, which resumes every
// thread that may go on: the threads at a __syncthreads once every live
// thread of the block is there, the lanes at a shuffle once every live lane
// of their warp (32 threads) is there. A thread that returns leaves both,
// as an exited CUDA thread leaves the barrier. A block whose thread 0 ends
// without a barrier or a shuffle runs its other threads as plain calls,
// one after another (a kernel that then calls either aborts). __shared__
// arrays become function statics, which the threads of the running block
// share; `extern __shared__` arrays are rewritten by the tests to point at
// `host_cuda::dynamic_shared` (256 KB). __shfl_xor_sync and __shfl_sync
// are the warp intrinsics: each lane posts its value, waits for its warp and
// reads its partner's (the mask is not read: every lane of the warp takes
// part); __ballot_sync is five of them, __syncwarp one whose value is not
// read.
// Blocks run in the order of their index, so a block that waits on a lower
// block's published state (a decoupled look-back) finds it there; a wait on
// a later block would hang.
// A cooperative launch (cudaLaunchCooperativeKernel with a typed kernel)
// takes a grid of up to kMaxCoopBlocks blocks and makes every thread of
// every block a fiber, all live at once: the scheduler runs each block's
// threads to their next stop, block by block, and the grid barrier
// (cooperative_groups.h: grid.sync()) releases once every live thread of
// the grid waits there. Each block of such a launch has its own dynamic
// shared memory of the launch's size (`host_cuda::dynamic_shared` points at
// the running block's); its `__shared__` statics would be shared by all
// blocks, so a kernel launched on more than one block keeps its shared
// state in the dynamic array.
// A cluster launch (cudaLaunchKernelEx with a cluster dimension of up to
// kMaxCoopBlocks along x) runs its clusters one after another, each as such
// a grid of its blocks: cooperative_groups.h's this_cluster().sync() is
// that grid's barrier, block_rank() the block's place in its cluster, and
// map_shared_rank() maps a pointer into the caller's dynamic shared memory
// onto the same offset in another block's of the cluster.
// sincosf gives the f64 sine and cosine rounded to f32 (the card's differs
// from both by an ulp or so; a test that wants the host build's bits makes
// them the same way); clock64 counts calls.
// rcp.approx.ftz.f32 and rsqrt.approx.ftz.f32 (jacobi_pose.cuh's fast
// forms, which take them as host_cuda::rcp_approx / rsqrt_approx where
// EYOC_CUDA_HOST_STANDIN is defined) are the f64 values rounded to f32; a
// build with -DEYOC_HOST_APPROX_SKEW moves them, by a hash of the operand,
// within the PTX ISA's stated bounds (the reciprocal rounded down or up:
// under 1 ulp; the reciprocal root by a relative error under 2^-22.9), so
// that the forms' corrections do work. __device__ variables are globals,
// cudaMemcpyFromSymbol a memcpy.
#pragma once
#include <math.h>
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __constant__ static const
#define __shared__ static
#define __align__(n) alignas(n)
#define __noinline__ __attribute__((noinline))
#define EYOC_CUDA_HOST_STANDIN 1

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline thread_local dim3 threadIdx, blockIdx, gridDim;

namespace host_cuda {

// where a fiber stopped: running, at a __syncthreads, at a shuffle, at a
// grid barrier
enum Wait : char { kRun, kBlock, kWarp, kGrid };

// The fibers of the block that runs; null while threads run as calls.
struct Block {
  ucontext_t scheduler;
  std::vector<ucontext_t> ctx;
  std::vector<char> done, wait;
  std::vector<unsigned> shuffles;             // shuffles each thread made
  std::vector<std::uint64_t> post[2];         // by the shuffle's parity
  std::function<void()>* body = nullptr;
  unsigned current = 0;
  bool synced = false;
};
inline Block* running = nullptr;
alignas(16) inline char dynamic_shared_buffer[256 * 1024];
// the running block's dynamic shared memory
inline char* dynamic_shared = dynamic_shared_buffer;
constexpr unsigned kMaxCoopBlocks = 8;
// the running cluster launch: its cluster size (0 outside one), and its
// blocks' dynamic shared memory, `grid_shm` bytes a block from `grid_shared`
inline unsigned cluster_size = 0;
inline char* grid_shared = nullptr;
inline size_t grid_shm = 0;

inline void fiber_entry() {
  (*running->body)();
  running->done[running->current] = 1;
}

inline Block* block_or_abort(const char* what) {
  if (running == nullptr) {
    std::fprintf(stderr, "cuda_host: %s in a block whose thread 0 ended "
                         "without a barrier\n", what);
    std::abort();
  }
  return running;
}

// Stops the running thread at a barrier of the given kind.
inline void stop(Block* b, Wait w) {
  b->synced = true;
  b->wait[b->current] = w;
  swapcontext(&b->ctx[b->current], &b->scheduler);
}

}  // namespace host_cuda

inline void __syncthreads() {
  host_cuda::Block* b = host_cuda::block_or_abort("__syncthreads");
  host_cuda::stop(b, host_cuda::kBlock);
}

namespace host_cuda {
// The grid barrier of a cooperative launch.
inline void grid_sync() { stop(block_or_abort("a grid barrier"), kGrid); }
}  // namespace host_cuda

namespace host_cuda {

// The value that lane `lane` of the caller's warp posts at this shuffle:
// each lane posts its own and waits for the warp.
template <class T>
inline T exchange(T v, unsigned lane) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  Block* b = block_or_abort("a warp shuffle");
  const unsigned t = b->current;
  const unsigned parity = b->shuffles[t]++ & 1;
  std::uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  b->post[parity][t] = bits;
  stop(b, kWarp);
  const unsigned src = (t & ~31u) | (lane & 31u);
  // the partner posted this exchange (it may have gone on since, even
  // ended: the other parity's slots hold its next one)
  if (src >= b->ctx.size() || b->shuffles[src] < b->shuffles[t]) {
    std::fprintf(stderr, "cuda_host: shuffle with an absent lane\n");
    std::abort();
  }
  T out;
  bits = b->post[parity][src];
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}

}  // namespace host_cuda

// The value of lane (lane ^ lane_mask) of the caller's warp.
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return host_cuda::exchange(v, (threadIdx.x ^ (unsigned)lane_mask) & 31u);
}

// The value of lane `src` of the caller's warp.
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return host_cuda::exchange(v, (unsigned)src & 31u);
}

// The lanes of the caller's warp whose `pred` holds, as bits: an OR of the
// lanes' bits by a xor-shuffle tree.
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned bits = pred ? 1u << lane : 0u;
  for (unsigned off = 16; off > 0; off >>= 1)
    bits |= host_cuda::exchange(bits, lane ^ off);
  return bits;
}

// A barrier of the caller's warp (every lane takes part, as at a shuffle).
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  host_cuda::exchange(0u, threadIdx.x & 31u);
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
// the blocks run one after another: every write is seen by the next
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.f / a; }
inline int __float_as_int(float v) {
  int i;
  std::memcpy(&i, &v, sizeof i);
  return i;
}
inline unsigned __float_as_uint(float v) {
  unsigned u;
  std::memcpy(&u, &v, sizeof u);
  return u;
}
inline float __int_as_float(int i) {
  float v;
  std::memcpy(&v, &i, sizeof v);
  return v;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
namespace host_cuda {
inline void sincos_rn(float x, float* s, float* c) {
  *s = (float)sin((double)x);
  *c = (float)cos((double)x);
}
inline long long clock_count = 0;

// a hash of x's bits (splitmix64's finalizer)
inline std::uint64_t approx_hash(float x) {
  std::uint32_t u;
  std::memcpy(&u, &x, 4);
  std::uint64_t z = u + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

inline float rcp_approx(float x) {
  const double e = 1.0 / (double)x;
  const float n = (float)e;
#ifdef EYOC_HOST_APPROX_SKEW
  if ((double)n != e && std::isfinite(n) && n != 0.f) {
    // the float on 1 / x's other side: each of the two is within 1 ulp
    const float other = nextafterf(n, (double)n > e ? -INFINITY : INFINITY);
    return approx_hash(x) & 1 ? other : n;
  }
#endif
  return n;
}

inline float rsqrt_approx(float x) {
  const double e = 1.0 / std::sqrt((double)x);
#ifdef EYOC_HOST_APPROX_SKEW
  // a relative move of up to 2^-22.9 - 2^-24 (the rounding to f32 adds at
  // most 2^-24)
  const double u = (double)(approx_hash(x) >> 11) * 0x1p-53 * 2.0 - 1.0;
  return (float)(e * (1.0 + u * (std::exp2(-22.9) - 0x1p-24)));
#endif
  return (float)e;
}
}  // namespace host_cuda
#define sincosf host_cuda::sincos_rn
inline long long clock64() { return ++host_cuda::clock_count; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicCAS(int* p, int expected, int desired) {
  __atomic_compare_exchange_n(p, &expected, desired, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return expected;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 720
};
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 12
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
// the multiprocessors of an H100 SXM
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 132;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T>
inline cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol,
                                        size_t count, size_t offset = 0) {
  std::memcpy(dst, reinterpret_cast<const char*>(&symbol) + offset, count);
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

// `kernel<<<grid, block, smem, stream>>>(args)` is rewritten to
// `HostLaunch{grid, block}(kernel, args)` before the source is compiled.
struct HostLaunch {
  unsigned grid, block;
  static constexpr size_t kStack = 1 << 16;

  template <class F, class... A>
  void operator()(F kernel, A... args) const {
    std::function<void()> body = [&] { kernel(args...); };
    std::unique_ptr<char[]> stacks(new char[size_t(block) * kStack]);
    host_cuda::Block blk;
    blk.ctx.resize(block);
    blk.done.resize(block);
    blk.wait.resize(block);
    blk.shuffles.resize(block);
    blk.post[0].resize(block);
    blk.post[1].resize(block);
    blk.body = &body;
    gridDim.x = grid;
    for (unsigned b = 0; b < grid; ++b) {
      blockIdx.x = b;
      for (unsigned t = 0; t < block; ++t) {
        getcontext(&blk.ctx[t]);
        blk.ctx[t].uc_stack.ss_sp = stacks.get() + size_t(t) * kStack;
        blk.ctx[t].uc_stack.ss_size = kStack;
        blk.ctx[t].uc_link = &blk.scheduler;
        makecontext(&blk.ctx[t], host_cuda::fiber_entry, 0);
        blk.done[t] = 0;
        blk.wait[t] = host_cuda::kRun;
        blk.shuffles[t] = 0;
      }
      blk.synced = false;
      host_cuda::running = &blk;
      resume(blk, 0);
      if (!blk.synced) {
        host_cuda::running = nullptr;
        for (unsigned t = 1; t < block; ++t) {
          threadIdx.x = t;
          kernel(args...);
        }
        continue;
      }
      schedule(blk, block);
      host_cuda::running = nullptr;
    }
  }

  // Runs every thread that may go on to its next stop, then releases the
  // warps whose live lanes all wait at a shuffle, else (none) the block
  // when all its live threads wait at __syncthreads; until all are done.
  static void schedule(host_cuda::Block& blk, unsigned block) {
    for (;;) {
      for (unsigned t = 0; t < block; ++t)
        if (!blk.done[t] && blk.wait[t] == host_cuda::kRun) resume(blk, t);
      bool released = false, live = false, all_block = true;
      for (unsigned w = 0; w < block; w += 32) {
        bool all_warp = true, any = false;
        for (unsigned t = w; t < w + 32 && t < block; ++t) {
          if (blk.done[t]) continue;
          any = live = true;
          all_warp = all_warp && blk.wait[t] == host_cuda::kWarp;
          all_block = all_block && blk.wait[t] == host_cuda::kBlock;
        }
        if (any && all_warp) {
          for (unsigned t = w; t < w + 32 && t < block; ++t)
            blk.wait[t] = host_cuda::kRun;
          released = true;
        }
      }
      if (!live) return;
      if (released) continue;
      if (!all_block) {
        std::fprintf(stderr, "cuda_host: a warp waits at a shuffle that "
                             "some of its lanes never reach\n");
        std::abort();
      }
      for (unsigned t = 0; t < block; ++t) blk.wait[t] = host_cuda::kRun;
    }
  }

  // Runs thread t of the block until its next stop or its end.
  static void resume(host_cuda::Block& blk, unsigned t) {
    blk.current = t;
    threadIdx.x = t;
    swapcontext(&blk.scheduler, &blk.ctx[t]);
  }
};

// one resident block a multiprocessor, whatever the kernel
template <class... P>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, void (*)(P...), int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

// A cooperative launch: `grid` blocks of `block` fibers each, all live at
// once, each block with `smem` bytes of its own dynamic shared memory; the
// blocks are first, ..., first + grid - 1 of a grid of `total` (0: grid).
struct HostGridLaunch {
  unsigned grid, block;
  size_t smem;
  unsigned first = 0, total = 0;
  static constexpr size_t kStack = 1 << 16;

  template <class F, class... A>
  void operator()(F kernel, A... args) const {
    std::function<void()> body = [&] { kernel(args...); };
    const size_t shm = (smem + 15) / 16 * 16;
    std::unique_ptr<char[]> stacks(new char[size_t(grid) * block * kStack]);
    std::unique_ptr<char[]> shared(new char[size_t(grid) * shm + 16]);
    char* shared0 = reinterpret_cast<char*>(
        (reinterpret_cast<std::uintptr_t>(shared.get()) + 15) & ~15ull);
    std::vector<host_cuda::Block> blks(grid);
    gridDim.x = total ? total : grid;
    host_cuda::grid_shared = shared0;
    host_cuda::grid_shm = shm;
    for (unsigned b = 0; b < grid; ++b) {
      host_cuda::Block& blk = blks[b];
      blk.ctx.resize(block);
      blk.done.assign(block, 0);
      blk.wait.assign(block, host_cuda::kRun);
      blk.shuffles.assign(block, 0);
      blk.post[0].resize(block);
      blk.post[1].resize(block);
      blk.body = &body;
      for (unsigned t = 0; t < block; ++t) {
        getcontext(&blk.ctx[t]);
        blk.ctx[t].uc_stack.ss_sp =
            stacks.get() + (size_t(b) * block + t) * kStack;
        blk.ctx[t].uc_stack.ss_size = kStack;
        blk.ctx[t].uc_link = &blk.scheduler;
        makecontext(&blk.ctx[t], host_cuda::fiber_entry, 0);
      }
    }
    for (;;) {
      bool live = false, released = false, all_grid = true;
      for (unsigned b = 0; b < grid; ++b) {
        host_cuda::Block& blk = blks[b];
        host_cuda::running = &blk;
        host_cuda::dynamic_shared = shared0 + size_t(b) * shm;
        blockIdx.x = first + b;
        for (unsigned t = 0; t < block; ++t)
          if (!blk.done[t] && blk.wait[t] == host_cuda::kRun)
            HostLaunch::resume(blk, t);
        bool any = false, all_block = true, warp_released = false;
        for (unsigned w = 0; w < block; w += 32) {
          bool all_warp = true, in_warp = false;
          for (unsigned t = w; t < w + 32 && t < block; ++t) {
            if (blk.done[t]) continue;
            in_warp = any = true;
            all_warp = all_warp && blk.wait[t] == host_cuda::kWarp;
            all_block = all_block && blk.wait[t] == host_cuda::kBlock;
            all_grid = all_grid && blk.wait[t] == host_cuda::kGrid;
          }
          if (in_warp && all_warp) {
            for (unsigned t = w; t < w + 32 && t < block; ++t)
              blk.wait[t] = host_cuda::kRun;
            warp_released = true;
          }
        }
        live = live || any;
        if (any && !warp_released && all_block)
          for (unsigned t = 0; t < block; ++t) blk.wait[t] = host_cuda::kRun;
        released = released || warp_released || (any && all_block);
      }
      if (!live) break;
      if (released) continue;
      if (!all_grid) {
        std::fprintf(stderr, "cuda_host: the grid waits at barriers that "
                             "some of its threads never reach\n");
        std::abort();
      }
      for (auto& blk : blks)
        for (unsigned t = 0; t < block; ++t) blk.wait[t] = host_cuda::kRun;
    }
    host_cuda::running = nullptr;
    host_cuda::dynamic_shared = host_cuda::dynamic_shared_buffer;
    host_cuda::grid_shared = nullptr;
  }
};

namespace host_cuda {
template <class... P, size_t... I>
inline void launch_args(void (*kernel)(P...), unsigned grid, unsigned block,
                        size_t smem, void** args, std::index_sequence<I...>) {
  HostGridLaunch{grid, block, smem}(
      kernel, *static_cast<std::remove_cv_t<P>*>(args[I])...);
}
}  // namespace host_cuda

// A cooperative launch of a typed kernel: its arguments read from `args`
// by the kernel's parameter types. At most kMaxCoopBlocks blocks; a larger
// grid is refused, as the card refuses a grid past its resident blocks.
template <class... P>
inline cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(P...), dim3 grid,
                                               dim3 block, void** args,
                                               size_t smem, cudaStream_t) {
  if (grid.x < 1 || grid.x > host_cuda::kMaxCoopBlocks)
    return cudaErrorInvalidConfiguration;
  host_cuda::launch_args(kernel, grid.x, block.x, smem, args,
                         std::index_sequence_for<P...>{});
  return cudaSuccess;
}

// A launch with attributes: a cluster dimension along x (the only one the
// stand-in takes; none is a cluster of 1) runs each cluster of the grid as a
// grid of its own (HostGridLaunch), the clusters one after another. A
// cluster larger than kMaxCoopBlocks, or one that does not divide the grid,
// is refused, as the card refuses a cluster it cannot place.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

template <class... P, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config,
                                      void (*kernel)(P...), A&&... args) {
  unsigned c = 1;
  for (unsigned i = 0; i < config->numAttrs; ++i) {
    const cudaLaunchAttribute& a = config->attrs[i];
    if (a.id != cudaLaunchAttributeClusterDimension) continue;
    if (a.val.clusterDim.y > 1 || a.val.clusterDim.z > 1)
      return cudaErrorInvalidConfiguration;
    c = a.val.clusterDim.x;
  }
  const unsigned grid = config->gridDim.x, block = config->blockDim.x;
  if (c < 1 || c > host_cuda::kMaxCoopBlocks || grid % c != 0 ||
      config->gridDim.y > 1 || config->gridDim.z > 1)
    return cudaErrorInvalidConfiguration;
  host_cuda::cluster_size = c;
  for (unsigned first = 0; first < grid; first += c)
    HostGridLaunch{c, block, config->dynamicSmemBytes, first, grid}(
        kernel, static_cast<P>(args)...);
  host_cuda::cluster_size = 0;
  return cudaSuccess;
}
