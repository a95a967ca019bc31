// A host stand-in for the part of the CUDA runtime that the port's kernels
// run on the CPU in the tests use (csrc/voxelize.cu, brick_pyramid.cu,
// conv_maps.cu, sc2_nms.cu, sc2_refine.cu, ransac.cu), so that g++ can
// build their sources and the tests can run them.
//
// Blocks run one after another on the calling thread. Each CUDA thread of
// a block is a fiber (ucontext) with its own stack, and __syncthreads
// switches back to the block's scheduler, which resumes every live thread
// in turn: one round of the threads is one barrier phase, whatever the
// block's size. A thread that returns leaves the rounds, as an exited CUDA
// thread leaves the barrier. A block whose thread 0 ends without calling
// __syncthreads runs its other threads as plain calls, one after another
// (a kernel that then calls __syncthreads aborts). __shared__ arrays become
// function statics, which the threads of the running block share; no
// warp-level intrinsics are provided. Blocks run in the order of their
// index, so a block that waits on a lower block's published state (a
// decoupled look-back) finds it there; a wait on a later block would hang.
#pragma once
#include <math.h>
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __constant__ static const
#define __shared__ static

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;

namespace host_cuda {

// The fibers of the block that runs; null while threads run as calls.
struct Block {
  ucontext_t scheduler;
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  std::function<void()>* body = nullptr;
  unsigned current = 0;
  bool synced = false;
};
inline Block* running = nullptr;

inline void fiber_entry() {
  (*running->body)();
  running->done[running->current] = 1;
}

}  // namespace host_cuda

inline void __syncthreads() {
  host_cuda::Block* b = host_cuda::running;
  if (b == nullptr) {
    std::fprintf(stderr, "cuda_host: __syncthreads in a block whose thread "
                         "0 ended without one\n");
    std::abort();
  }
  b->synced = true;
  swapcontext(&b->ctx[b->current], &b->scheduler);
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicCAS(int* p, int expected, int desired) {
  __atomic_compare_exchange_n(p, &expected, desired, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return expected;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

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
      for (unsigned t = 1; t < block; ++t) resume(blk, t);
      for (bool live = true; live;) {
        live = false;
        for (unsigned t = 0; t < block; ++t) {
          if (blk.done[t]) continue;
          resume(blk, t);
          live = true;
        }
      }
      host_cuda::running = nullptr;
    }
  }

  // Runs thread t of the block until its next __syncthreads or its end.
  static void resume(host_cuda::Block& blk, unsigned t) {
    blk.current = t;
    threadIdx.x = t;
    swapcontext(&blk.scheduler, &blk.ctx[t]);
  }
};
