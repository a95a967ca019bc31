// A host stand-in for the part of the CUDA runtime that the coordinate
// kernels (csrc/voxelize.cu, brick_pyramid.cu, conv_maps.cu) use, so that
// g++ can build their sources and the CPU tests can run them. Blocks run
// one after another; a block of 1024 threads (the kernels that call
// __syncthreads) runs one OS thread a CUDA thread behind a std::barrier,
// smaller blocks run their threads in turn. __shared__ arrays become
// function statics, which the threads of the running block share.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
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
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* block_barrier = nullptr;

inline void __syncthreads() { block_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
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
  template <class F, class... A>
  void operator()(F kernel, A... args) const {
    for (unsigned b = 0; b < grid; ++b) {
      if (block >= 1024) {
        std::barrier<> bar(block);
        block_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block; ++t)
          threads.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx.x = b;
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      } else {
        for (unsigned t = 0; t < block; ++t) {
          threadIdx.x = t;
          blockIdx.x = b;
          kernel(args...);
        }
      }
    }
  }
};
