// A host stand-in for the part of cooperative_groups.h that the port's
// kernels run on the CPU in the tests use (csrc/sc2_power_iteration.cu,
// norm_backward.cu, robust_irls.cu): the grid group of a cooperative launch,
// whose barrier waits for every live thread of cuda_runtime.h's stand-in
// grid, and the cluster group of a cluster launch (cudaLaunchKernelEx),
// which the stand-in runs as such a grid a cluster.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { host_cuda::grid_sync(); }
};

inline grid_group this_grid() { return {}; }

struct cluster_group {
  // every live thread of the cluster's blocks
  void sync() const {
    if (host_cuda::cluster_size == 0) {
      std::fprintf(stderr, "cuda_host: a cluster barrier outside a cluster "
                           "launch\n");
      std::abort();
    }
    host_cuda::grid_sync();
  }
  unsigned block_rank() const { return blockIdx.x % host_cuda::cluster_size; }
  unsigned num_blocks() const { return host_cuda::cluster_size; }
  // `addr`, a pointer into the caller's dynamic shared memory, at the same
  // offset in block `rank` of the cluster
  template <class T>
  T* map_shared_rank(T* addr, unsigned rank) const {
    const char* p = reinterpret_cast<const char*>(addr);
    const char* own = host_cuda::dynamic_shared;
    if (host_cuda::grid_shared == nullptr || rank >= host_cuda::cluster_size ||
        p < own || p >= own + host_cuda::grid_shm) {
      std::fprintf(stderr, "cuda_host: map_shared_rank of a pointer outside "
                           "the block's dynamic shared memory, or to no "
                           "block of the cluster\n");
      std::abort();
    }
    return reinterpret_cast<T*>(host_cuda::grid_shared +
                                size_t(rank) * host_cuda::grid_shm +
                                (p - own));
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
