// A host stand-in for the part of cooperative_groups.h that the port's
// kernels run on the CPU in the tests use (csrc/sc2_power_iteration.cu,
// norm_backward.cu): the grid group of a cooperative launch, whose barrier
// waits for every live thread of cuda_runtime.h's stand-in grid.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { host_cuda::grid_sync(); }
};

inline grid_group this_grid() { return {}; }

}  // namespace cooperative_groups
