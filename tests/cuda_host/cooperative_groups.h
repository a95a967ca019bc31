// A host stand-in for the part of cooperative_groups.h that the port's
// kernels run on the CPU in the tests use (csrc/sc2_power_iteration.cu):
// the grid group of a cooperative launch, which cuda_runtime.h's stand-in
// runs as one block, so that the grid barrier is that block's
// __syncthreads.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { __syncthreads(); }
};

inline grid_group this_grid() { return {}; }

}  // namespace cooperative_groups
