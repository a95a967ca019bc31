// A check of the stand-in's cluster launch (tests/cuda_host/): each block
// of a cluster adds its part of x in its dynamic shared memory, then, after
// the cluster's barrier, reads every block's sum of its cluster through
// map_shared_rank in rank order. out[blockIdx.x] is the cluster's total as
// that block read it, rank[blockIdx.x] its rank.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;

__global__ void cluster_sum(const float* x, int n, float* out, int* rank) {
  extern __shared__ float part[];          // [kThreads]: the sums, then [0]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), r = cluster.block_rank();
  const int t = threadIdx.x;
  const int per = (n + (int)gridDim.x - 1) / (int)gridDim.x;
  const int lo = min(n, (int)blockIdx.x * per), hi = min(n, lo + per);
  float s = 0.f;
  for (int i = lo + t; i < hi; i += kThreads) s += x[i];
  part[t] = s;
  __syncthreads();
  if (t == 0)
    for (int k = 1; k < kThreads; ++k) part[0] += part[k];
  cluster.sync();
  if (t == 0) {
    float total = 0.f;
    for (int k = 0; k < C; ++k) total += *cluster.map_shared_rank(part, k);
    out[blockIdx.x] = total;
    rank[blockIdx.x] = r;
  }
  cluster.sync();                          // no block leaves while read
}

}  // namespace

// x [n] split into gridDim.x consecutive parts, one a block.
extern "C" int eyoc_cluster_sum(const float* x, int n, int clusters,
                                int cluster, float* out, int* rank) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3{(unsigned)(clusters * cluster), 1, 1};
  cfg.blockDim = dim3{(unsigned)kThreads, 1, 1};
  cfg.dynamicSmemBytes = kThreads * sizeof(float);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_sum, x, n, out,
                                             rank);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
