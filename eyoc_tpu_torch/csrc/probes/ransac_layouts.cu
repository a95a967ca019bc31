// K16's solve-and-count pass in a second layout, to time against the one
// csrc/ransac.cu runs (one thread a survivor, its 512 subset rows in a
// loop): one warp a survivor, every lane solving the same pose (the same
// bits: one warp instruction stream either way), the subset rows split
// over the lanes and the counts added by a fixed xor-shuffle tree. The
// entry runs K16's two-stage pipeline with this pass in place of
// solve_count; its outputs are the kernel's, bit for bit. Not part of the
// port: profile_k16_layouts.py builds and runs it.

#include "../ransac.cu"

namespace {

constexpr int kWarpThreads = 128;     // four survivors a block

__global__ void __launch_bounds__(kWarpThreads) solve_count_warp(
    const float* __restrict__ src, const float* __restrict__ tgt, int N,
    const float* __restrict__ u_tri, int S, float thr2,
    const float* __restrict__ scratch, int* __restrict__ ctl,
    const int* __restrict__ surv, float* __restrict__ coarse) {
  __shared__ float tile[kSubTile][6];
  __shared__ int bins[kMaxBins];
  constexpr int kWarps = kWarpThreads / 32;
  const int nsurv = ctl[kSurvivors];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int first = blockIdx.x * kWarps;
  if (first >= nsurv) return;
  const float countf = (float)reinterpret_cast<const int*>(scratch)[0];
  for (int i = t; i <= S; i += kWarpThreads) bins[i] = 0;
  for (int e = t; e < 6 * S; e += kWarpThreads)
    tile[e / 6][e % 6] = scratch[1 + e];
  __syncthreads();
  for (int j = first + warp; j < nsurv; j += gridDim.x * kWarps) {
    const int h = surv[j];
    float a[3][3], b[3][3], pose[16];
    load_triplet(src, tgt, N, u_tri + 3ll * h, countf, a, b);
    triplet_pose(a, b, pose);
    int c = 0;
    for (int i = lane; i < S; i += 32)
      c += residual2(pose, tile[i][0], tile[i][1], tile[i][2], tile[i][3],
                     tile[i][4], tile[i][5]) < thr2;
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xFFFFFFFFu, c, off);
    if (lane == 0) {
      coarse[h] = (float)c;
      atomicAdd(bins + c, 1);
    }
  }
  __syncthreads();
  for (int i = t; i <= S; i += kWarpThreads)
    if (bins[i]) atomicAdd(ctl + kHist + i, bins[i]);
}

}  // namespace

// eyoc_ransac_hypotheses_topk's arguments (the cache unused); S <= 512
// (the subset staged once).
extern "C" int eyoc_probe_topk_warp(
    const float* src, const float* tgt, const bool* valid, int N,
    const float* u_tri, int H, const float* u_sub, int S, float thr2,
    float lo, float hi, int k, float* scratch, int* ctl, int* surv,
    int* kept_j, unsigned long long* kept, float* cache, int C,
    float* coarse, int* keep, float* kept_coarse, float* trans,
    cudaStream_t stream) {
  if (N <= 0 || H <= 0 || H >= (1 << 30) || S <= 0 || S > kSubTile ||
      k <= 0 || k > H || k > kMaxTop)
    return cudaErrorInvalidValue;
  const int tiles = (H + kTile - 1) / kTile;
  const int nctl = eyoc_ransac_topk_ctl(H, S);
  unsigned* edge_status = reinterpret_cast<unsigned*>(ctl + kHist + S + 1);
  unsigned* select_status = edge_status + tiles;
  prep<<<1, kPrepThreads, 0, stream>>>(src, tgt, valid, N, u_sub, S,
                                       scratch, ctl, nctl);
  edge<<<tiles, kScanThreads, 0, stream>>>(src, tgt, N, u_tri, H, lo, hi,
                                           scratch, ctl, edge_status, surv,
                                           coarse);
  const int blocks = (H + 3) / 4 < 8 * kCountBlocks ? (H + 3) / 4
                                                      : 8 * kCountBlocks;
  solve_count_warp<<<blocks, kWarpThreads, 0, stream>>>(
      src, tgt, N, u_tri, S, thr2, scratch, ctl, surv, coarse);
  select_top<<<tiles < kSelectBlocks ? tiles : kSelectBlocks, kScanThreads,
               0, stream>>>(coarse, S, k, surv, ctl, select_status, kept);
  sort_top<<<1, kSortThreads, 0, stream>>>(coarse, k, surv, ctl, kept, keep,
                                           kept_coarse, kept_j);
  // this pass keeps no pose: every kept pose is solved again
  kept_poses<<<(k + kPoseThreads - 1) / kPoseThreads, kPoseThreads, 0,
               stream>>>(src, tgt, N, u_tri, scratch, keep, kept_j, cache,
                         0, k, trans);
  return cudaGetLastError();
}
