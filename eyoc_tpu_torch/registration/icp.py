"""Fixed-iteration point-to-point ICP (counterpart of
eyoc_tpu/registration/icp.py), the refinement the reference runs with
Open3D on the legacy KITTI ground truth (reference lib/data_loaders.py:
484-515).

Each round: the nearest valid target of every valid warped source point
(`ops.knn.masked_argmin`, kernel K2 at D = 3), correspondences gated at
`max_corr_dist`, and the weighted Jacobi Kabsch of the original source on
its matches (kernel K18 `icp_solve`, which also warps the source by the
new pose for the next round). On the card a round is one K2 launch and
icp_solve's three (the moments and centroids, the cross-covariance and the
solve, the warp: each over the fixed grid of ICP_BLOCKS blocks), with no
host sync.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from eyoc_tpu_torch.geometry.se3 import transform_points
from eyoc_tpu_torch.geometry.svd3 import kabsch, kabsch_from_moments
from eyoc_tpu_torch.ops.knn import masked_argmin, masked_argmin_plain
from eyoc_tpu_torch.utils import kernels
from eyoc_tpu_torch.utils.device import resolve_device

F32 = torch.float32
# the order of icp_solve's sums that `icp_solve_chunked_plain` mirrors:
# csrc/ransac.cu's kIcpBlocks and kIcpThreads (the CPU tests hold the
# mirror's bits to the kernel source's at these)
ICP_BLOCKS, ICP_THREADS = 128, 256
_K18_ICP_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_float) \
    + (ctypes.c_void_p,) * 5


def icp_solve_plain(src, src_mask, tgt, nn, d2, r2: float):
    """(T [4, 4], warped [N, 3]): the weighted Kabsch of src on tgt[nn] with
    w = src_mask & (d2 < r2), and src under T."""
    w = (src_mask & (d2 < r2)).float()
    T = kabsch(src[None], tgt[nn.long()][None], w[None])[0]
    return T, transform_points(src, T)


def _block_sums(vals, blocks: int, threads: int):
    """Each block's sums [blocks, k] of vals [N, k] as icp_solve's launches
    add them: block b owns rows [b c, (b + 1) c) (c = ceil(N / blocks)),
    thread t of it rows b c + t + j threads in order of j, then the halving
    tree over the threads."""
    N, k = vals.shape
    chunk = -(-N // blocks)
    J = max(-(-chunk // threads), 1)
    v = vals.new_zeros((blocks * chunk, k))
    v[:N] = vals
    w = vals.new_zeros((blocks, J * threads, k))
    w[:, :chunk] = v.view(blocks, chunk, k)
    w = w.view(blocks, J, threads, k)
    acc = w[:, 0]
    for j in range(1, J):
        acc = acc + w[:, j]
    h = threads
    while h > 1:
        h //= 2
        acc = acc[:, :h] + acc[:, h:2 * h]
    return acc[:, 0]


def _in_block_order(part):
    """The partials [blocks, k] added in block order."""
    tot = torch.zeros_like(part[0])
    for b in range(part.shape[0]):
        tot = tot + part[b]
    return tot


def icp_solve_chunked_plain(src, src_mask, tgt, nn, d2, r2: float,
                            blocks: int = ICP_BLOCKS,
                            threads: int = ICP_THREADS):
    """`icp_solve_plain` with icp_solve's order of sums: each pass's sums by
    block (`_block_sums`) then added in block order; the centroids divide
    by w + 1e-6, the second pass sums the centred products over the same
    rows, and the pose is the Jacobi Kabsch of those moments."""
    w = src_mask & (d2 < r2)
    b = tgt[nn.long()]
    z = torch.zeros((), dtype=F32)
    a_w = torch.where(w[:, None], src, z)
    b_w = torch.where(w[:, None], b, z)
    tot = _in_block_order(_block_sums(
        torch.cat([w.float()[:, None], a_w, b_w], 1), blocks, threads))
    cen = tot[1:] / (tot[0] + torch.tensor(1e-6, dtype=F32))
    am, bm = src - cen[:3], b - cen[3:]
    prod = (am[:, :, None] * bm[:, None, :]).reshape(-1, 9)
    H = _in_block_order(_block_sums(torch.where(w[:, None], prod, z), blocks,
                                    threads)).view(3, 3)
    T = kabsch_from_moments(H, cen[:3], cen[3:])
    return T, transform_points(src, T)


def icp_solve(src, src_mask, tgt, nn, d2, r2: float):
    """K18 `icp_solve`: `icp_solve_plain` (its arguments and outputs) over
    the whole card, moments in two centred passes (the order of
    `icp_solve_chunked_plain`).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (three launches, counted once) or raises."""
    if src.is_cpu:
        return icp_solve_plain(src, src_mask, tgt, nn, d2, r2)
    return _launch_icp_solve(src, src_mask, tgt, nn, d2, r2)


def _scratch(n: int, device) -> torch.Tensor:
    """icp_solve's partial rows and centroids, then each source row's match
    (each written before read)."""
    return torch.empty(n, dtype=F32, device=device)


def _launch_icp_solve(src, src_mask, tgt, nn, d2, r2):
    fn = kernels.load("ransac", _K18_ICP_ARGS, symbol="icp_solve")
    scratch = kernels.load("ransac", (ctypes.c_int,), symbol="icp_scratch")
    dev = kernels.require_cuda("icp_solve", src, src_mask, tgt, nn, d2,
                               dtypes=(F32, torch.bool, F32, torch.int32,
                                       F32))
    N = src_mask.shape[0]
    if src.shape != (N, 3) or tgt.dim() != 2 or tgt.shape[1] != 3 \
            or nn.shape != (N,) or d2.shape != (N,):
        raise ValueError("icp_solve: expected src [N, 3], src_mask [N], "
                         "tgt [M, 3], nn [N], d2 [N]")
    T = torch.empty((4, 4), dtype=F32, device=src.device)
    warped = torch.empty_like(src)
    part = _scratch(scratch(N), src.device)
    p = kernels.ptr
    err = fn(p(src), p(src_mask), p(tgt), p(nn), p(d2), N, r2, p(part),
             p(kernels.ticket(dev, 2)), p(T), p(warped),
             kernels.stream_handle(dev))
    kernels.check_launch("icp_solve", err)
    return T, warped


def _icp(argmin, solve, src, src_mask, tgt, tgt_mask, init, max_corr_dist,
         iterations):
    r2 = max_corr_dist * max_corr_dist
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    T = init.float()
    warped = transform_points(src, T).contiguous()
    for _ in range(iterations):
        d2, nn = argmin(warped, src_mask, tgt, tgt_mask)
        T, warped = solve(src, src_mask, tgt, nn, d2, r2)
    d2, _ = argmin(warped, src_mask, tgt, tgt_mask)
    ok = src_mask & (d2 < r2)
    n_ok = torch.clamp(ok.sum().float(), min=1.0)
    fitness = n_ok / torch.clamp(src_mask.sum().float(), min=1.0)
    rmse = torch.sqrt(torch.where(ok, d2, torch.zeros_like(d2)).sum() / n_ok)
    return T, fitness, rmse


def icp_point_to_point(src: torch.Tensor, src_mask: torch.Tensor,
                       tgt: torch.Tensor, tgt_mask: torch.Tensor,
                       init: torch.Tensor, max_corr_dist: float = 0.2,
                       iterations: int = 100):
    """src [N, 3], src_mask [N], tgt [M, 3], tgt_mask [M], init [4, 4] (src
    -> tgt). Returns (T [4, 4], fitness, inlier_rmse): Open3D's result
    fields, as 0-dim tensors. A round is one `masked_argmin` and one
    `icp_solve` call; one more `masked_argmin` gives the fitness."""
    return _icp(masked_argmin, icp_solve, src, src_mask, tgt, tgt_mask, init,
                max_corr_dist, iterations)


def icp_point_to_point_plain(src, src_mask, tgt, tgt_mask, init,
                             max_corr_dist: float = 0.2,
                             iterations: int = 100):
    """`icp_point_to_point` through the plain versions (on any device)."""
    return _icp(masked_argmin_plain, icp_solve_plain, src, src_mask, tgt,
                tgt_mask, init, max_corr_dist, iterations)


def icp_inputs(xyz0, xyz1, *, voxel_size: float = 0.05, cap: int = 32768):
    """The reference's ICP inputs (lib/data_loaders.py:488-505): both clouds
    voxel-downsampled (first occurrence of each voxel, as
    ME.utils.sparse_quantize), at most `cap` points each (a RandomState(0)
    permutation), padded to one power of two from 256 up to `cap`. Returns
    numpy (src [B, 3], src_mask [B], tgt [B, 3], tgt_mask [B])."""
    def uniq(x):
        c = np.floor(x / voxel_size).astype(np.int64)
        _, sel = np.unique(c, axis=0, return_index=True)
        pts = x[np.sort(sel)]
        if len(pts) > cap:
            pts = pts[np.random.RandomState(0).permutation(len(pts))[:cap]]
        return pts

    s_pts = uniq(np.asarray(xyz0, np.float32))
    t_pts = uniq(np.asarray(xyz1, np.float32))
    buf = 256
    while buf < max(len(s_pts), len(t_pts)):
        buf *= 2
    buf = min(buf, cap)

    def pad(pts):
        out = np.zeros((buf, 3), np.float32)
        out[: len(pts)] = pts
        mask = np.zeros(buf, bool)
        mask[: len(pts)] = True
        return out, mask

    return (*pad(s_pts), *pad(t_pts))


def icp_refine_numpy(xyz0, xyz1, init, *, voxel_size: float = 0.05,
                     max_corr_dist: float = 0.2, iterations: int = 100,
                     cap: int = 32768, device=None):
    """The reference's ICP call site: `icp_inputs`, then ICP from `init` on
    the card (or `device`). Returns the refined [4, 4] numpy transform
    (float64)."""
    dev = resolve_device(device)
    s, sm, t, tm = (torch.from_numpy(a).to(dev) for a in icp_inputs(
        xyz0, xyz1, voxel_size=voxel_size, cap=cap))
    init = torch.from_numpy(np.asarray(init, np.float32)).to(dev)
    T, _, _ = icp_point_to_point(s, sm, t, tm, init,
                                 max_corr_dist=max_corr_dist,
                                 iterations=iterations)
    return T.double().cpu().numpy()
