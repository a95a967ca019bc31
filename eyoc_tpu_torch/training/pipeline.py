"""Batch preprocessing: raw padded clouds -> voxels -> brick pyramid
(counterpart of eyoc_tpu/training/pipeline.py).

The B clouds of a batch are concatenated row-wise in per-cloud capacity
slices; the brick engine keeps the segments independent, so features come
back as [B*cap, C] aligned with the per-cloud voxel arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eyoc_tpu_torch.geometry.se3 import transform_points
from eyoc_tpu_torch.ops.knn import masked_argmin_batched
from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.sparse.bricks import (BrickPyramid, build_pyramid,
                                          build_pyramid_plain)
from eyoc_tpu_torch.sparse.types import VoxelizedCloud
from eyoc_tpu_torch.sparse.voxelize import (voxelize_batched,
                                            voxelize_batched_plain)


class RawBatch(NamedTuple):
    """One batch of padded raw pairs (tensors, or numpy before `to`)."""

    xyz0: torch.Tensor           # [B, P, 3] f32
    n0: torch.Tensor             # [B] int32 true point counts
    xyz1: torch.Tensor           # [B, P, 3]
    n1: torch.Tensor             # [B]
    T_gt: torch.Tensor           # [B, 4, 4]
    frame_distance: torch.Tensor  # [B] int32
    search_radius: torch.Tensor  # [B] f32

    def to(self, device) -> "RawBatch":
        return RawBatch(*(torch.as_tensor(x).to(device) for x in self))


def brick_caps(caps: Tuple[int, ...]) -> Tuple[int, ...]:
    """Per-level brick capacities: brick_caps[l] = caps[l+1]; the deepest
    level gets max(256, caps[-1] // 2)."""
    return tuple(caps[1:]) + (max(256, caps[-1] // 2),)


def preprocess_clouds(xyz: torch.Tensor, counts: torch.Tensor, *,
                      caps: Tuple[int, ...], voxel_size: float,
                      window_bits: Tuple[int, int, int] = morton.BITS):
    """Voxelize + build the brick pyramid for raw clouds [B, P, 3] (counts
    [B] int32).

    Returns (vox with [B, cap0] fields, BrickPyramid whose level-0 voxel
    rows are the flattened [B*cap0] vox rows). Voxels dropped by the window
    or by brick-capacity overflow are invalid in `vox.mask` too. On the
    card this is K10 (two launches around one torch.sort) and K11 (two
    launches) and nothing else: no host sync, no dense grid."""
    return _preprocess(voxelize_batched, build_pyramid, xyz, counts, caps,
                       voxel_size, window_bits)


def preprocess_clouds_plain(xyz: torch.Tensor, counts: torch.Tensor, *,
                            caps: Tuple[int, ...], voxel_size: float,
                            window_bits: Tuple[int, int, int] = morton.BITS):
    """`preprocess_clouds` through the plain versions on any device (one
    voxelize a cloud, the Morton keys encoded again, the grid pyramid)."""
    return _preprocess(voxelize_batched_plain, build_pyramid_plain, xyz,
                       counts, caps, voxel_size, window_bits)


def _preprocess(voxelize, pyramid, xyz, counts, caps, voxel_size,
                window_bits):
    B = xyz.shape[0]
    cap = caps[0]
    vox, keys = voxelize(xyz, counts, voxel_size, cap, window_bits)
    pyr: BrickPyramid = pyramid(keys, vox.mask.reshape(B * cap), B,
                                brick_caps(caps), window_bits)
    vox = vox._replace(mask=pyr.vox_masks[0].reshape(B, cap),
                       count=pyr.counts)
    return vox, pyr


def gt_positive_pairs(vox0: VoxelizedCloud, vox1: VoxelizedCloud,
                      trans: torch.Tensor, search_radius: torch.Tensor):
    """GT correspondences (pipeline.py:92-119): warp cloud 0's voxel
    representatives by `trans`, 1-NN into cloud 1, keep pairs within
    `search_radius`; the B items in one batched warp and one call of
    `masked_argmin_batched` (one K2 launch on the card, the JAX `vmap`).

    vox fields [B, cap, ...], trans [B, 4, 4], search_radius [B]. Returns
    (idx0, idx1, valid), each [B, cap]: idx0 is the row index, idx1 int32,
    valid = m0 & (d2 < r^2)."""
    B, cap = vox0.mask.shape
    warped = transform_points(vox0.xyz, trans).contiguous()
    d2, nn = masked_argmin_batched(warped, vox0.mask, vox1.xyz.contiguous(),
                                   vox1.mask)
    r2 = (search_radius * search_radius)[:, None]
    i0 = torch.arange(cap, dtype=torch.int32, device=vox0.mask.device)
    return i0.expand(B, cap), nn, vox0.mask & (d2 < r2)


def flatten_pairs(idx0, idx1, valid, cap0: int, cap1: int):
    """Per-item pair indices [B, M] -> flat collated indices [B*M] into the
    [B*cap] feature layout (pipeline.py:122-133)."""
    B = idx0.shape[0]
    ar = torch.arange(B, dtype=torch.int32, device=idx0.device)[:, None]
    return ((idx0 + ar * cap0).reshape(-1), (idx1 + ar * cap1).reshape(-1),
            valid.reshape(-1))
