"""Registration metrics (counterpart of eyoc_tpu/geometry/metrics.py).

RTE/RRE use the reference's diagonal clamp for arccos stability
(scripts/test_kitti.py:186-212); success is RTE < 2 m and RRE < 5 deg.
`hit_ratio` is the labeling's share of matches within a threshold under a
pose (reference lib/trainer.py:421-424); `corr_dist` the valid step's loss.
"""

from __future__ import annotations

import math

import torch

from eyoc_tpu_torch.geometry.se3 import transform_points


def pdist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances a [..., N, D], b [..., M, D] -> [..., N, M].

    The cross term runs in full f32 (TF32 off): coordinate-scale inputs
    would otherwise carry square-meter noise."""
    d2 = (torch.sum(a * a, -1)[..., :, None]
          - 2.0 * torch.matmul(a, b.transpose(-1, -2))
          + torch.sum(b * b, -1)[..., None, :])
    return torch.clamp(d2, min=0.0)


def pdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise L2 distances, sqrt(pdist2 + 1e-7) (metrics.py:40-41)."""
    return torch.sqrt(pdist2(a, b) + 1e-7)


def rte(T_est: torch.Tensor, T_gt: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(T_est[..., :3, 3] - T_gt[..., :3, 3], dim=-1)


def rre_deg(T_est: torch.Tensor, T_gt: torch.Tensor) -> torch.Tensor:
    """Rotation error in degrees with the reference's diagonal clamp."""
    M = T_est[..., :3, :3].transpose(-1, -2) @ T_gt[..., :3, :3]
    diag = torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), max=1.0)
    cos_angle = torch.clamp((diag.sum(-1) - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(cos_angle) * (180.0 / math.pi)


def hit_ratio(xyz0_corr, xyz1_corr, T_gt, thresh: float, mask=None):
    """Fraction of correspondences [..., M, 3] within `thresh` after
    warping the first by T_gt [..., 4, 4] (metrics.py:70-84); over the
    `mask`ed ones when given (0 when none is)."""
    d = transform_points(xyz0_corr, T_gt) - xyz1_corr
    hit = (torch.sqrt(torch.sum(d * d, -1)) < thresh).to(torch.float32)
    if mask is None:
        return torch.mean(hit, -1)
    m = mask.to(torch.float32)
    return torch.sum(hit * m, -1) / torch.clamp(torch.sum(m, -1), min=1.0)


def registration_success(T_est, T_gt, rte_thresh: float = 2.0,
                         rre_thresh_deg: float = 5.0):
    """Returns (success_bool, rte, rre_deg)."""
    te = rte(T_est, T_gt)
    re = rre_deg(T_est, T_gt)
    ok = (te < rte_thresh) & (re < rre_thresh_deg) & torch.isfinite(re)
    return ok, te, re


def corr_dist(T_est, T_gt, xyz0, max_dist: float = 1.0, mask=None):
    """Mean distance between xyz0 [..., M, 3] warped by T_est and by T_gt,
    each clamped at `max_dist` (metrics.py:87-103, whose xyz1 and weight
    it never reads); over the `mask`ed rows when given, divided by
    max(sum(mask), 1)."""
    d = transform_points(xyz0, T_est) - transform_points(xyz0, T_gt)
    dist = torch.clamp(torch.sqrt(torch.sum(d * d, -1)), max=max_dist)
    if mask is None:
        return torch.mean(dist, -1)
    m = mask.to(torch.float32)
    return torch.sum(dist * m, -1) / torch.clamp(torch.sum(m, -1), min=1.0)
