"""Registration metrics (counterpart of eyoc_tpu/geometry/metrics.py).

RTE/RRE use the reference's diagonal clamp for arccos stability
(scripts/test_kitti.py:186-212); success is RTE < 2 m and RRE < 5 deg.
"""

from __future__ import annotations

import math

import torch


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


def registration_success(T_est, T_gt, rte_thresh: float = 2.0,
                         rre_thresh_deg: float = 5.0):
    """Returns (success_bool, rte, rre_deg)."""
    te = rte(T_est, T_gt)
    re = rre_deg(T_est, T_gt)
    ok = (te < rte_thresh) & (re < rre_thresh_deg) & torch.isfinite(re)
    return ok, te, re
