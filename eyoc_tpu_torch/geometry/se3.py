"""SE(3) rigid-transform utilities (counterpart of eyoc_tpu/geometry/se3.py)."""

from __future__ import annotations

import torch


def transform_points(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform: pts [..., N, 3], trans [..., 4, 4].

    Full f32 product (TF32 is off, utils/device.py): at LiDAR coordinate
    scale a reduced-precision product puts decimeters of noise on the
    warped points."""
    R = trans[..., :3, :3]
    t = trans[..., :3, 3]
    return torch.matmul(pts, R.transpose(-1, -2)) + t[..., None, :]


def integrate_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]
    (also [..., 3, 1] or [..., 1, 3])."""
    batch = R.shape[:-2]
    t = t.reshape(batch + (3,))
    out = torch.eye(4, dtype=R.dtype, device=R.device).expand(
        batch + (4, 4)).clone()
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    return out
