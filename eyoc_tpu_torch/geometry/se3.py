"""SE(3) rigid-transform utilities (counterpart of eyoc_tpu/geometry/se3.py):
the warp, the 4x4 from (R, t), and the axis rotations of the IRLS
(geometry/robust.py)."""

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


def _parts(theta: torch.Tensor):
    c, s = torch.cos(theta), torch.sin(theta)
    return c, s, torch.zeros_like(c), torch.ones_like(c)


def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x(theta: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation about x by theta [...] (se3.py:74-110)."""
    c, s, z, o = _parts(theta)
    return _mat3(((o, z, z), (z, c, -s), (z, s, c)))


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    c, s, z, o = _parts(theta)
    return _mat3(((c, z, s), (z, o, z), (-s, z, c)))


def rot_z(theta: torch.Tensor) -> torch.Tensor:
    c, s, z, o = _parts(theta)
    return _mat3(((c, -s, z), (s, c, z), (z, z, o)))
