"""User-facing convenience API (counterpart of eyoc_tpu/api.py:41).

`extract_features` voxelizes one numpy cloud (first-occurrence
representatives, ME.utils.sparse_quantize's return_index semantics), runs
the eval forward and returns (representative points, descriptors) for the
valid voxels as numpy arrays. Occupancy is the only input feature in this
slice; rgb/normal channels come with a later one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.training.pipeline import preprocess_clouds
from eyoc_tpu_torch.utils.device import resolve_device


def _derive_caps(n_points: int, num_levels: int) -> tuple:
    """Voxel capacities from the input size (eyoc_tpu/api.py:_derive_caps)."""
    voxel_cap = max(1024, 1 << math.ceil(math.log2(max(n_points // 4, 1))))
    caps = [voxel_cap]
    for _ in range(num_levels - 1):
        caps.append(max(caps[-1] // 3, 64))
    return tuple(caps)


@torch.no_grad()
def extract_features(model, xyz: np.ndarray, *, voxel_size: float = 0.05,
                     caps: tuple | None = None,
                     window_bits: tuple = (10, 10, 9), device=None):
    """xyz [N, 3] -> (points [M, 3] f32, features [M, C] f32), M = valid
    voxels within capacity. `model` must already live on `device`."""
    device = resolve_device(device)
    xyz = np.asarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"expected [N, 3] xyz, got {xyz.shape}")
    n = xyz.shape[0]
    caps = caps or _derive_caps(n, model.spec.num_levels)
    pts = torch.from_numpy(xyz).to(device)[None]
    counts = torch.tensor([n], dtype=torch.int32, device=device)
    vox, pyr = preprocess_clouds(pts, counts, caps=caps, voxel_size=voxel_size,
                                 window_bits=window_bits)
    feats = model(pyr)
    mask = vox.mask[0]
    return (vox.xyz[0][mask].cpu().numpy().astype(np.float32),
            feats[mask].cpu().numpy().astype(np.float32))
