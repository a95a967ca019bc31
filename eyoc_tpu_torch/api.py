"""User-facing convenience API (counterpart of eyoc_tpu/api.py:41-128).

`extract_features` voxelizes one numpy cloud (first-occurrence
representatives, ME.utils.sparse_quantize's return_index semantics), runs
the eval forward and returns (representative points, descriptors) for the
valid voxels as numpy arrays. The input features follow the reference's
conventions (util/misc.py:66-72): the occupancy when neither rgb nor normal
is given, else `rgb - 0.5` and / or `normal / 2`, each voxel taking its
representative point's values; the model's in_channels must match (1, 3
or 6). The first conv then reads 3 or 6 channels: K1's narrow-input route
(taps packed into K) on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eyoc_tpu_torch.training.pipeline import preprocess_clouds
from eyoc_tpu_torch.utils.device import resolve_device


def _derive_caps(n_points: int, num_levels: int) -> tuple:
    """Voxel capacities from the input size (eyoc_tpu/api.py:_derive_caps)."""
    voxel_cap = max(1024, 1 << math.ceil(math.log2(max(n_points // 4, 1))))
    caps = [voxel_cap]
    for _ in range(num_levels - 1):
        caps.append(max(caps[-1] // 3, 64))
    return tuple(caps)


def _channels(xyz: np.ndarray, rgb, normal):
    """The point features [N, 3 or 6] f32 (rgb - 0.5, then normal / 2), or
    None for the occupancy, after the reference's range checks
    (util/misc.py:49, :55)."""
    chans = []
    if rgb is not None:
        rgb = np.asarray(rgb, np.float32)
        if rgb.shape != xyz.shape:
            raise ValueError(f"rgb shape {rgb.shape} != xyz shape {xyz.shape}")
        if np.any(rgb > 1) or np.any(rgb < 0):
            raise ValueError("rgb must range in [0, 1]")
        chans.append(rgb - 0.5)
    if normal is not None:
        normal = np.asarray(normal, np.float32)
        if normal.shape != xyz.shape:
            raise ValueError(f"normal shape {normal.shape} != xyz "
                             f"{xyz.shape}")
        if np.any(np.abs(normal) > 1):
            raise ValueError("normal must range in [-1, 1]")
        chans.append(normal / 2.0)
    return np.hstack(chans).astype(np.float32) if chans else None


@torch.no_grad()
def extract_features(model, xyz: np.ndarray, *, rgb: np.ndarray | None = None,
                     normal: np.ndarray | None = None,
                     voxel_size: float = 0.05, caps: tuple | None = None,
                     window_bits: tuple = (10, 10, 9),
                     normalize_feature: bool | None = None, device=None,
                     spec=None, conv1_kernel_size: int = 5):
    """xyz [N, 3] (rgb [N, 3] in [0, 1], normal [N, 3] in [-1, 1]) ->
    (points [M, 3] f32, features [M, C] f32), M = valid voxels within
    capacity. `model` is a ResUNet already on `device` (its spec, input
    width and conv1 kernel size are its own), or a registry name (the JAX
    function's `model`; `spec`, when given, in its place): then a fresh
    ResUNet of that spec with the input width of the channels given and
    `conv1_kernel_size`, its weights drawn from a generator seeded 0.
    `normalize_feature` None keeps the model's setting."""
    device = resolve_device(device)
    xyz = np.asarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"expected [N, 3] xyz, got {xyz.shape}")
    n = xyz.shape[0]
    feats_np = _channels(xyz, rgb, normal)
    cin = 1 if feats_np is None else feats_np.shape[1]
    if isinstance(model, str):
        from eyoc_tpu_torch.models import init_unet, load_model
        spec = spec or load_model(model)
        model = init_unet(spec, torch.Generator().manual_seed(0), cin, 32,
                          conv1_kernel_size, device=device)
    if model.conv1.weight.shape[1] != cin:
        raise ValueError(f"the model reads {model.conv1.weight.shape[1]} "
                         f"input channels; the features given have {cin}")
    caps = caps or _derive_caps(n, model.spec.num_levels)
    pts = torch.from_numpy(xyz).to(device)[None]
    counts = torch.tensor([n], dtype=torch.int32, device=device)
    vox, pyr = preprocess_clouds(pts, counts, caps=caps, voxel_size=voxel_size,
                                 window_bits=window_bits)
    in_feats = None
    if feats_np is not None:
        # each voxel takes its representative point's features; a pad row's
        # index is n, a zero row (JAX's take(fpad, min(src, P)))
        fpad = torch.from_numpy(np.concatenate(
            [feats_np, np.zeros((1, cin), np.float32)])).to(device)
        in_feats = fpad[torch.clamp(vox.src[0].long(), max=n)]
    feats = model.embed(pyr, in_feats, normalize_feature)
    mask = vox.mask[0]
    return (vox.xyz[0][mask].cpu().numpy().astype(np.float32),
            feats[mask].cpu().numpy().astype(np.float32))
