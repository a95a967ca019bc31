"""Container for the fixed-capacity voxel layout
(counterpart of eyoc_tpu/sparse/types.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelizedCloud(NamedTuple):
    """One voxelized cloud (ME.utils.sparse_quantize semantics). Batched
    callers stack every field along a leading cloud dimension."""

    coords: torch.Tensor  # [CAP, 3] int32 lattice coords (0 at pad rows)
    xyz: torch.Tensor     # [CAP, 3] f32 representative point per voxel
    mask: torch.Tensor    # [CAP] bool
    count: torch.Tensor   # [] int32
    src: torch.Tensor     # [CAP] int64 source-point index (P at pad rows)
