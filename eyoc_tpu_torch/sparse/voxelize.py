"""Voxelization with `ME.utils.sparse_quantize` semantics
(counterpart of eyoc_tpu/sparse/voxelize.py).

quantize -> Morton keys -> one stable sort by key -> first-occurrence flags
-> prefix sum -> compaction to a fixed capacity. The stable sort orders
equal keys by original index, exactly as the JAX `(key, idx)` sort does, so
each voxel keeps the point with the lowest original index. Rows come out in
Morton order, the order the brick engine requires.
"""

from __future__ import annotations

import torch

from eyoc_tpu_torch.sparse import morton, scan
from eyoc_tpu_torch.sparse.types import VoxelizedCloud


def voxelize(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float,
             capacity: int, bits: tuple = morton.BITS) -> VoxelizedCloud:
    """Voxelize one padded cloud: xyz [P, 3] f32, mask [P] bool.

    Voxels beyond `capacity` are dropped (the count saturates)."""
    P = xyz.shape[0]
    dev = xyz.device
    coords = torch.floor(xyz / voxel_size).to(torch.int32)
    key = morton.encode(coords, mask, bits)
    key_s, idx_s = torch.sort(key, stable=True)
    idx_s = idx_s.to(torch.int32)
    valid_s = key_s != morton.INVALID_KEY
    first = torch.cat([valid_s[:1], valid_s[1:] & (key_s[1:] != key_s[:-1])])

    pos = scan.cumsum(first.to(torch.int32)) - 1
    count = torch.clamp(first.sum(dtype=torch.int32), max=capacity)
    # compaction by scatter: first occurrences land at their rank, the rest
    # (and ranks past capacity) in one dump slot that is sliced off
    slot = torch.where(first & (pos < capacity), pos,
                       torch.full_like(pos, capacity)).long()
    key_c = torch.full((capacity + 1,), morton.INVALID_KEY, dtype=torch.int32,
                       device=dev).scatter_(0, slot, key_s)[:capacity]
    idx_c = torch.full((capacity + 1,), P, dtype=torch.int32,
                       device=dev).scatter_(0, slot, idx_s)[:capacity]

    out_mask = torch.arange(capacity, device=dev) < count
    out_key = torch.where(out_mask, key_c,
                          torch.full_like(key_c, morton.INVALID_KEY))
    out_src = torch.where(out_mask, idx_c, torch.full_like(idx_c, P))
    sh = torch.tensor(morton.shift(bits), dtype=torch.int32, device=dev)
    out_coords = torch.where(out_mask[:, None], morton.decode(out_key) - sh,
                             torch.zeros((), dtype=torch.int32, device=dev))
    xyz_pad = torch.cat([xyz, xyz.new_zeros((1, 3))], 0)
    out_xyz = xyz_pad[out_src.long()]
    return VoxelizedCloud(out_coords, out_xyz, out_mask, count, out_src)
