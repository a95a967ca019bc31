"""Voxelization with `ME.utils.sparse_quantize` semantics
(counterpart of eyoc_tpu/sparse/voxelize.py).

quantize -> Morton keys -> one sort by (key, original index) ->
first-occurrence flags -> prefix sum -> compaction to a fixed capacity.
Each voxel keeps the point with the lowest original index, and rows come
out in Morton order, the order the brick engine requires.

On the card this is kernel K10 (`csrc/voxelize.cu`), for all B clouds of
a call at once: `voxel_keys` packs (cloud, key, index) into one int64 per
point, one `torch.sort` of the B*P keys orders every cloud as the JAX
`(key, idx)` sort does (the keys are distinct, so no stable sort is
needed), and `voxel_compact` (one block a cloud) flags, scans and
compacts, and writes the level-0 Morton keys beside the voxels.
`voxelize` (one cloud, plain torch) and `voxelize_batched_plain` (each
cloud in turn) are the plain version; `voxelize_composite_plain` is K10's
reformulation in plain torch, for the CPU tests.
"""

from __future__ import annotations

import ctypes

import torch

from eyoc_tpu_torch.sparse import morton, scan
from eyoc_tpu_torch.sparse.types import VoxelizedCloud
from eyoc_tpu_torch.utils import kernels


def quantize(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(xyz / voxel_size) as int32, by IEEE f32 division. The divisor
    is a tensor on xyz's device: torch turns the division of a CUDA tensor
    by a Python number into a multiplication by its reciprocal, which puts
    a point that lies within an ulp of a voxel face into the next voxel."""
    v = torch.tensor(voxel_size, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz / v).to(torch.int32)


def voxelize(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float,
             capacity: int, bits: tuple = morton.BITS) -> VoxelizedCloud:
    """Voxelize one padded cloud: xyz [P, 3] f32, mask [P] bool.

    Voxels beyond `capacity` are dropped (the count saturates)."""
    P = xyz.shape[0]
    dev = xyz.device
    coords = quantize(xyz, voxel_size)
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


def voxelize_batched_plain(xyz, counts, voxel_size: float, capacity: int,
                           bits: tuple = morton.BITS):
    """`voxelize` for each of the B clouds [B, P, 3] (point p of cloud
    b valid where p < counts[b]), stacked; with the level-0 Morton keys
    [B * capacity] of the voxels (INVALID_KEY at pad rows)."""
    P = xyz.shape[1]
    pmask = torch.arange(P, device=xyz.device)[None, :] < counts[:, None]
    clouds = [voxelize(xyz[b], pmask[b], voxel_size, capacity, bits)
              for b in range(xyz.shape[0])]
    vox = VoxelizedCloud(*(torch.stack(f) for f in zip(*clouds)))
    keys = morton.encode(vox.coords, vox.mask, bits).reshape(-1)
    return vox, keys


def index_bits(P: int) -> int:
    """Bits of the point index in K10's sort key: ceil(log2(P + 1))."""
    return P.bit_length()


def composite_keys_plain(xyz, counts, voxel_size: float, bits: tuple):
    """K10's `voxel_keys` in plain torch: (cloud << (31 + pbits)) | (key <<
    pbits) | index per point, int64 [B * P]; key is INVALID_KEY (31 bits)
    for a masked or out-of-window point, so it sorts last in its cloud."""
    B, P = xyz.shape[:2]
    pbits = index_bits(P)
    pmask = torch.arange(P, device=xyz.device)[None, :] < counts[:, None]
    key = morton.encode(quantize(xyz, voxel_size), pmask, bits).long()
    seg = torch.arange(B, device=xyz.device)[:, None]
    idx = torch.arange(P, device=xyz.device)[None, :]
    return ((seg << (31 + pbits)) | (key << pbits) | idx).reshape(-1)


def voxelize_composite_plain(xyz, counts, voxel_size: float, capacity: int,
                             bits: tuple = morton.BITS):
    """K10's reformulation in plain torch, for the CPU tests: one sort of
    the B*P composite keys, then per cloud the first-occurrence flags, the
    prefix count and the compaction (`voxel_compact`). Returns what
    `voxelize_batched_plain` returns, bit for bit."""
    B, P = xyz.shape[:2]
    dev = xyz.device
    pbits = index_bits(P)
    srt = torch.sort(composite_keys_plain(xyz, counts, voxel_size, bits)
                     ).values.reshape(B, P)
    key = ((srt >> pbits) & 0x7FFFFFFF).to(torch.int32)
    idx = (srt & ((1 << pbits) - 1)).to(torch.int32)
    valid = key != morton.INVALID_KEY
    first = valid.clone()
    first[:, 1:] &= key[:, 1:] != key[:, :-1]
    rank = torch.cumsum(first.to(torch.int32), 1, dtype=torch.int32) - 1
    count = torch.clamp(first.sum(1, dtype=torch.int32), max=capacity)
    keep = first & (rank < capacity)
    b_of, p_of = keep.nonzero(as_tuple=True)
    out_key = torch.full((B, capacity), morton.INVALID_KEY, dtype=torch.int32,
                         device=dev)
    out_src = torch.full((B, capacity), P, dtype=torch.int32, device=dev)
    out_key[b_of, rank[b_of, p_of].long()] = key[b_of, p_of]
    out_src[b_of, rank[b_of, p_of].long()] = idx[b_of, p_of]
    mask = out_key != morton.INVALID_KEY
    sh = torch.tensor(morton.shift(bits), dtype=torch.int32, device=dev)
    coords = torch.where(mask[..., None], morton.decode(out_key) - sh,
                         torch.zeros((), dtype=torch.int32, device=dev))
    xyz_pad = torch.cat([xyz, xyz.new_zeros((B, 1, 3))], 1)
    out_xyz = torch.gather(xyz_pad, 1, out_src.long()[..., None].expand(
        B, capacity, 3))
    vox = VoxelizedCloud(coords, out_xyz, mask, count, out_src)
    return vox, out_key.reshape(-1)


# ---------------------------------------------------------------- kernel K10

_KEYS_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_COMPACT_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def voxelize_batched(xyz, counts, voxel_size: float, capacity: int,
                     bits: tuple = morton.BITS):
    """Voxelize B padded clouds xyz [B, P, 3] f32 (point p of cloud b valid
    where p < counts[b], counts [B] int32). Returns (VoxelizedCloud with
    fields [B, capacity, ...] and count [B], level-0 Morton keys
    [B * capacity] int32, INVALID_KEY at pad rows).

    A CPU tensor takes the plain version; a CUDA tensor launches K10 (two
    launches around one torch.sort) or raises."""
    if xyz.is_cpu:
        return voxelize_batched_plain(xyz, counts, voxel_size, capacity, bits)
    return _launch_k10(xyz, counts, voxel_size, capacity, bits)


def _launch_k10(xyz, counts, voxel_size, capacity, bits):
    keys_fn = kernels.load("voxelize", _KEYS_ARGS, symbol="voxel_keys")
    compact_fn = kernels.load("voxelize", _COMPACT_ARGS,
                              symbol="voxel_compact")
    dev = kernels.require_cuda("voxelize", xyz, counts,
                               dtypes=(torch.float32, torch.int32))
    B, P = xyz.shape[:2]
    if xyz.shape != (B, P, 3) or counts.shape != (B,):
        raise ValueError("voxelize: expected xyz [B, P, 3] and counts [B]")
    pbits = index_bits(P)
    if max(B - 1, 0).bit_length() + 31 + pbits > 63:
        raise ValueError(f"voxelize: {B} clouds of {P} points overflow the "
                         "int64 sort key")
    s = kernels.stream_handle(dev)
    p = kernels.ptr
    keys = torch.empty(B * P, dtype=torch.int64, device=xyz.device)
    err = keys_fn(p(xyz), p(counts), B, P, float(voxel_size), *bits, pbits,
                  p(keys), s)
    kernels.check_error("voxelize", err)
    srt = torch.sort(keys).values
    coords = torch.empty((B, capacity, 3), dtype=torch.int32,
                         device=xyz.device)
    out_xyz = torch.empty((B, capacity, 3), dtype=torch.float32,
                          device=xyz.device)
    out_mask = torch.empty((B, capacity), dtype=torch.bool, device=xyz.device)
    count = torch.empty(B, dtype=torch.int32, device=xyz.device)
    src = torch.empty((B, capacity), dtype=torch.int32, device=xyz.device)
    out_keys = torch.empty(B * capacity, dtype=torch.int32, device=xyz.device)
    sh = morton.shift(bits)
    err = compact_fn(p(srt), p(xyz), B, P, capacity, pbits, *sh,
                     p(coords), p(out_xyz), p(out_mask), p(count), p(src),
                     p(out_keys), s)
    kernels.check_launch("voxelize", err)
    return VoxelizedCloud(coords, out_xyz, out_mask, count, src), out_keys
