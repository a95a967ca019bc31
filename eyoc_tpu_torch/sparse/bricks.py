"""Brick decomposition of the voxel pyramid
(counterpart of eyoc_tpu/sparse/bricks.py; outputs are bit-equal to it).

Level-l voxels are grouped into 2x2x2 bricks; the brick lattice of level l
is the voxel lattice of level l+1, so the pyramid is one recursion of
first-occurrence flags and prefix sums over Morton-sorted keys. Neighbour
bricks (`nbr6`) and the transposed conv's coarse window (`up_slots`) are
resolved through a transient dense z-column grid per level, as in the JAX
package.

Sentinels: voxel rows use morton.INVALID_KEY; brick rows use NBtot (one
past the end); cell slots use NBtot*8. JAX drops out-of-range scatter
indices silently; here every such scatter writes one extra dump row that is
sliced off afterwards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from eyoc_tpu_torch.sparse import morton, scan


class BrickLevel(NamedTuple):
    """Level-l voxels organized as 2x2x2 bricks. NBtot = B * brick_cap;
    cell row = brick_row * 8 + 4*(x&1) + 2*(y&1) + (z&1)."""

    bkeys: torch.Tensor     # [NBtot] int32 brick keys (level-(l+1) lattice)
    bmask: torch.Tensor     # [NBtot] bool
    bseg: torch.Tensor      # [NBtot] int32 cloud index
    occ: torch.Tensor       # [NBtot*8] bool cell occupancy
    nbr6: torch.Tensor      # [6, NBtot] int32 rows at -x,+x,-y,+y,-z,+z
    cellslot: torch.Tensor  # [M_l] int32 voxel row -> cell row
    up_slots: Optional[torch.Tensor]  # [NBtot, 8] level-(l+1) cell rows


class BrickPyramid(NamedTuple):
    levels: Tuple[BrickLevel, ...]
    vox_masks: Tuple[torch.Tensor, ...]  # [M_l] voxel validity per level


def take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [R, ...]; idx with sentinel R -> zero rows."""
    pad = arr.new_zeros((1,) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad], 0)[idx.long()]


def _scatter_drop(size: int, fill, idx: torch.Tensor, vals: torch.Tensor):
    """JAX `zeros(size).at[idx].set(vals, mode="drop")` for idx in
    [0, size]: index `size` lands in a dump row that is sliced off."""
    out = torch.full((size + 1,), fill, dtype=vals.dtype, device=vals.device)
    out[idx.long()] = vals
    return out[:size]


class _Skeleton(NamedTuple):
    bkeys: torch.Tensor
    bmask: torch.Tensor
    bseg: torch.Tensor
    occ: torch.Tensor
    cellslot: torch.Tensor
    valid_vox: torch.Tensor


def _i32(x):
    return x.to(torch.int32)


def _skeleton(keys: torch.Tensor, mask: torch.Tensor, B: int,
              brick_cap: int) -> _Skeleton:
    """Group level-l voxels into bricks: first flags + prefix sums."""
    dev = keys.device
    M = keys.shape[0]
    cap = M // B
    ar = torch.arange(M, dtype=torch.int32, device=dev)
    seg = ar // cap
    NBtot = B * brick_cap
    inv = torch.full_like(keys, morton.INVALID_KEY)

    bk = torch.where(mask, keys >> 3, inv)
    prev = torch.cat([bk.new_full((1,), -1), bk[:-1]])
    first = mask & ((bk != prev) | ((ar % cap) == 0))

    g = scan.cumsum(_i32(first))
    seg_base = torch.cat([g.new_zeros(1), g])[(seg * cap).long()]
    local_rank = g - 1 - seg_base
    ok_rank = first & (local_rank < brick_cap)
    brow_first = torch.where(ok_rank, seg * brick_cap + local_rank,
                             torch.full_like(g, NBtot))

    bkeys = _scatter_drop(NBtot, morton.INVALID_KEY, brow_first,
                          torch.where(first, bk, inv))
    bmask = _scatter_drop(NBtot, False, brow_first, first)
    bseg = torch.arange(NBtot, dtype=torch.int32, device=dev) // brick_cap

    # brick row of every voxel: position of the most recent first row
    last_first = scan.cummax(torch.where(first, ar, torch.full_like(ar, -1)))
    brow = torch.cat([brow_first, brow_first.new_full((1,), NBtot)])[
        torch.where(last_first >= 0, last_first,
                    torch.full_like(ar, M)).long()]
    valid_vox = mask & (last_first >= 0) & (brow < NBtot)
    cellslot = torch.where(valid_vox, brow * 8 + (keys & 7),
                           torch.full_like(brow, NBtot * 8))
    occ = _scatter_drop(NBtot * 8, False, cellslot, valid_vox)
    return _Skeleton(bkeys, bmask, bseg, occ, cellslot, valid_vox)


# the 6 faces + the positive-octant diagonals, in the JAX lookup order
FACE_OFFS = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
             (0, 0, 1)]
OCT_OFFS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
LOOKUP = FACE_OFFS + [o for o in OCT_OFFS
                      if o != (0, 0, 0) and o not in FACE_OFFS]

_ROW_BITS = 15
_PB_MASK = (1 << 14) - 1
_SENT = (1 << 30) - 1


def _neighbors(sk: _Skeleton, pb_local: Optional[torch.Tensor], B: int,
               level: int, brick_cap: int, cap_next: Optional[int], bits):
    """Resolve nbr6 [6, NBtot] and up_slots [NBtot, 8] (None at the deepest
    level) for one level from a transient dense z-column grid whose values
    pack (local brick row | parent-local row << 15)."""
    bkeys, bmask, bseg = sk.bkeys, sk.bmask, sk.bseg
    dev = bkeys.device
    NBtot = bkeys.shape[0]
    if brick_cap >= (1 << _ROW_BITS):
        raise ValueError("brick_cap exceeds the row-pack budget")
    GX, GY, GZ = morton.grid_dims(level + 1, bits)
    ncols = B * GX * GY
    bx, by, bz = morton.axes_of(bkeys)

    local_row = torch.arange(NBtot, dtype=torch.int32, device=dev) % brick_cap
    if pb_local is not None:
        if cap_next is None or cap_next > _PB_MASK:
            raise ValueError("parent capacity exceeds the row-pack budget")
        packed = local_row | (torch.clamp(pb_local, max=_PB_MASK) << _ROW_BITS)
    else:
        packed = local_row

    # rows 0..ncols-1 hold the columns; row `ncols` stays all-SENT for
    # out-of-window lookups; one more flat slot is the scatter dump
    size = (ncols + 1) * GZ
    ok_self = bmask & (bz >= 0) & (bz < GZ)
    flat_self = torch.where(ok_self, ((bseg * GX + bx) * GY + by) * GZ + bz,
                            torch.full_like(bz, size))
    grid = _scatter_drop(size, _SENT, flat_self, packed)

    def lookup(o):
        nx, ny, nz = bx + o[0], by + o[1], bz + o[2]
        okc = bmask & (nx >= 0) & (nx < GX) & (ny >= 0) & (ny < GY)
        row = torch.where(okc, (bseg * GX + nx) * GY + ny,
                          torch.full_like(nx, ncols))
        ok = bmask & (nz >= 0) & (nz < GZ)
        v = grid[(row * GZ + torch.clamp(nz, 0, GZ - 1)).long()]
        return torch.where(ok, v, torch.full_like(v, _SENT))

    vals = {o: lookup(o) for o in LOOKUP}

    def unpack_row(v):
        return torch.where(v != _SENT,
                           bseg * brick_cap + (v & ((1 << _ROW_BITS) - 1)),
                           torch.full_like(v, NBtot))

    nbr6 = torch.stack([unpack_row(vals[o]) for o in FACE_OFFS])
    if pb_local is None:
        return nbr6, None

    sent_next = B * cap_next * 8

    def up_slot(o):
        if o == (0, 0, 0):
            v, okv = packed, bmask
        else:
            v = vals[o]
            okv = v != _SENT
        pb = (v >> _ROW_BITS) & _PB_MASK
        ok = okv & (pb < cap_next)   # parent overflow -> no slot
        cell = ((((bx + o[0]) & 1) << 2) | (((by + o[1]) & 1) << 1)
                | ((bz + o[2]) & 1))
        slot = (bseg * cap_next + pb) * 8 + cell
        return torch.where(ok, slot, torch.full_like(slot, sent_next))

    up_slots = torch.stack([up_slot(o) for o in OCT_OFFS], dim=1)
    return nbr6, up_slots


def build_pyramid(keys0: torch.Tensor, mask0: torch.Tensor, B: int,
                  brick_caps: Tuple[int, ...],
                  bits: Tuple[int, int, int] = morton.BITS) -> BrickPyramid:
    """All L levels from per-segment-sorted level-0 keys [M0] and mask."""
    L = len(brick_caps)
    skels = []
    keys, mask = keys0, mask0
    for l in range(L):
        sk = _skeleton(keys, mask, B, brick_caps[l])
        skels.append(sk)
        keys, mask = sk.bkeys, sk.bmask

    levels = []
    for l in range(L):
        sk = skels[l]
        if l + 1 < L:
            nxt = skels[l + 1]
            pb_local = (nxt.cellslot >> 3) % brick_caps[l + 1]
            # parent overflow: the cellslot sentinel would alias onto a
            # valid row of a later segment under the modulo; mark it
            pb_local = torch.where(nxt.cellslot >= nxt.occ.shape[0],
                                   torch.full_like(pb_local, _PB_MASK),
                                   pb_local)
            nbr6, up_slots = _neighbors(sk, pb_local, B, l, brick_caps[l],
                                        brick_caps[l + 1], bits)
        else:
            nbr6, up_slots = _neighbors(sk, None, B, l, brick_caps[l], None,
                                        bits)
        levels.append(BrickLevel(
            bkeys=sk.bkeys, bmask=sk.bmask, bseg=sk.bseg, occ=sk.occ,
            nbr6=nbr6, cellslot=sk.cellslot, up_slots=up_slots))
    return BrickPyramid(levels=tuple(levels),
                        vox_masks=tuple(sk.valid_vox for sk in skels))
