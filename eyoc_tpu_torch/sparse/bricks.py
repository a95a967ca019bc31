"""Brick decomposition of the voxel pyramid
(counterpart of eyoc_tpu/sparse/bricks.py; outputs are bit-equal to it).

Level-l voxels are grouped into 2x2x2 bricks; the brick lattice of level l
is the voxel lattice of level l+1, so the pyramid is one recursion of
first-occurrence flags and prefix sums over Morton-sorted keys. Neighbour
bricks (`nbr6`) and the transposed conv's coarse window (`up_slots`) are
the bricks at given offsets.

On the card `build_pyramid` is kernel K11 (`csrc/brick_pyramid.cu`), two
launches: the skeleton of every level in one pass over the level-0 rows
(a block a tile of K11_TILE rows, the tiles chained by a look-back), then
one thread a (brick row, lookup) that binary-searches the neighbour's
Morton key among its cloud's brick keys, which are sorted. The plain
version (`build_pyramid_plain`) resolves the lookups through a transient
dense z-column grid per level, as the JAX package does, of
B * GX * GY * GZ int32 (134 MB at level 0 for B = 8 and bits (9, 9, 7));
K11 allocates no grid. `build_pyramid_onepass_plain` is K11's
reformulation in plain torch, for the CPU tests.

Sentinels: voxel rows use morton.INVALID_KEY; brick rows use NBtot (one
past the end); cell slots use NBtot*8. JAX drops out-of-range scatter
indices silently; here every such scatter writes one extra dump row that is
sliced off afterwards.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from eyoc_tpu_torch.sparse import morton, scan
from eyoc_tpu_torch.utils import kernels


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
    counts: Optional[torch.Tensor] = None  # [B] int32 valid level-0 voxels


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
    GX, GY, GZ = morton.grid_dims(level + 1, bits)
    ncols = B * GX * GY
    bx, by, bz = morton.axes_of(bkeys)

    local_row = torch.arange(NBtot, dtype=torch.int32, device=dev) % brick_cap
    if pb_local is not None:
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


def _check_caps(brick_caps) -> None:
    """The grid values' row-pack budget (a brick row in 15 bits, a parent
    row under _PB_MASK), level by level: every version refuses what the
    JAX package's `_neighbors` refuses."""
    for l, bc in enumerate(brick_caps):
        if bc >= (1 << _ROW_BITS):
            raise ValueError("brick_cap exceeds the row-pack budget")
        if l + 1 < len(brick_caps) and brick_caps[l + 1] > _PB_MASK:
            raise ValueError("parent capacity exceeds the row-pack budget")


def _parent_local(nxt: _Skeleton, cap_next: int) -> torch.Tensor:
    """[NBtot] parent brick row of each brick within its cloud: level-l
    brick row r is level-(l+1) voxel row r, whose brick is cellslot >> 3.
    Parent overflow is marked _PB_MASK: the cellslot sentinel would alias
    onto a valid row of a later cloud under the modulo."""
    pb_local = (nxt.cellslot >> 3) % cap_next
    return torch.where(nxt.cellslot >= nxt.occ.shape[0],
                       torch.full_like(pb_local, _PB_MASK), pb_local)


def build_pyramid_plain(keys0: torch.Tensor, mask0: torch.Tensor, B: int,
                        brick_caps: Tuple[int, ...],
                        bits: Tuple[int, int, int] = morton.BITS
                        ) -> BrickPyramid:
    """All L levels from per-segment-sorted level-0 keys [M0] and mask."""
    _check_caps(brick_caps)
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
            pb_local = _parent_local(skels[l + 1], brick_caps[l + 1])
            nbr6, up_slots = _neighbors(sk, pb_local, B, l, brick_caps[l],
                                        brick_caps[l + 1], bits)
        else:
            nbr6, up_slots = _neighbors(sk, None, B, l, brick_caps[l], None,
                                        bits)
        levels.append(BrickLevel(
            bkeys=sk.bkeys, bmask=sk.bmask, bseg=sk.bseg, occ=sk.occ,
            nbr6=nbr6, cellslot=sk.cellslot, up_slots=up_slots))
    return BrickPyramid(levels=tuple(levels),
                        vox_masks=tuple(sk.valid_vox for sk in skels),
                        counts=skels[0].valid_vox.reshape(B, -1).sum(
                            1, dtype=torch.int32))


# K11's reformulation in plain torch, for the CPU tests: every level's
# skeleton from one pass over the level-0 rows, tile by tile with a carried
# state, and each lookup a binary search among the cloud's brick keys
# instead of a dense grid.

K11_TILE = 512         # level-0 rows a skeleton block (eval: 32 blocks)
K11_MAX_LEVELS = 8     # csrc/brick_pyramid.cu: kMaxLevels
_POISON = -(1 << 30)   # an output row that nothing wrote


def _onepass_counts_plain(k: torch.Tensor, m: torch.Tensor, L: int,
                          tile: int):
    """(fields, incl) [B, cap, L + 1] over each cloud's level-0 rows k, m
    [B, cap], as K11's skeleton counts them: field 0 a valid row, field 1 +
    l a row where a level-l brick starts (uncapped), and each field's
    inclusive count, tile by tile with a carried state (each field's count
    and the key of the last valid row)."""
    B, cap = k.shape
    dev = k.device
    cnt = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
    has = torch.zeros(B, dtype=torch.bool, device=dev)
    last = torch.zeros(B, dtype=torch.int32, device=dev)
    fields, incl = [], []
    for lo in range(0, cap, tile):
        kt, mt = k[:, lo:lo + tile], m[:, lo:lo + tile]
        n = kt.shape[1]
        # row i-1 (none before the cloud's first row)
        pm = torch.cat([m[:, lo - 1:lo] if lo else m.new_zeros((B, 1)),
                        mt[:, :-1]], 1)
        pk = torch.cat([k[:, lo - 1:lo] if lo else k.new_zeros((B, 1)),
                        kt[:, :-1]], 1)
        # the last valid row before each row: in the tile, else the carry
        pos = torch.where(mt, torch.arange(n, device=dev), -1)
        before = torch.cat([pos.new_full((B, 1), -1), pos[:, :-1]],
                           1).cummax(1).values
        has_v = (before >= 0) | has[:, None]
        lvk = torch.where(before >= 0, kt.gather(1, before.clamp(min=0)),
                          last[:, None])
        start = mt & ~(pm & ((kt >> 3) == (pk >> 3)))
        f = [mt, start]
        for l in range(1, L):
            s = 3 * (l + 1)
            start = start & ~(has_v & ((kt >> s) == (lvk >> s)))
            f.append(start)
        f = torch.stack(f, -1)
        c = cnt[:, None] + torch.cumsum(f.to(torch.int32), 1,
                                        dtype=torch.int32)
        fields.append(f)
        incl.append(c)
        cnt = c[:, -1]
        tail = pos.max(1).values
        last = torch.where(tail >= 0,
                           kt.gather(1, tail.clamp(min=0)[:, None])[:, 0],
                           last)
        has = has | (tail >= 0)
    return torch.cat(fields, 1), torch.cat(incl, 1)


def _kept_below(x: torch.Tensor, brick_caps) -> torch.Tensor:
    """[..., L] bool: every level below l keeps the ranks counted in x
    [..., L + 1] (x[..., 1 + k] <= brick_caps[k] for all k < l)."""
    over = (x[..., 1:] > torch.tensor(brick_caps, dtype=x.dtype,
                                      device=x.device)).to(torch.int32)
    cut = torch.cumsum(over, -1) - over           # cuts strictly below l
    return cut == 0


def _occ_walk_plain(keys_in, mask_in, bkeys, bmask, first, B, cap):
    """[NBtot * 8] occupancy as K11's lookups write it: each valid brick
    walks its voxels, a run of the level's voxel rows from its first one
    while the rows are valid and in the brick, and sets their cells."""
    NBtot = bkeys.shape[0]
    dev = bkeys.device
    end = (torch.arange(NBtot, device=dev) // (NBtot // B) + 1) * cap
    v = torch.where(bmask, first, 0).long()
    live = bmask.clone()
    occ = torch.zeros((NBtot, 8), dtype=torch.bool, device=dev)
    rows = torch.arange(NBtot, device=dev)
    while bool(live.any()):
        vc = v.clamp(max=keys_in.shape[0] - 1)
        live = live & (v < end) & mask_in[vc] & ((keys_in[vc] >> 3) == bkeys)
        occ[rows[live], (keys_in[vc] & 7)[live].long()] = True
        v = v + 1
    return occ.reshape(-1)


def _unpoisoned(t: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    if bool((t == _POISON).any()):
        raise AssertionError("an output row that no one writes")
    return t.to(dtype)


def _skeletons_onepass_plain(keys0, mask0, B, brick_caps, tile):
    """(every level's _Skeleton, the valid level-0 voxels [B] int32) as
    K11's first launch writes them: a brick and
    the level-(l+1) voxel it makes by the row where it starts, the level-0
    voxels by their rows, the rows from n_l to the capacity as the fill,
    with n_l and the valid level-0 count from the first row past a lower
    level's cut, else from the cloud's totals (every output starts
    poisoned, and each must be written)."""
    L = len(brick_caps)
    k = keys0.reshape(B, -1)
    m = mask0.reshape(B, -1)
    dev = k.device
    cap = k.shape[1]
    fields, incl = _onepass_counts_plain(k, m, L, tile)
    ex = incl - fields.to(torch.int32)
    kept, kept_ex = _kept_below(incl, brick_caps), _kept_below(ex, brick_caps)
    b = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    i = torch.arange(cap, dtype=torch.int32, device=dev)[None]
    caps = (cap,) + tuple(brick_caps[:-1])

    def poisoned(n):
        return torch.full((n,), _POISON, dtype=torch.int32, device=dev)

    bkeys = [poisoned(B * bc) for bc in brick_caps]
    bmask = [poisoned(B * bc) for bc in brick_caps]
    first = [poisoned(B * bc) for bc in brick_caps]
    cellslot = [poisoned(B * c) for c in caps]
    valid = [poisoned(B * c) for c in caps]
    ok0 = m & (incl[..., 1] <= brick_caps[0])
    cellslot[0][:] = torch.where(
        ok0, (b * brick_caps[0] + incl[..., 1] - 1) * 8 + (k & 7),
        B * brick_caps[0] * 8).reshape(-1)
    valid[0][:] = ok0.reshape(-1)
    for l, bc in enumerate(brick_caps):
        take = fields[..., 1 + l] & kept[..., l] & (incl[..., 1 + l] <= bc)
        r = (b * bc + incl[..., 1 + l] - 1)[take].long()
        bk = (k >> 3 * (l + 1))[take]
        bkeys[l][r] = bk
        bmask[l][r] = 1
        first[l][r] = (b * cap + i if l == 0 else
                       b * brick_caps[l - 1] + incl[..., l] - 1)[take]
        if l + 1 < L:                  # level l+1's voxel r
            nbc = brick_caps[l + 1]
            rank = incl[..., 2 + l][take]
            okn = rank <= nbc
            cellslot[l + 1][r] = torch.where(
                okn, (b.expand(B, cap)[take] * nbc + rank - 1) * 8 + (bk & 7),
                B * nbc * 8)
            valid[l + 1][r] = okn.to(torch.int32)
    # n_l: at the first row past a lower level's cut, else the totals
    tot = incl[:, -1]
    n = []
    for l, bc in enumerate(brick_caps):
        cut = fields[..., 1] & kept_ex[..., l] & ~kept[..., l]
        at = torch.where(cut.any(1), ex[..., 1 + l].masked_fill(~cut, 0)
                         .sum(1), tot[:, 1 + l])
        n.append(torch.clamp(at, max=bc))
    cut0 = fields[..., 1] & (ex[..., 1] <= brick_caps[0]) \
        & (incl[..., 1] > brick_caps[0])
    counts = torch.where(cut0.any(1), ex[..., 0].masked_fill(~cut0, 0)
                         .sum(1), tot[:, 0])
    for l, bc in enumerate(brick_caps):
        fill = (torch.arange(bc, device=dev)[None] >= n[l][:, None]
                ).reshape(-1)
        bkeys[l][fill] = morton.INVALID_KEY
        bmask[l][fill] = 0
        if l + 1 < L:
            cellslot[l + 1][fill] = B * brick_caps[l + 1] * 8
            valid[l + 1][fill] = 0
    skels = []
    for l, bc in enumerate(brick_caps):
        keys_in = keys0 if l == 0 else skels[-1].bkeys
        mask_in = mask0 if l == 0 else skels[-1].bmask
        bk, bm = _unpoisoned(bkeys[l]), _unpoisoned(bmask[l], torch.bool)
        fst = torch.where(bm, first[l], 0)
        skels.append(_Skeleton(
            bk, bm,
            torch.arange(B * bc, dtype=torch.int32, device=dev) // bc,
            _occ_walk_plain(keys_in, mask_in, bk, bm, fst, B, caps[l]),
            _unpoisoned(cellslot[l]), _unpoisoned(valid[l], torch.bool)))
    return tuple(skels), counts.to(torch.int32)


def _morton3(x, y, z):
    """Morton key of SHIFTED in-window coords (morton.encode's packing)."""
    return ((morton._spread3(x) << 2) | (morton._spread3(y) << 1)
            | morton._spread3(z))


def _neighbors_search_plain(sk: _Skeleton, pb_local: Optional[torch.Tensor],
                            B: int, level: int, brick_cap: int,
                            cap_next: Optional[int], bits):
    """`_neighbors` as K11's second launch computes it: the brick at offset
    o of a valid brick is the last of its Morton key among the cloud's
    brick keys (sorted, INVALID_KEY last; equal keys where a masked row
    splits a brick, of which the grid's scatter keeps the last): the upper
    bound minus one, found where the key matches. An out-of-window offset
    finds nothing, under `_neighbors`' per-level grid_dims range tests."""
    bkeys, bmask = sk.bkeys, sk.bmask
    dev = bkeys.device
    NBtot = bkeys.shape[0]
    GX, GY, GZ = morton.grid_dims(level + 1, bits)
    bx, by, bz = morton.axes_of(bkeys)
    seg = torch.arange(NBtot, dtype=torch.int32, device=dev) // brick_cap
    row = torch.arange(NBtot, dtype=torch.int32, device=dev)
    seg_keys = bkeys.reshape(B, brick_cap)

    def lookup(o):
        """(found [NBtot] bool, brick row [NBtot]) at offset o."""
        if o == (0, 0, 0):
            return bmask, row
        nx, ny, nz = bx + o[0], by + o[1], bz + o[2]
        ok = (bmask & (nx >= 0) & (nx < GX) & (ny >= 0) & (ny < GY)
              & (nz >= 0) & (nz < GZ))
        key = _morton3(nx, ny, nz).reshape(B, brick_cap)
        pos = torch.searchsorted(seg_keys, key, right=True).reshape(-1).to(
            torch.int32) - 1
        hit = seg_keys.reshape(-1)[
            (seg * brick_cap + torch.clamp(pos, min=0)).long()]
        return (ok & (pos >= 0) & (hit == key.reshape(-1)),
                seg * brick_cap + pos)

    found = {o: lookup(o) for o in LOOKUP + [(0, 0, 0)]}
    nbr6 = torch.stack([torch.where(found[o][0], found[o][1],
                                    torch.full_like(row, NBtot))
                        for o in FACE_OFFS])
    if pb_local is None:
        return nbr6, None
    sent_next = B * cap_next * 8

    def up_slot(o):
        ok, r = found[o]
        pb = torch.clamp(pb_local[torch.where(ok, r, 0).long()],
                         max=_PB_MASK)
        ok = ok & (pb < cap_next)       # parent overflow -> no slot
        cell = ((((bx + o[0]) & 1) << 2) | (((by + o[1]) & 1) << 1)
                | ((bz + o[2]) & 1))
        slot = (seg * cap_next + pb) * 8 + cell
        return torch.where(ok, slot, torch.full_like(slot, sent_next))

    return nbr6, torch.stack([up_slot(o) for o in OCT_OFFS], dim=1)


def build_pyramid_onepass_plain(keys0: torch.Tensor, mask0: torch.Tensor,
                                B: int, brick_caps: Tuple[int, ...],
                                bits: Tuple[int, int, int] = morton.BITS,
                                tile: int = K11_TILE) -> BrickPyramid:
    """`build_pyramid_plain` by K11's reformulation: the skeleton of every
    level in one pass over the level-0 rows in tiles of `tile`, the lookups
    by search (no grid), the occupancy by each brick's walk."""
    _check_caps(brick_caps)
    L = len(brick_caps)
    skels, counts = _skeletons_onepass_plain(keys0, mask0, B, brick_caps,
                                             tile)
    levels = []
    for l, sk in enumerate(skels):
        if l + 1 < L:
            nbr6, up_slots = _neighbors_search_plain(
                sk, _parent_local(skels[l + 1], brick_caps[l + 1]), B, l,
                brick_caps[l], brick_caps[l + 1], bits)
        else:
            nbr6, up_slots = _neighbors_search_plain(sk, None, B, l,
                                                     brick_caps[l], None, bits)
        levels.append(BrickLevel(
            bkeys=sk.bkeys, bmask=sk.bmask, bseg=sk.bseg, occ=sk.occ,
            nbr6=nbr6, cellslot=sk.cellslot, up_slots=up_slots))
    return BrickPyramid(levels=tuple(levels),
                        vox_masks=tuple(sk.valid_vox for sk in skels),
                        counts=counts)


# ---------------------------------------------------------------- kernel K11

# the C entry takes a table of kRecord int64 a level (csrc/brick_pyramid.cu):
# voxel and brick capacity of a cloud, the brick lattice's grid_dims, the
# input keys and mask, then the outputs
_K11_ARGS = (ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)


def build_pyramid(keys0: torch.Tensor, mask0: torch.Tensor, B: int,
                  brick_caps: Tuple[int, ...],
                  bits: Tuple[int, int, int] = morton.BITS) -> BrickPyramid:
    """All L levels from per-segment-sorted level-0 keys [M0] int32 and
    mask [M0] bool; `counts` holds each cloud's valid level-0 voxels.

    A CPU tensor takes the plain version; a CUDA tensor launches K11 (two
    launches: every level's skeleton in one pass, a block a tile of
    K11_TILE level-0 rows, then the lookups) or raises."""
    if keys0.is_cpu:
        return build_pyramid_plain(keys0, mask0, B, brick_caps, bits)
    return _launch_k11(keys0, mask0, B, brick_caps, bits)


# K11's look-back words and ticket, kept per device and zeroed once: each
# call tags its words with a new epoch (csrc/brick_pyramid.cu), so a call
# leaves nothing to clear. Calls on one stream may share them.
_k11_words: dict = {}


def _k11_state(device, n: int):
    """(the device's state words, a ticket and at least n look-back words,
    and this call's epoch)."""
    words, epoch = _k11_words.get(device, (None, 0))
    if words is None or words.numel() < n + 1 or epoch >= 2 ** 32 - 1:
        words = torch.zeros(max(n + 1, 1 << 12), dtype=torch.int64,
                            device=device)
        epoch = 0
    _k11_words[device] = (words, epoch + 1)
    return words, epoch + 1


def _launch_k11(keys0, mask0, B, brick_caps, bits) -> BrickPyramid:
    fn = kernels.load("brick_pyramid", _K11_ARGS)
    dev = kernels.require_cuda("brick_pyramid", keys0, mask0,
                               dtypes=(torch.int32, torch.bool))
    _check_caps(brick_caps)
    M0 = keys0.shape[0]
    if mask0.shape != (M0,) or M0 % B:
        raise ValueError(f"build_pyramid: keys {tuple(keys0.shape)} and "
                         f"mask {tuple(mask0.shape)} for {B} clouds")
    L = len(brick_caps)
    if L > K11_MAX_LEVELS:
        raise ValueError(f"build_pyramid: {L} levels, the kernel builds at "
                         f"most {K11_MAX_LEVELS}")
    caps = (M0 // B,) + tuple(brick_caps[:-1])       # voxel caps per level
    nb = [B * bc for bc in brick_caps]
    m = [B * c for c in caps]
    # every output in one int32 and one bool allocation (fewer host calls);
    # the occupancy first, so that each brick's 8 bytes are one aligned word
    isz = (nb + nb + m + [6 * n for n in nb] + [8 * n for n in nb[:-1]]
           + nb + [B])
    ints = torch.empty(sum(isz), dtype=torch.int32,
                       device=keys0.device).split(isz)
    bsz = [8 * n for n in nb] + nb + m
    bools = torch.empty(sum(bsz), dtype=torch.bool,
                        device=keys0.device).split(bsz)
    bkeys, bseg, cellslot = ints[:L], ints[L:2 * L], ints[2 * L:3 * L]
    nbr6 = [t.view(6, n) for t, n in zip(ints[3 * L:4 * L], nb)]
    ups = [t.view(n, 8) for t, n in zip(ints[4 * L:5 * L - 1], nb)] + [None]
    first = ints[5 * L - 1:6 * L - 1]
    counts = ints[-1]
    occ, bmask, valid = bools[:L], bools[L:2 * L], bools[2 * L:]
    p = kernels.ptr
    table = []
    for l in range(L):
        table += [caps[l], brick_caps[l], *morton.grid_dims(l + 1, bits),
                  p(keys0) if l == 0 else p(bkeys[l - 1]),
                  p(mask0) if l == 0 else p(bmask[l - 1]),
                  p(bkeys[l]), p(bmask[l]), p(bseg[l]), p(occ[l]),
                  p(cellslot[l]), p(valid[l]), p(nbr6[l]), p(ups[l]) or 0,
                  p(first[l])]
    tiles = B * -(-caps[0] // K11_TILE)
    state, epoch = _k11_state(keys0.device, tiles * (L + 1))
    err = fn((ctypes.c_longlong * len(table))(*table), B, L, K11_TILE, epoch,
             p(state), p(counts), kernels.stream_handle(dev))
    kernels.check_launch("brick_pyramid", err)
    levels = tuple(BrickLevel(bkeys[l], bmask[l], bseg[l], occ[l], nbr6[l],
                              cellslot[l], ups[l]) for l in range(L))
    return BrickPyramid(levels, tuple(valid), counts)
