"""Sparse convolutions as gathered products over explicit maps
(counterpart of eyoc_tpu/sparse/brick_conv.py).

Layout: features are voxel-major, `[M_l, C]` at level l, one row per voxel
row of the pyramid (level-(l+1) voxel rows are level-l brick rows). The
JAX package keeps a brick-major `[NBtot, 8C]` layout that exists only for
the TPU's (8, 128) tiles; a row gather feeds a GEMM better. A feature row
of an invalid voxel is zero after every masked conv.

Every conv kind is one call of kernel K1 (`sparse_conv`):

    out[o] = epilogue(sum_t in[map[o, t]] @ W[t])

through a **gather map** `[M_out, T]` int32 whose sentinel `M_in` reads a
zero row. `conv_maps` turns a BrickPyramid into those maps: on the card
kernel K12 (`csrc/conv_maps.cu`) builds every map of a forward, and the
inverses of a train forward, in two launches (the JAX package gathers a
halo instead, `halo_parts`, brick_conv.py:95); `conv_maps_plain` is the
plain version and `conv_maps_staged_plain` K12's reformulation.

Conv semantics follow `eyoc_tpu`, NOT MinkowskiEngine's full 27-tap
convolution (decision recorded here and in ROADMAP.md):
- Tap order is x-major with z fastest (`_off_index`, brick_conv.py:148).
  Forward and strided convs read in[o + off] * W[off]; the transposed conv
  reads in[(o - off) / 2] * W[off] through `up_slots`.
- A source voxel in a diagonal brick is reached transitively, as the JAX
  halo is built (x, then y, then z extension): from the output's brick the
  map follows the z face neighbour, then that brick's y neighbour, then its
  x neighbour (`nbr6`). If an intermediate brick is absent the tap reads
  zero: the **dropped diagonal taps** of brick_conv.py:20-24, which occur
  only across fully empty 0.6 m brick gaps.
- conv_down computes one output per level-l brick (= level-(l+1) voxel)
  from taps at cells [-1, 1]^3 of the brick base; conv_up reads the coarse
  2x2x2 window through `up_slots`; conv1x1 is the identity map.

Training (`SparseConvFunction`): for a fixed tap t every input row is read
by at most one output row (same: coord(i) = coord(o) + off_t; down:
coord(i) = 2 coord(o) + off_t; up: coord(o) = 2 coord(i) + off_t; a
dropped diagonal tap only removes entries), so the map inverts per tap
(`invert_map`) and the input gradient is K1 itself over the inverse map
with W[t] transposed: dX[i] = sum_t dY[inv[i, t]] @ W[t]^T, deterministic
and without atomics. The weight gradient is kernel K5
(`sparse_conv_wgrad`).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from eyoc_tpu_torch.sparse.bricks import BrickLevel, BrickPyramid
from eyoc_tpu_torch.utils import kernels

CELLS = [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)]


def _off_index(d, k: int) -> int:
    """Kernel tap index of offset d: x-major, z-fastest."""
    r = k // 2
    return ((d[0] + r) * k + (d[1] + r)) * k + (d[2] + r)


def _offsets(k: int):
    r = k // 2
    return [(x, y, z) for x in range(-r, r + 1) for y in range(-r, r + 1)
            for z in range(-r, r + 1)]


# ------------------------------------------------------------- gather maps


class ConvMaps(NamedTuple):
    """Gather maps of one pyramid (all int32, sentinel = input row count).

    same3[l]: [M_l, 27]; first: [M_0, k^3] of the first conv (k =
    conv1_kernel_size, 125 taps for ResUNetBN2C);
    down[l]: level l -> l+1, [M_{l+1}, 27]; up[l]: level l+1 -> l,
    [M_l, 27]; vox_masks[l]: [M_l] bool output masks.
    inv_same3 / inv_down / inv_up: the per-tap inverses (`invert_map`) that
    the backward's dX needs, or None when not asked for. The first conv's
    input (the occupancy or jittered features) takes no gradient, so its
    map has no inverse here."""

    same3: Tuple[torch.Tensor, ...]
    first: torch.Tensor
    down: Tuple[torch.Tensor, ...]
    up: Tuple[torch.Tensor, ...]
    vox_masks: Tuple[torch.Tensor, ...]
    inv_same3: Optional[Tuple[torch.Tensor, ...]] = None
    inv_down: Optional[Tuple[torch.Tensor, ...]] = None
    inv_up: Optional[Tuple[torch.Tensor, ...]] = None


def cell_to_voxel(level: BrickLevel) -> torch.Tensor:
    """[NBtot*8 + 1] int32: cell row -> voxel row, M_l for empty cells and
    for the cell sentinel NBtot*8."""
    M = level.cellslot.shape[0]
    nb8 = level.occ.shape[0]
    idx = torch.where(level.cellslot < nb8, level.cellslot,
                      torch.full_like(level.cellslot, nb8 + 1))
    out = torch.full((nb8 + 2,), M, dtype=torch.int32,
                     device=level.cellslot.device)
    out[idx.long()] = torch.arange(M, dtype=torch.int32,
                                   device=out.device)
    return out[:nb8 + 1]


def _tap_sources(level: BrickLevel, brick: torch.Tensor, u: torch.Tensor,
                 offs, c2v: torch.Tensor) -> torch.Tensor:
    """Voxel rows [R, T] read by taps `offs` of outputs at cell u [R, 3] of
    brick rows `brick` [R] (sentinel NBtot)."""
    dev = brick.device
    NBtot = level.bkeys.shape[0]
    nbr = torch.cat([level.nbr6, level.nbr6.new_full((6, 1), NBtot)],
                    1).long()
    off = torch.tensor(offs, dtype=torch.int32, device=dev)      # [T, 3]
    p = u[:, None, :] + off[None]                                # [R, T, 3]
    bd = p >> 1                                                  # {-1, 0, 1}
    cell = ((p[..., 0] & 1) << 2) | ((p[..., 1] & 1) << 1) | (p[..., 2] & 1)
    b = brick.long()[:, None].expand(p.shape[:2])
    for axis in (2, 1, 0):      # z hop first, then y, then x (see docstring)
        d = bd[..., axis]
        b = torch.where(d < 0, nbr[2 * axis][b],
                        torch.where(d > 0, nbr[2 * axis + 1][b], b))
    src_cell = torch.where(b < NBtot, b * 8 + cell, NBtot * 8)
    return c2v[src_cell]


def _cell_coords(cellslot: torch.Tensor):
    """(brick row [R], cell coords [R, 3]) of voxel cell slots."""
    u = torch.stack([(cellslot >> 2) & 1, (cellslot >> 1) & 1,
                     cellslot & 1], -1)
    return cellslot >> 3, u


def check_conv_side(k: int, who: str):
    """Raise for a stride-1 conv side other than 3 and 5: a tap hops at
    most one brick from its output cell, so a side-7 tap two bricks away
    would name another voxel."""
    if k not in (3, 5):
        raise ValueError(f"{who}: a first conv of side {k}; the maps read "
                         "one brick around each output, sides 3 and 5")


def conv_same_map(level: BrickLevel, k: int = 3,
                  c2v: torch.Tensor | None = None) -> torch.Tensor:
    """[M_l, k^3] stride-1 map at one level (k = 3 or 5)."""
    check_conv_side(k, "conv_same_map")
    c2v = cell_to_voxel(level) if c2v is None else c2v
    brick, u = _cell_coords(level.cellslot)
    return _tap_sources(level, brick, u, _offsets(k), c2v).to(
        torch.int32).contiguous()


def conv_down_map(level: BrickLevel,
                  c2v: torch.Tensor | None = None) -> torch.Tensor:
    """[NBtot_l, 27] stride-2 map: output row r = level-l brick r = level-
    (l+1) voxel r, taps at cells [-1, 1]^3 of the brick base."""
    c2v = cell_to_voxel(level) if c2v is None else c2v
    NBtot = level.bkeys.shape[0]
    brick = torch.arange(NBtot, dtype=torch.int32, device=c2v.device)
    u = torch.zeros((NBtot, 3), dtype=torch.int32, device=c2v.device)
    return _tap_sources(level, brick, u, _offsets(3), c2v).to(
        torch.int32).contiguous()


def conv_up_map(fine: BrickLevel, coarse_c2v: torch.Tensor,
                m_coarse: int) -> torch.Tensor:
    """[M_l, 27] transposed stride-2 map from level l+1 into level l.

    Fine cell u of brick B reads coarse voxel B + c (c in {0,1}^3, through
    up_slots) with tap off = u - 2c when off lies in [-1, 1]^3; the other
    taps of the row hold the sentinel `m_coarse` (coarse voxel rows)."""
    NBtot = fine.bkeys.shape[0]
    sent = coarse_c2v.shape[0] - 1
    up = torch.cat([fine.up_slots, fine.up_slots.new_full((1, 8), sent)],
                   0).long()
    brick, u = _cell_coords(fine.cellslot)
    brick = torch.clamp(brick, max=NBtot).long()
    R = u.shape[0]
    out = torch.full((R, 28), m_coarse, dtype=torch.int32, device=u.device)
    rows = torch.arange(R, device=u.device)
    for ci, cc in enumerate(CELLS):
        d = u - 2 * torch.tensor(cc, dtype=torch.int32, device=u.device)
        ok = torch.all((d >= -1) & (d <= 1), -1)
        t = ((d[:, 0] + 1) * 3 + (d[:, 1] + 1)) * 3 + (d[:, 2] + 1)
        t = torch.where(ok, t, torch.full_like(t, 27))
        out[rows, t.long()] = coarse_c2v[up[brick, ci]]
    return out[:, :27].contiguous()


def conv_maps_plain(pyr: BrickPyramid, num_levels: int,
                    conv1_kernel_size: int = 5,
                    inverse: bool = False) -> ConvMaps:
    """Every gather map a UNet of `num_levels` levels needs; with
    `inverse`, also the inverses of the maps whose input takes a gradient."""
    levels = pyr.levels[:num_levels]
    c2v = [cell_to_voxel(lv) for lv in levels]
    same3 = tuple(conv_same_map(lv, 3, c) for lv, c in zip(levels, c2v))
    first = (conv_same_map(levels[0], conv1_kernel_size, c2v[0])
             if conv1_kernel_size != 3 else same3[0])
    down = tuple(conv_down_map(levels[l], c2v[l])
                 for l in range(num_levels - 1))
    up = tuple(conv_up_map(levels[l], c2v[l + 1],
                           levels[l + 1].cellslot.shape[0])
               for l in range(num_levels - 1))
    maps = ConvMaps(same3, first, down, up,
                    tuple(pyr.vox_masks[:num_levels]))
    if not inverse:
        return maps
    M = [lv.cellslot.shape[0] for lv in levels]
    return maps._replace(
        inv_same3=tuple(invert_map(m, n) for m, n in zip(same3, M)),
        inv_down=tuple(invert_map(m, M[l]) for l, m in enumerate(down)),
        inv_up=tuple(invert_map(m, M[l + 1]) for l, m in enumerate(up)))


def identity_map(m: int, device) -> torch.Tensor:
    """[m, 1] map of a per-voxel (1x1) conv."""
    return torch.arange(m, dtype=torch.int32, device=device)[:, None]


def invert_map(nmap: torch.Tensor, m_in: int) -> torch.Tensor:
    """Per-tap inverse of a gather map: nmap [M_out, T] (values outside
    [0, m_in) read nothing) -> inv [m_in, T] int32 with inv[nmap[o, t], t]
    = o and the sentinel M_out where no output reads (i, t).

    Raises when two outputs read the same input through the same tap: the
    dX of `SparseConvFunction` would then need a sum, not a gather."""
    M_out, T = nmap.shape
    valid = (nmap >= 0) & (nmap < m_in)
    slot = torch.where(valid, nmap.long() * T
                       + torch.arange(T, device=nmap.device), m_in * T)
    inv = torch.full((m_in * T + 1,), M_out, dtype=torch.int32,
                     device=nmap.device)
    rows = torch.arange(M_out, dtype=torch.int32, device=nmap.device)
    inv[slot.reshape(-1)] = rows[:, None].expand(M_out, T).reshape(-1)
    inv = inv[:m_in * T].reshape(m_in, T)
    _raise_collisions(int(valid.sum() - (inv < M_out).sum()))  # a host sync
    return inv


def _raise_collisions(n: int) -> None:
    if n:
        raise ValueError(f"invert_map: {n} (input, tap) slots are read by "
                         "more than one output row")


# K12's reformulation in plain torch, for the CPU tests: the neighbourhood
# of each brick resolved once and staged (the voxel rows of the cells of
# the 27 bricks around it), each map entry read from its brick's stage;
# the inverses with a count of collisions (a slot read by k outputs counts
# k - 1).


def cell_to_voxel_occ_plain(level: BrickLevel) -> torch.Tensor:
    """`cell_to_voxel` as K12 builds it in one pass without a fill before
    the scatter: an empty cell (occ false) and the sentinel take M_l, and
    each valid voxel writes its row at its cell; the two sets of writes
    are disjoint."""
    M = level.cellslot.shape[0]
    nb8 = level.occ.shape[0]
    dev = level.cellslot.device
    out = torch.empty(nb8 + 1, dtype=torch.int32, device=dev)
    empty = torch.cat([~level.occ, level.occ.new_ones(1)])
    out[empty] = M
    ok = level.cellslot < nb8
    out[level.cellslot[ok].long()] = torch.arange(
        M, dtype=torch.int32, device=dev)[ok]
    return out


_NEAR = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
         for dz in (-1, 0, 1)]          # stage order: x-major, z fastest


def brick_neighbourhood_plain(level: BrickLevel,
                              c2v: torch.Tensor) -> torch.Tensor:
    """[NBtot + 1, 27, 8] the voxel rows of the 8 cells of the 27 bricks
    at offsets in [-1, 1]^3 of each brick (row NBtot: the sentinel brick),
    each reached as `_tap_sources` reaches it: the z hop, then y, then x
    (a brick past an absent one is absent, its cells M_l)."""
    dev = c2v.device
    NBtot = level.bkeys.shape[0]
    nbr = torch.cat([level.nbr6, level.nbr6.new_full((6, 1), NBtot)],
                    1).long()
    d = torch.tensor(_NEAR, dtype=torch.int64, device=dev)
    b = torch.arange(NBtot + 1, device=dev)[:, None].expand(NBtot + 1, 27)
    for axis in (2, 1, 0):
        da = d[:, axis]
        b = torch.where(da < 0, nbr[2 * axis][b],
                        torch.where(da > 0, nbr[2 * axis + 1][b], b))
    cells = torch.where(b[..., None] < NBtot,
                        b[..., None] * 8 + torch.arange(8, device=dev),
                        NBtot * 8)
    return c2v[cells]


def _staged_taps(stage: torch.Tensor, brick: torch.Tensor, u: torch.Tensor,
                 offs) -> torch.Tensor:
    """[R, T] entries of outputs at cell u [R, 3] of bricks `brick` [R]
    (sentinel NBtot): tap off reads cell u + off, which lies in the brick at
    offset (u + off) >> 1 of its own."""
    off = torch.tensor(offs, dtype=torch.int32, device=u.device)
    p = u[:, None, :] + off[None]                                # [R, T, 3]
    d = (p >> 1) + 1
    n = (d[..., 0] * 9 + d[..., 1] * 3 + d[..., 2]).long()
    cell = (((p[..., 0] & 1) << 2) | ((p[..., 1] & 1) << 1)
            | (p[..., 2] & 1)).long()
    return stage[brick.long()[:, None], n, cell]


def conv_up_map_staged_plain(fine: BrickLevel, coarse_c2v: torch.Tensor,
                             m_coarse: int) -> torch.Tensor:
    """`conv_up_map` from each fine brick's stage of 8 coarse voxels (those
    of its up_slots): tap off of fine cell u reads stage[c] with c = (u -
    off) / 2 where u - off is 0 or 2 on every axis, else m_coarse."""
    NBtot = fine.bkeys.shape[0]
    sent = coarse_c2v.shape[0] - 1
    stage = coarse_c2v[torch.cat([fine.up_slots,
                                  fine.up_slots.new_full((1, 8), sent)],
                                 0).long()]                      # [NBtot+1, 8]
    brick, u = _cell_coords(fine.cellslot)
    brick = torch.clamp(brick, max=NBtot).long()
    off = torch.tensor(_offsets(3), dtype=torch.int32, device=u.device)
    e = u[:, None, :] - off[None]                              # [R, 27, 3]
    ok = ((e == 0) | (e == 2)).all(-1)
    c = e >> 1
    ci = torch.where(ok, c[..., 0] * 4 + c[..., 1] * 2 + c[..., 2], 0)
    src = stage[brick[:, None], ci.long()]
    return torch.where(ok, src, torch.full_like(src, m_coarse)).contiguous()


def invert_map_counted_plain(nmap: torch.Tensor, m_in: int):
    """(inv, collisions): `invert_map` without the raise, and the count of
    extra outputs that read an (input, tap) slot already read."""
    M_out, T = nmap.shape
    valid = (nmap >= 0) & (nmap < m_in)
    slot = nmap.long() * T + torch.arange(T, device=nmap.device)
    hits = torch.bincount(slot[valid], minlength=m_in * T)
    collisions = int((hits - 1).clamp(min=0).sum())
    inv = torch.full((m_in * T,), M_out, dtype=torch.int32,
                     device=nmap.device)
    rows = torch.arange(M_out, dtype=torch.int32, device=nmap.device)
    inv[slot[valid]] = rows[:, None].expand(M_out, T)[valid]
    return inv.reshape(m_in, T), collisions


def conv_maps_staged_plain(pyr: BrickPyramid, num_levels: int,
                           conv1_kernel_size: int = 5,
                           inverse: bool = False) -> ConvMaps:
    """`conv_maps_plain` by K12's reformulation; raises as it does when an
    inverse has a collision."""
    check_conv_side(conv1_kernel_size, "conv_maps_staged_plain")
    levels = pyr.levels[:num_levels]
    c2v = [cell_to_voxel_occ_plain(lv) for lv in levels]
    stages = [brick_neighbourhood_plain(lv, c) for lv, c in zip(levels, c2v)]

    def same(l, k):
        brick, u = _cell_coords(levels[l].cellslot)
        NBtot = levels[l].bkeys.shape[0]
        return _staged_taps(stages[l], torch.clamp(brick, max=NBtot), u,
                            _offsets(k)).contiguous()

    def down(l):
        NBtot = levels[l].bkeys.shape[0]
        brick = torch.arange(NBtot, dtype=torch.int32, device=c2v[l].device)
        return _staged_taps(stages[l], brick, torch.zeros_like(brick)[:, None]
                            .expand(NBtot, 3), _offsets(3)).contiguous()

    same3 = tuple(same(l, 3) for l in range(num_levels))
    first = (same(0, conv1_kernel_size) if conv1_kernel_size != 3
             else same3[0])
    up = tuple(conv_up_map_staged_plain(levels[l], c2v[l + 1],
                                        levels[l + 1].cellslot.shape[0])
               for l in range(num_levels - 1))
    downs = tuple(down(l) for l in range(num_levels - 1))
    maps = ConvMaps(same3, first, downs, up,
                    tuple(pyr.vox_masks[:num_levels]))
    if not inverse:
        return maps
    M = [lv.cellslot.shape[0] for lv in levels]
    inv = ([invert_map_counted_plain(m, n) for m, n in zip(same3, M)],
           [invert_map_counted_plain(m, M[l])
            for l, m in enumerate(maps.down)],
           [invert_map_counted_plain(m, M[l + 1]) for l, m in enumerate(up)])
    _raise_collisions(sum(n for part in inv for _, n in part))
    return maps._replace(
        inv_same3=tuple(i for i, _ in inv[0]),
        inv_down=tuple(i for i, _ in inv[1]),
        inv_up=tuple(i for i, _ in inv[2]))


# ---------------------------------------------------------------- kernel K12

# the C entry takes a table of kLevelRecord int64 a level and one of
# kMapRecord int64 a map (csrc/conv_maps.cu); the map kinds
_K12_SAME, _K12_DOWN, _K12_UP = 0, 1, 2
_K12_ARGS = (ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
             ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_K12_TABLE = 8 * (27 + 125 + 27)    # csrc/conv_maps.cu: kTabSize
K12_ROWS = 32          # output rows a maps block (csrc/conv_maps.cu: kMaxRows)


class CollisionCheck:
    """The collision count of one K12 call with inverses, read where the
    conv backward first needs one of its inverses (`raise_if_any`). On the
    card the count goes by an async copy into a word of a pinned ring, with
    an event recorded after it, so the call does not wait for it; by the
    backward the copy has normally landed. A CPU count (the kernel's source
    built for the host) is read as it is."""

    def __init__(self, count: torch.Tensor):
        self._n = None
        self._event = None
        self._word = count
        if count.is_cuda:
            self._word = _pinned_word(count.device, self)
            self._word.copy_(count, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def _read(self, wait: bool) -> bool:
        """Read the count into the check (waiting for the copy if `wait`);
        False if the copy has not landed and `wait` is not set. A copy that
        has landed is read without a wait (no host sync)."""
        if self._n is None:
            if self._event is not None and not self._event.query():
                if not wait:
                    return False
                self._event.synchronize()
            self._n = int(self._word[0])
            self._word = None
        return True

    def raise_if_any(self) -> None:
        """Raise as invert_map does when two outputs read one (input, tap)
        slot."""
        self._read(wait=True)
        _raise_collisions(self._n)


class _PinnedRing:
    """Pinned host int32 words of one device for the collision counts,
    taken in turn; a word is taken again once its last check has read it
    or its copy has landed (read for that check first)."""

    def __init__(self, n: int):
        self.words = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.owners = [None] * n
        self.next = 0

    def take(self, owner: CollisionCheck) -> Optional[torch.Tensor]:
        n = len(self.owners)
        for _ in range(n):
            s = self.next
            self.next = (s + 1) % n
            prev = self.owners[s] and self.owners[s]()
            if prev is not None and not prev._read(wait=False):
                continue
            self.owners[s] = weakref.ref(owner)
            return self.words[s:s + 1]
        return None


_rings: dict = {}


def _pinned_word(device, owner: CollisionCheck) -> torch.Tensor:
    ring = _rings.get(device)
    word = ring.take(owner) if ring is not None else None
    if word is None:         # every word awaits its copy: a larger ring
        ring = _rings[device] = _PinnedRing(
            64 if ring is None else 2 * len(ring.owners))
        word = ring.take(owner)
    return word


def conv_maps(pyr: BrickPyramid, num_levels: int, conv1_kernel_size: int = 5,
              inverse: bool = False) -> ConvMaps:
    """Every gather map a UNet of `num_levels` levels needs; with
    `inverse`, also the inverses of the maps whose input takes a gradient
    (raises when two outputs read one input through one tap).

    A CPU tensor takes the plain version; a CUDA tensor launches K12 (two
    launches: the cell-to-voxel tables and the inverses' fill, then every
    map entry and its inverse, a block a run of K12_ROWS output rows) or
    raises. With `inverse` the collision count is not waited for: each
    inverse carries a CollisionCheck (`collision_check`) that
    `SparseConvFunction.backward` raises on before it reads the inverse;
    the call makes no host sync. Both routes raise for a first conv of a
    side other than 3 and 5 (`check_conv_side`)."""
    check_conv_side(conv1_kernel_size, "conv_maps")
    if pyr.levels[0].cellslot.is_cpu:
        return conv_maps_plain(pyr, num_levels, conv1_kernel_size, inverse)
    return _launch_k12(pyr, num_levels, conv1_kernel_size, inverse)


def collision_check(inv: Optional[torch.Tensor]) -> Optional[CollisionCheck]:
    """The deferred collision check K12 attached to an inverse, if any."""
    return getattr(inv, "collision_check", None)


def _split_aligned(sizes, **kw):
    """Views of one int32 allocation, each starting at a multiple of 32
    bytes (K12's 16-byte stores, its 32-byte brick rows of c2v)."""
    pad = [-(-n // 8) * 8 for n in sizes]
    return [t[:n] for t, n in zip(torch.empty(sum(pad), **kw).split(pad),
                                  sizes)]


def _launch_k12(pyr, num_levels, conv1_kernel_size, inverse) -> ConvMaps:
    fn = kernels.load("conv_maps", _K12_ARGS)
    levels = pyr.levels[:num_levels]
    L = num_levels
    tensors, dtypes = [], []
    for l, lv in enumerate(levels):
        tensors += [lv.nbr6, lv.cellslot, lv.occ,
                    lv.up_slots if l + 1 < L else None]
        dtypes += [torch.int32, torch.int32, torch.bool, torch.int32]
    dev = kernels.require_cuda("conv_maps", *tensors, dtypes=dtypes)
    M = [lv.cellslot.shape[0] for lv in levels]
    NB = [lv.bkeys.shape[0] for lv in levels]
    i32 = dict(dtype=torch.int32, device=levels[0].cellslot.device)
    *c2v, table = _split_aligned([8 * n + 8 for n in NB] + [_K12_TABLE],
                                 **i32)
    # (kind, level, kernel side, rows, input rows) of each map, in
    # ConvMaps order: same3, first (k != 3), down, up
    specs = [(_K12_SAME, l, 3, M[l], M[l]) for l in range(L)]
    if conv1_kernel_size != 3:
        specs.append((_K12_SAME, 0, conv1_kernel_size, M[0], M[0]))
    specs += [(_K12_DOWN, l, 3, NB[l], M[l]) for l in range(L - 1)]
    specs += [(_K12_UP, l, 3, M[l], M[l + 1]) for l in range(L - 1)]
    maps = [t.view(rows, k ** 3) for t, (_, _, k, rows, _) in zip(
        _split_aligned([rows * k ** 3 for _, _, k, rows, _ in specs], **i32),
        specs)]
    # the maps whose input takes a gradient: all but `first`
    n_first = int(conv1_kernel_size != 3)
    grads = list(range(L)) + list(range(L + n_first, len(specs)))
    invs = {}
    if inverse:
        isz = [specs[i][4] * 27 for i in grads]
        invs = {i: t.view(specs[i][4], 27) for i, t in zip(
            grads, _split_aligned(isz, **i32))}
    coll = torch.empty(1, **i32)
    p = kernels.ptr
    lrec = []
    for l, lv in enumerate(levels):
        lrec += [NB[l], M[l], p(lv.nbr6), p(lv.cellslot), p(lv.occ),
                 p(lv.up_slots) if l + 1 < L else 0, p(c2v[l])]
    mrec = []
    for i, (kind, l, k, rows, m_in) in enumerate(specs):
        mrec += [kind, l, k, rows, m_in, p(maps[i]), p(invs.get(i)) or 0]
    err = fn((ctypes.c_longlong * len(lrec))(*lrec), L,
             (ctypes.c_longlong * len(mrec))(*mrec), len(specs), K12_ROWS,
             p(table), p(coll), kernels.stream_handle(dev))
    kernels.check_launch("conv_maps", err)
    same3 = tuple(maps[:L])
    first = maps[L] if n_first else same3[0]
    rest = maps[L + n_first:]
    out = ConvMaps(same3, first, tuple(rest[:L - 1]), tuple(rest[L - 1:]),
                   tuple(pyr.vox_masks[:L]))
    if not inverse:
        return out
    check = CollisionCheck(coll)
    inv = [invs[i] for i in grads]
    for t in inv:
        t.collision_check = check
    return out._replace(inv_same3=tuple(inv[:L]),
                        inv_down=tuple(inv[L:2 * L - 1]),
                        inv_up=tuple(inv[2 * L - 1:]))


# ---------------------------------------------------------------- kernel K1


def _padded_rows(x, nmap):
    """(xp [M_in + 1, Ci] f32 with a zero last row, idx [M_out, T] int64):
    xp[idx[o, t]] is the row that tap t of output o reads."""
    M_in, Ci = x.shape
    xp = torch.cat([x.float(), x.new_zeros((1, Ci), dtype=torch.float32)], 0)
    idx = torch.where((nmap >= 0) & (nmap < M_in), nmap,
                      torch.full_like(nmap, M_in)).long()
    return xp, idx


def _epilogue(acc, dtype, bias, mask, residual, relu):
    """K1's epilogue on the f32 sum: + bias, * mask, + residual, ReLU, one
    rounding to `dtype`."""
    if bias is not None:
        acc = acc + bias.float()
    if mask is not None:
        acc = acc * mask[:, None].float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(dtype)


def sparse_conv_plain(x, W, nmap, *, x2=None, bias=None, mask=None,
                      residual=None, relu=False):
    """Plain PyTorch version of K1: the same sum in f32, the same epilogue,
    one rounding to x's dtype at the end."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    T, _, Co = W.shape
    xp, idx = _padded_rows(x, nmap)
    Wf = W.float()
    acc = torch.zeros((nmap.shape[0], Co), dtype=torch.float32,
                      device=x.device)
    for t in range(T):
        acc += xp[idx[:, t]] @ Wf[t]
    return _epilogue(acc, x.dtype, bias, mask, residual, relu)


# The kernel's reformulations, as plain torch. The CPU tests hold each
# against `sparse_conv_plain` and the JAX convs; the main path never calls
# them (on the card the kernel computes them).


def sparse_conv_tap_packed_plain(x, W, nmap, *, x2=None, bias=None,
                                 mask=None, residual=None, relu=False):
    """K1's narrow-input route: each output row's T taps of Ci channels are
    one K = T*Ci row, zero-padded to a multiple of K1_BK, times W viewed as
    [T*Ci, Co] (W's own memory; the padding rows read zero): one product
    instead of T."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    T, Ci, Co = W.shape
    M_out = nmap.shape[0]
    K = T * Ci
    Kp = -(-K // K1_BK) * K1_BK
    xp, idx = _padded_rows(x, nmap)
    a = x.new_zeros((M_out, Kp), dtype=torch.float32)
    a[:, :K] = xp[idx].reshape(M_out, K)
    wp = W.new_zeros((Kp, Co), dtype=torch.float32)
    wp[:K] = W.float().reshape(K, Co)
    return _epilogue(a @ wp, x.dtype, bias, mask, residual, relu)


def sparse_conv_split_plain(x, W, nmap, splits, *, x2=None, bias=None,
                            mask=None, residual=None, relu=False):
    """K1's tap split: split s sums taps [s*T//S, (s+1)*T//S) into its own
    f32 partial; the partials are added in split order, and the epilogue
    runs once, on the sum."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    T, _, Co = W.shape
    xp, idx = _padded_rows(x, nmap)
    Wf = W.float()
    acc = None
    for s in range(splits):
        lo, hi = s * T // splits, (s + 1) * T // splits
        part = torch.zeros((nmap.shape[0], Co), dtype=torch.float32,
                           device=x.device)
        for t in range(lo, hi):
            part += xp[idx[:, t]] @ Wf[t]
        acc = part if acc is None else acc + part
    return _epilogue(acc, x.dtype, bias, mask, residual, relu)


# ------------------------------------------------------ K1 launch planner

K1_BK = 32                  # the kernel's k-slice depth (sparse_conv.cu kBK)
K1_TARGET_BLOCKS = 264      # two blocks for each of the H100's 132 SMs
K1_MIN_TAPS_PER_SPLIT = 3


class K1Plan(NamedTuple):
    """One K1 launch: `packed` takes the narrow-input route (taps packed
    into K); (bm, bn) is the output tile of a block; the taps are split
    over `splits` blocks of each tile (split s: taps [s*T//S, (s+1)*T//S)),
    whose partials a second pass adds in split order."""

    packed: bool
    bm: int
    bn: int
    splits: int


@functools.lru_cache(maxsize=1024)
def k1_plan(m_out: int, taps: int, ca: int, cb: int, co: int) -> K1Plan:
    """The tile and tap split of a K1 launch, from its shape alone: 128 x 32
    tiles for Co <= 32, 64 x 64 for Co <= 64, else 64 x 128; the taps are
    split only where the row x column tiles would give fewer than
    K1_TARGET_BLOCKS blocks, with at least K1_MIN_TAPS_PER_SPLIT taps a
    split. Narrow inputs (a channel count not a multiple of 8, which a
    16-byte copy cannot gather) pack their taps into K and never split."""
    packed = ca % 8 != 0 or cb % 8 != 0
    bm, bn = (128, 32) if co <= 32 else (64, 64) if co <= 64 else (64, 128)
    tiles = -(-m_out // bm) * -(-co // bn)
    splits = 1
    if not packed and tiles < K1_TARGET_BLOCKS:
        splits = max(1, min(-(-K1_TARGET_BLOCKS // max(tiles, 1)),
                            taps // K1_MIN_TAPS_PER_SPLIT))
    return K1Plan(packed, bm, bn, splits)


# ---------------------------------------------------------------- kernel K1

_K1_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p)
_BF16 = torch.bfloat16
_K1_DTYPES = (_BF16, _BF16, _BF16, torch.int32, torch.float32, torch.bool,
              _BF16)


def sparse_conv(x, W, nmap, *, x2=None, bias=None, mask=None, residual=None,
                relu=False):
    """K1: out [M_out, Co] = epilogue(sum_t cat(x, x2)[nmap[:, t]] @ W[t]).

    x [M_in, Ca], x2 [M_in, Cb] (optional skip concat), W [T, Ca+Cb, Co],
    nmap [M_out, T] int32 (sentinel M_in), bias [Co] f32, mask [M_out] bool,
    residual [M_out, Co]. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16 activations and weights) or raises.
    An output width that is not a multiple of 8 (a model's last conv at
    n_out) takes the padded route on either: W, bias and residual get zero
    columns up to the next multiple of 8 (`pad_out`), the output is sliced
    back."""
    co = W.shape[-1]
    if co % 8:
        return sparse_conv(x, pad_out(W), nmap, x2=x2, bias=pad_out(bias),
                           mask=mask, residual=pad_out(residual),
                           relu=relu)[:, :co].contiguous()
    if x.is_cpu:
        return sparse_conv_plain(x, W, nmap, x2=x2, bias=bias, mask=mask,
                                 residual=residual, relu=relu)
    return _launch_k1("sparse_conv", x, W, nmap, x2, bias, mask, residual,
                      relu)


def pad_out(t):
    """t [..., Co] with zero columns up to the next multiple of 8 (None
    stays None): K1's and K5's output width."""
    if t is None or t.shape[-1] % 8 == 0:
        return t
    return F.pad(t, (0, -t.shape[-1] % 8)).contiguous()


def sparse_conv_diff(x, x2, W, nmap, inv):
    """`SparseConvFunction` for any output width: W [T, Ci, Co] with Co not
    a multiple of 8 is padded with zero columns inside autograd (F.pad,
    whose backward slices dW back: the real columns' dW is unchanged), the
    output sliced to Co."""
    co = W.shape[-1]
    if co % 8 == 0:
        return SparseConvFunction.apply(x, x2, W, nmap, inv)
    return SparseConvFunction.apply(x, x2, pad_out(W), nmap, inv)[:, :co]


def sparse_conv_dgrad(dy, Wt, inv):
    """The input gradient of a conv: K1 over the inverse map, dX [M_in, Ci]
    = sum_t dY[inv[:, t]] @ Wt[t] with Wt [T, Co, Ci] = W transposed per
    tap. Counted apart from the forward, as `sparse_conv_dgrad`."""
    if dy.is_cpu:
        return sparse_conv_plain(dy, Wt, inv)
    return _launch_k1("sparse_conv_dgrad", dy, Wt, inv, None, None, None,
                      None, False)


def _launch_k1(count_as, x, W, nmap, x2, bias, mask, residual, relu):
    fn = kernels.load("sparse_conv", _K1_ARGS)
    dev = kernels.require_cuda("sparse_conv", x, x2, W, nmap, bias, mask,
                               residual, dtypes=_K1_DTYPES)
    M_in, Ca = x.shape
    Cb = 0 if x2 is None else x2.shape[1]
    T, Ci, Co = W.shape
    M_out = nmap.shape[0]
    if Ci != Ca + Cb or nmap.shape[1] != T:
        raise ValueError(f"sparse_conv: W {tuple(W.shape)} does not match "
                         f"inputs ({Ca}+{Cb} channels) and map "
                         f"{tuple(nmap.shape)}")
    if Co % 8:
        raise ValueError(f"sparse_conv: {Co} output channels, the kernel "
                         "takes a multiple of 8")
    if x2 is not None and x2.shape[0] != M_in:
        raise ValueError("sparse_conv: x and x2 differ in rows")
    if bias is not None and bias.shape != (Co,):
        raise ValueError("sparse_conv: bias shape")
    if mask is not None and mask.shape != (M_out,):
        raise ValueError("sparse_conv: mask shape")
    if residual is not None and residual.shape != (M_out, Co):
        raise ValueError("sparse_conv: residual shape")
    plan = k1_plan(M_out, T, Ca, Cb, Co)
    out = x.new_empty(M_out, Co)
    part = (x.new_empty(plan.splits, M_out, Co, dtype=torch.float32)
            if plan.splits > 1 else None)
    p = kernels.ptr
    err = fn(x.data_ptr(), Ca, p(x2), Cb, M_in, nmap.data_ptr(), T, M_out,
             W.data_ptr(), Co, p(bias), p(mask), p(residual), int(relu),
             out.data_ptr(), p(part), plan.splits, plan.bm, plan.bn,
             int(plan.packed), kernels.stream_handle(dev))
    kernels.check_launch(count_as, err)
    return out


# ---------------------------------------------------------------- kernel K5


def sparse_conv_wgrad_plain(x, dy, nmap, *, x2=None):
    """Plain PyTorch version of K5: dW [T, Ci, Co] f32 = per tap the
    gathered inputs transposed times dY, summed in f32."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    xp, idx = _padded_rows(x, nmap)
    dyf = dy.float()
    return torch.stack([xp[idx[:, t]].T @ dyf for t in range(nmap.shape[1])])


# K5's reformulations, as plain torch. The CPU tests hold each against
# `sparse_conv_wgrad_plain` and jax.grad of the JAX convs; the main path
# never calls them (on the card the kernel computes them).


def k5_live_slices(nmap, m_in: int) -> torch.Tensor:
    """[T, ceil(M_out / K5_BK)] bool: k-slice s of tap t (output rows
    [s*K5_BK, (s+1)*K5_BK)) has a row whose map entry reads a voxel. K5
    skips the other slices."""
    M_out, T = nmap.shape
    n_sl = -(-M_out // K5_BK)
    valid = (nmap >= 0) & (nmap < m_in)
    pad = valid.new_zeros((n_sl * K5_BK - M_out, T))
    return torch.cat([valid, pad]).reshape(n_sl, K5_BK, T).any(1).T


def sparse_conv_wgrad_split_plain(x, dy, nmap, rows_per_split: int, *,
                                  x2=None):
    """K5's row split: split z sums output rows [z*R, (z+1)*R) into its own
    f32 partial, walking them in k-slices of K5_BK rows and skipping every
    slice whose rows all read the sentinel (`k5_live_slices`); a row whose
    entry is a sentinel contributes neither its input nor its dY row. The
    partials are added in split order."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    M_out, T = nmap.shape
    xp, idx = _padded_rows(x, nmap)
    valid = idx < x.shape[0]
    live = k5_live_slices(nmap, x.shape[0])
    dyf = dy.float()
    acc = None
    for lo in range(0, max(M_out, 1), rows_per_split):
        hi = min(M_out, lo + rows_per_split)
        part = x.new_zeros((T, x.shape[1], dy.shape[1]), dtype=torch.float32)
        slc = torch.arange(lo, hi, device=x.device) // K5_BK
        for t in range(T):
            keep = valid[lo:hi, t] & live[t, slc]
            a = xp[idx[lo:hi, t]] * keep[:, None]
            part[t] = a.T @ (dyf[lo:hi] * keep[:, None])
        acc = part if acc is None else acc + part
    return acc


def sparse_conv_wgrad_tap_packed_plain(x, dy, nmap, *, x2=None):
    """K5's narrow-input route: each output row's T taps of Ci channels are
    one row of M = T*Ci gathered scalars, zero-padded to a multiple of
    K5_PACKED_BM; dW viewed as [T*Ci, Co] (dW's own memory) is that matrix
    transposed times dY: one product instead of T."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    M_out, T = nmap.shape
    Ci, Co = x.shape[1], dy.shape[1]
    K = T * Ci
    Kp = -(-K // K5_PACKED_BM) * K5_PACKED_BM
    xp, idx = _padded_rows(x, nmap)
    a = x.new_zeros((M_out, Kp), dtype=torch.float32)
    a[:, :K] = xp[idx].reshape(M_out, K)
    return (a.T @ dy.float())[:K].reshape(T, Ci, Co)


# ------------------------------------------------------ K5 launch planner

K5_BK = 32                   # the kernel's k-slice: output rows
K5_PACKED_BM = 128           # the packed route's tile of T*Ci rows of dW
K5_TARGET_BLOCKS = 1056      # eight blocks for each of the H100's 132 SMs
K5_MIN_SLICES = 32           # k-slices a split walks at least
K5_MAX_PART_BYTES = 8 << 20  # the split partials, at most


class K5Plan(NamedTuple):
    """One K5 launch: `packed` takes the narrow-input route (the taps
    packed into M, one block column for every tap); otherwise a block owns
    one tap. (bm, bn) is a block's tile of dW (in-channels x out-channels,
    or rows of [T*Ci, Co] when packed); the output rows split over `splits`
    blocks of `rows_per_split` rows each (a multiple of K5_BK), whose f32
    partials a second pass adds in split order."""

    packed: bool
    bm: int
    bn: int
    splits: int
    rows_per_split: int


@functools.lru_cache(maxsize=1024)
def k5_plan(m_out: int, taps: int, ca: int, cb: int, co: int) -> K5Plan:
    """The tile, tap grouping, row split and route of a K5 launch, from its
    shape alone. Tiles: bm = 32 or 64 in-channels (32 where Ci <= 32) and
    bn = 32 or 64 out-channels likewise; wider channel counts take several
    tiles, whose blocks keep more of the card busy than one 128-wide tile
    would (6.1 against 8.1 ms of device time per train step, H100); narrow
    inputs (a channel count not a multiple of 8, which a 16-byte
    copy cannot gather) pack their T*Ci scalars into tiles of 128. The rows
    split until the launch has K5_TARGET_BLOCKS blocks, each split walking
    at least K5_MIN_SLICES k-slices, with at most K5_MAX_PART_BYTES of
    partials."""
    ci = ca + cb
    packed = ca % 8 != 0 or cb % 8 != 0
    bm = K5_PACKED_BM if packed else 32 if ci <= 32 else 64
    bn = 32 if co <= 32 else 64
    ktot = taps * ci if packed else ci
    blocks = (1 if packed else taps) * -(-ktot // bm) * -(-co // bn)
    slices = -(-m_out // K5_BK)
    size = taps * ci * co * 4
    splits = max(1, min(-(-K5_TARGET_BLOCKS // blocks),
                        slices // K5_MIN_SLICES,
                        K5_MAX_PART_BYTES // max(size, 1)))
    rows = max(1, -(-slices // splits)) * K5_BK
    return K5Plan(packed, bm, bn, max(1, -(-m_out // rows)), rows)


_K5_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p)
_K5_DTYPES = (_BF16, _BF16, _BF16, torch.int32)


def sparse_conv_wgrad(x, dy, nmap, *, x2=None):
    """K5: dW [T, Ca+Cb, Co] f32 = sum_o cat(x, x2)[nmap[o, t]]^T dY[o].

    x [M_in, Ca], x2 [M_in, Cb] (optional), dy [M_out, Co], nmap [M_out, T]
    int32 (sentinel M_in). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16 x, x2 and dy, Co a multiple of 8) or
    raises."""
    if x.is_cpu:
        return sparse_conv_wgrad_plain(x, dy, nmap, x2=x2)
    fn = kernels.load("sparse_conv_wgrad", _K5_ARGS)
    dev = kernels.require_cuda("sparse_conv_wgrad", x, x2, dy, nmap,
                               dtypes=_K5_DTYPES)
    M_in, Ca = x.shape
    Cb = 0 if x2 is None else x2.shape[1]
    M_out, T = nmap.shape
    Co = dy.shape[1]
    if dy.shape[0] != M_out or (x2 is not None and x2.shape[0] != M_in):
        raise ValueError(f"sparse_conv_wgrad: dy {tuple(dy.shape)}, map "
                         f"{tuple(nmap.shape)} and inputs disagree in rows")
    if Co % 8:
        raise ValueError(f"sparse_conv_wgrad: {Co} output channels, the "
                         "kernel takes a multiple of 8")
    plan = k5_plan(M_out, T, Ca, Cb, Co)
    out = x.new_empty((T, Ca + Cb, Co), dtype=torch.float32)
    part = (x.new_empty((plan.splits, T, Ca + Cb, Co), dtype=torch.float32)
            if plan.splits > 1 else None)
    p = kernels.ptr
    err = fn(x.data_ptr(), Ca, p(x2), Cb, M_in, nmap.data_ptr(), T, M_out,
             dy.data_ptr(), Co, plan.splits, plan.rows_per_split, plan.bm,
             plan.bn, int(plan.packed), p(part), out.data_ptr(),
             kernels.stream_handle(dev))
    kernels.check_launch("sparse_conv_wgrad", err)
    return out


# ------------------------------------------------------------- autograd


class SparseConvFunction(torch.autograd.Function):
    """out [M_out, Co] = sum_t cat(x, x2)[nmap[:, t]] @ W[t], differentiable
    in x, x2 and W (the raw gathered product: bias, mask, residual and ReLU
    stay plain torch ops, as the JAX package keeps them outside its matmul).

    W is cast to x's dtype for K1 (bf16 on the card, with f32 sums); dW
    comes back in W's dtype. The backward casts dY to x's dtype, as JAX's
    cotangent of a bf16 conv output is bf16 (brick_conv.py:259-261, :307),
    then dX = K1 over `inv` with W transposed per tap (`sparse_conv_dgrad`)
    and dW = K5. `inv` (`invert_map(nmap, M_in)`) may be None when neither
    x nor x2 needs a gradient. An inverse from K12 carries its call's
    collision count, which the backward raises on before dX reads it."""

    @staticmethod
    def forward(ctx, x, x2, W, nmap, inv):
        Wc = W.to(x.dtype).contiguous()
        ctx.save_for_backward(x, x2, Wc, nmap, inv)
        ctx.w_dtype = W.dtype
        ctx.collisions = collision_check(inv)
        return sparse_conv(x, Wc, nmap, x2=x2)

    @staticmethod
    def backward(ctx, dy):
        x, x2, Wc, nmap, inv = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dx2 = dW = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if inv is None:
                raise ValueError("SparseConvFunction: dX needs the inverse "
                                 "map")
            if ctx.collisions is not None:     # K12's count, before dX
                ctx.collisions.raise_if_any()
            dcat = sparse_conv_dgrad(dy, Wc.transpose(1, 2).contiguous(), inv)
            Ca = x.shape[1]
            dx = dcat[:, :Ca].contiguous()
            if x2 is not None:
                dx2 = dcat[:, Ca:].contiguous()
        if ctx.needs_input_grad[2]:
            dW = sparse_conv_wgrad(x, dy, nmap, x2=x2).to(ctx.w_dtype)
        return dx, dx2, dW, None, None
