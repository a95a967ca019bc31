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
zero row. `conv_maps` turns a BrickPyramid into those maps.

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
from typing import NamedTuple, Optional, Tuple

import torch

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


def conv_same_map(level: BrickLevel, k: int = 3,
                  c2v: torch.Tensor | None = None) -> torch.Tensor:
    """[M_l, k^3] stride-1 map at one level."""
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


def conv_maps(pyr: BrickPyramid, num_levels: int,
              conv1_kernel_size: int = 5, inverse: bool = False) -> ConvMaps:
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
    collisions = int(valid.sum() - (inv < M_out).sum())   # one host sync
    if collisions:
        raise ValueError(f"invert_map: {collisions} (input, tap) slots are "
                         "read by more than one output row")
    return inv


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
    tensor launches the kernel (bf16 activations and weights, Co a multiple
    of 8) or raises."""
    if x.is_cpu:
        return sparse_conv_plain(x, W, nmap, x2=x2, bias=bias, mask=mask,
                                 residual=residual, relu=relu)
    return _launch_k1("sparse_conv", x, W, nmap, x2, bias, mask, residual,
                      relu)


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


_K5_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p)


def _wgrad_splits(m_out: int, T: int, Ci: int, Co: int) -> int:
    """Row splits (gridDim.z) of a K5 launch: enough blocks to cover the
    card's 132 SMs about twice, and at least 256 rows per split."""
    ti = 16 if Ci <= 16 else (32 if Ci <= 32 else 64)
    to = 32 if Co <= 32 else 64
    blocks = T * -(-Ci // ti) * -(-Co // to)
    return max(1, min(-(-264 // blocks), m_out // 256))


def sparse_conv_wgrad(x, dy, nmap, *, x2=None):
    """K5: dW [T, Ca+Cb, Co] f32 = sum_o cat(x, x2)[nmap[o, t]]^T dY[o].

    x [M_in, Ca], x2 [M_in, Cb] (optional), dy [M_out, Co], nmap [M_out, T]
    int32 (sentinel M_in). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16 x, x2 and dy) or raises."""
    if x.is_cpu:
        return sparse_conv_wgrad_plain(x, dy, nmap, x2=x2)
    fn = kernels.load("sparse_conv_wgrad", _K5_ARGS)
    bf16 = torch.bfloat16
    dev = kernels.require_cuda("sparse_conv_wgrad", x, x2, dy, nmap,
                               dtypes=(bf16, bf16, bf16, torch.int32))
    M_in, Ca = x.shape
    Cb = 0 if x2 is None else x2.shape[1]
    M_out, T = nmap.shape
    Co = dy.shape[1]
    if dy.shape[0] != M_out or (x2 is not None and x2.shape[0] != M_in):
        raise ValueError(f"sparse_conv_wgrad: dy {tuple(dy.shape)}, map "
                         f"{tuple(nmap.shape)} and inputs disagree in rows")
    out = torch.empty((T, Ca + Cb, Co), dtype=torch.float32, device=x.device)
    splits = _wgrad_splits(M_out, T, Ca + Cb, Co)
    part = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32,
                        device=x.device) if splits > 1 else out)
    p = kernels.ptr
    err = fn(p(x), Ca, p(x2), Cb, M_in, p(nmap), T, M_out, p(dy), Co, splits,
             p(part), p(out), kernels.stream_handle(dev))
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
    x nor x2 needs a gradient."""

    @staticmethod
    def forward(ctx, x, x2, W, nmap, inv):
        Wc = W.to(x.dtype).contiguous()
        ctx.save_for_backward(x, x2, Wc, nmap, inv)
        ctx.w_dtype = W.dtype
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
            dcat = sparse_conv_dgrad(dy, Wc.transpose(1, 2).contiguous(), inv)
            Ca = x.shape[1]
            dx = dcat[:, :Ca].contiguous()
            if x2 is not None:
                dx2 = dcat[:, Ca:].contiguous()
        if ctx.needs_input_grad[2]:
            dW = sparse_conv_wgrad(x, dy, nmap, x2=x2).to(ctx.w_dtype)
        return dx, dx2, dW, None, None
