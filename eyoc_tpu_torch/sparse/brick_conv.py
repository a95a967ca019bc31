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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

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
    [M_l, 27]; vox_masks[l]: [M_l] bool output masks."""

    same3: Tuple[torch.Tensor, ...]
    first: torch.Tensor
    down: Tuple[torch.Tensor, ...]
    up: Tuple[torch.Tensor, ...]
    vox_masks: Tuple[torch.Tensor, ...]


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
              conv1_kernel_size: int = 5) -> ConvMaps:
    """Every gather map a UNet of `num_levels` levels needs."""
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
    return ConvMaps(same3, first, down, up,
                    tuple(pyr.vox_masks[:num_levels]))


def identity_map(m: int, device) -> torch.Tensor:
    """[m, 1] map of a per-voxel (1x1) conv."""
    return torch.arange(m, dtype=torch.int32, device=device)[:, None]


# ---------------------------------------------------------------- kernel K1


def sparse_conv_plain(x, W, nmap, *, x2=None, bias=None, mask=None,
                      residual=None, relu=False):
    """Plain PyTorch version of K1: the same sum in f32, the same epilogue,
    one rounding to x's dtype at the end."""
    if x2 is not None:
        x = torch.cat([x, x2], 1)
    M_in, Ci = x.shape
    T, _, Co = W.shape
    xp = torch.cat([x.float(), x.new_zeros((1, Ci), dtype=torch.float32)], 0)
    idx = torch.where((nmap >= 0) & (nmap < M_in), nmap,
                      torch.full_like(nmap, M_in)).long()
    Wf = W.float()
    acc = torch.zeros((nmap.shape[0], Co), dtype=torch.float32,
                      device=x.device)
    for t in range(T):
        acc += xp[idx[:, t]] @ Wf[t]
    if bias is not None:
        acc = acc + bias.float()
    if mask is not None:
        acc = acc * mask[:, None].float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype)


_K1_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


def sparse_conv(x, W, nmap, *, x2=None, bias=None, mask=None, residual=None,
                relu=False):
    """K1: out [M_out, Co] = epilogue(sum_t cat(x, x2)[nmap[:, t]] @ W[t]).

    x [M_in, Ca], x2 [M_in, Cb] (optional skip concat), W [T, Ca+Cb, Co],
    nmap [M_out, T] int32 (sentinel M_in), bias [Co] f32, mask [M_out] bool,
    residual [M_out, Co]. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16 activations and weights) or raises."""
    if x.device.type == "cpu":
        return sparse_conv_plain(x, W, nmap, x2=x2, bias=bias, mask=mask,
                                 residual=residual, relu=relu)
    fn = kernels.load("sparse_conv", _K1_ARGS)
    bf16 = torch.bfloat16
    kernels.require_cuda("sparse_conv", x, x2, W, nmap, bias, mask, residual,
                         dtypes=(bf16, bf16, bf16, torch.int32, torch.float32,
                                 torch.bool, bf16))
    M_in, Ca = x.shape
    Cb = 0 if x2 is None else x2.shape[1]
    T, Ci, Co = W.shape
    M_out = nmap.shape[0]
    if Ci != Ca + Cb or nmap.shape[1] != T:
        raise ValueError(f"sparse_conv: W {tuple(W.shape)} does not match "
                         f"inputs ({Ca}+{Cb} channels) and map "
                         f"{tuple(nmap.shape)}")
    if x2 is not None and x2.shape[0] != M_in:
        raise ValueError("sparse_conv: x and x2 differ in rows")
    if bias is not None and bias.shape != (Co,):
        raise ValueError("sparse_conv: bias shape")
    if mask is not None and mask.shape != (M_out,):
        raise ValueError("sparse_conv: mask shape")
    if residual is not None and residual.shape != (M_out, Co):
        raise ValueError("sparse_conv: residual shape")
    out = torch.empty((M_out, Co), dtype=bf16, device=x.device)
    p = kernels.ptr
    err = fn(p(x), Ca, p(x2), Cb, M_in, p(nmap), T, M_out, p(W), Co, p(bias),
             p(mask), p(residual), int(relu), p(out), kernels.stream_handle())
    kernels.check_launch("sparse_conv", err)
    return out
