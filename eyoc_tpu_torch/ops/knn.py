"""Masked brute-force 1-NN (counterpart of eyoc_tpu/ops/knn.py:masked_argmin).

`masked_argmin_batched` is kernel K2 on the card, one launch for a batch
of independent problems (the JAX package's `vmap`); `masked_argmin` is its
B = 1 case. The plain version below is the tiled Gram-form sweep of the
JAX package. Semantics: squared L2; a masked reference costs +1e30; ties
go to the lowest index; an invalid query returns (1e30, 0).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eyoc_tpu_torch.geometry.metrics import pdist2
from eyoc_tpu_torch.utils import kernels

_BIG = 1e30


def masked_argmin_plain(query, qmask, ref, rmask, tile: int = 512):
    """Row tiles of pdist2 + the mask bias, then argmin (first minimum)."""
    bias = torch.where(rmask, 0.0, _BIG).to(torch.float32)
    d_parts, i_parts = [], []
    for q0 in range(0, query.shape[0], tile):
        d2 = pdist2(query[q0:q0 + tile], ref) + bias[None, :]
        i = torch.argmin(d2, dim=1)                 # first minimum
        d_parts.append(torch.gather(d2, 1, i[:, None])[:, 0])
        i_parts.append(i)
    d2 = torch.cat(d_parts) if d_parts else query.new_zeros(0)
    idx = (torch.cat(i_parts) if i_parts
           else torch.zeros(0, dtype=torch.int64, device=query.device))
    d2 = torch.where(qmask, d2, torch.full_like(d2, _BIG))
    idx = torch.where(qmask, idx, torch.zeros_like(idx)).to(torch.int32)
    return d2, idx


def masked_argmin_batched_plain(query, qmask, ref, rmask):
    """`masked_argmin_plain` for each of the B problems, stacked."""
    out = [masked_argmin_plain(q, qm, r, rm)
           for q, qm, r, rm in zip(query, qmask, ref, rmask)]
    return torch.stack([d for d, _ in out]), torch.stack([i for _, i in out])


def masked_argmin_split_plain(query, qmask, ref, rmask, splits: int,
                              tile: int = 256):
    """K2's reformulation in plain torch: the references in tiles of
    `tile`, tile t to split t % splits; each split's (min, first argmin) of
    the direct-form distance over its valid refs in index order; the splits
    reduced in split order, a split's pair taken when its distance is
    smaller, or equal with a smaller index (the lowest index wins a tie); a
    query with no valid ref, or an invalid one, gets (1e30, 0)."""
    nq, nr = query.shape[0], ref.shape[0]
    best = torch.full((nq,), float("inf"), dtype=torch.float32,
                      device=query.device)
    idx = torch.zeros(nq, dtype=torch.int64, device=query.device)
    for s in range(splits):
        cols = torch.cat([torch.arange(j0, min(nr, j0 + tile))
                          for j0 in range(s * tile, nr, splits * tile)]
                         or [torch.zeros(0, dtype=torch.int64)])
        cols = cols[rmask[cols]]
        if cols.numel() == 0:
            continue
        d2 = torch.sum((query[:, None, :] - ref[None, cols, :]) ** 2, -1)
        i = torch.argmin(d2, dim=1)
        d = torch.gather(d2, 1, i[:, None])[:, 0]
        j = cols[i]
        take = (d < best) | ((d == best) & (j < idx))
        best = torch.where(take, d, best)
        idx = torch.where(take, j, idx)
    ok = qmask & (best < float("inf"))
    best = torch.where(ok, best, torch.full_like(best, _BIG))
    idx = torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int32)
    return best, idx


_K2_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
# queries a block holds (128 threads x R) and references it stages at
# once (csrc/masked_argmin.cu:Shape), by feature width: GT-pair
# coordinates, ResUNet features
_K2_QUERIES = {3: 1024, 32: 512}
_K2_REF_TILE = {3: 256, 32: 64}
_K2_MAX_SPLITS = 64       # the last block of a query tile reads them all


@functools.lru_cache(maxsize=None)
def k2_plan(batch: int, nq: int, nr: int, dim: int, resident: int):
    """(query tiles, reference splits) of a K2 launch: as many splits as
    keep every block resident at once (`resident` blocks: occupancy x
    SMs), so that the launch is one wave; at most one split per reference
    tile (the splits take the tiles in turn), and _K2_MAX_SPLITS."""
    qtiles = -(-nq // _K2_QUERIES[dim])
    splits = resident // max(batch * qtiles, 1)
    splits = min(splits, -(-nr // _K2_REF_TILE[dim]), _K2_MAX_SPLITS)
    return qtiles, max(splits, 1)


_resident: dict = {}


def _k2_resident(dev: int, dim: int) -> int:
    """Blocks of K2 at width `dim` that device `dev` holds at once."""
    n = _resident.get((dev, dim))
    if n is None:
        fn = kernels.load("masked_argmin", (ctypes.c_int,),
                          symbol="masked_argmin_resident")
        with torch.cuda.device(dev):
            n = fn(dim)
        if n <= 0:
            raise RuntimeError("masked_argmin: occupancy query failed")
        _resident[(dev, dim)] = n
    return n


def masked_argmin_batched(query, qmask, ref, rmask):
    """1-NN of every valid query among the valid refs of its own problem,
    for B problems at once.

    query [B, Nq, D] f32, ref [B, Nr, D] f32, masks [B, Nq] / [B, Nr] bool.
    Returns (d2 [B, Nq] f32, idx [B, Nq] int32). A CPU tensor takes the
    plain version; a CUDA tensor launches K2 once (D = 3 or 32) or raises."""
    if query.is_cpu:
        return masked_argmin_batched_plain(query, qmask, ref, rmask)
    B, Nq, D = query.shape
    Nr = ref.shape[1]
    if ref.shape != (B, Nr, D) or qmask.shape != (B, Nq) \
            or rmask.shape != (B, Nr):
        raise ValueError("masked_argmin_batched: expected query [B, Nq, D], "
                         "qmask [B, Nq], ref [B, Nr, D], rmask [B, Nr]")
    return _launch(query, qmask, ref, rmask, B, Nq, Nr, D)


def masked_argmin(query, qmask, ref, rmask):
    """1-NN of every valid query among the valid refs.

    query [Nq, D] f32, ref [Nr, D] f32, masks bool. Returns (d2 [Nq] f32,
    idx [Nq] int32). A CPU tensor takes the plain version; a CUDA tensor
    launches K2 (D = 3 or 32) as a batch of one, or raises."""
    if query.is_cpu:
        return masked_argmin_plain(query, qmask, ref, rmask)
    Nq, D = query.shape
    Nr = ref.shape[0]
    if ref.shape != (Nr, D) or qmask.shape != (Nq,) or rmask.shape != (Nr,):
        raise ValueError("masked_argmin: expected query [Nq, D], qmask "
                         "[Nq], ref [Nr, D], rmask [Nr]")
    return _launch(query, qmask, ref, rmask, 1, Nq, Nr, D)


def _launch(query, qmask, ref, rmask, B: int, Nq: int, Nr: int, D: int):
    """One K2 launch over B problems; d2 and idx take query's batch shape."""
    fn = kernels.load("masked_argmin", _K2_ARGS)
    f32 = torch.float32
    dev = kernels.require_cuda("masked_argmin", query, qmask, ref, rmask,
                               dtypes=(f32, torch.bool, f32, torch.bool))
    if D not in _K2_QUERIES:
        raise ValueError(f"masked_argmin: feature width {D} not in "
                         f"{tuple(_K2_QUERIES)}")
    qtiles, splits = k2_plan(B, Nq, Nr, D, _k2_resident(dev, D))
    shape = query.shape[:-1]
    d2 = query.new_empty(shape)
    idx = query.new_empty(shape, dtype=torch.int32)
    part = query.new_empty(2 * B * splits * Nq) if splits > 1 else None
    p = kernels.ptr
    err = fn(p(query), p(qmask), p(ref), p(rmask), B, Nq, Nr, D, splits,
             p(part), p(kernels.ticket(dev, B * qtiles)), p(d2), p(idx),
             kernels.stream_handle(dev))
    kernels.check_launch("masked_argmin", err)
    return d2, idx
