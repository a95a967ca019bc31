"""Masked brute-force kNN (counterpart of eyoc_tpu/ops/knn.py: masked_knn
at k = 1 and 2, and masked_argmin).

`masked_argmin_batched` is kernel K2 on the card, one launch for a batch
of independent problems (the JAX package's `vmap`); `masked_argmin` is its
B = 1 case. `masked_knn_batched` / `masked_knn` give the k = 1 or 2 nearest:
k = 1 is K2, k = 2 kernel K8 (`masked_knn2`). `masked_argmin_excl` is
kernel K9, K2 with a spatial exclusion (the loss's safe-radius mining). The
plain versions below are the tiled Gram-form sweeps of the JAX package.
Semantics: squared L2; a masked reference costs +1e30; ties go to the
lowest index; an invalid query returns (1e30, 0).
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


# ---------------------------------------------------------------- kernel K8


def masked_knn2_plain(query, qmask, ref, rmask, tile: int = 512):
    """JAX's k = 2 (knn.py:58-65) on row tiles: the first minimum of the
    Gram-form row plus the mask bias, then its column set to 1e30 and the
    argmin again. Returns (d2 [Nq, 2] f32, idx [Nq, 2] int32)."""
    bias = torch.where(rmask, 0.0, _BIG).to(torch.float32)
    d_parts, i_parts = [], []
    for q0 in range(0, query.shape[0], tile):
        d2 = pdist2(query[q0:q0 + tile], ref) + bias[None, :]
        i1 = torch.argmin(d2, dim=1)
        d1 = torch.gather(d2, 1, i1[:, None])[:, 0]
        d2.scatter_(1, i1[:, None], _BIG)
        i2 = torch.argmin(d2, dim=1)
        dd2 = torch.gather(d2, 1, i2[:, None])[:, 0]
        d_parts.append(torch.stack([d1, dd2], 1))
        i_parts.append(torch.stack([i1, i2], 1))
    d2 = (torch.cat(d_parts) if d_parts
          else query.new_zeros((0, 2)))
    idx = (torch.cat(i_parts) if i_parts
           else torch.zeros((0, 2), dtype=torch.int64, device=query.device))
    d2 = torch.where(qmask[:, None], d2, torch.full_like(d2, _BIG))
    idx = torch.where(qmask[:, None], idx, torch.zeros_like(idx))
    return d2, idx.to(torch.int32)


def masked_knn_batched_plain(query, qmask, ref, rmask, k: int):
    """The plain k = 1 or 2 sweep for each of the B problems, stacked:
    (d2 [B, Nq, k], idx [B, Nq, k])."""
    if k == 1:
        d2, idx = masked_argmin_batched_plain(query, qmask, ref, rmask)
        return d2[..., None], idx[..., None]
    out = [masked_knn2_plain(q, qm, r, rm)
           for q, qm, r, rm in zip(query, qmask, ref, rmask)]
    return torch.stack([d for d, _ in out]), torch.stack([i for _, i in out])


def masked_knn2_split_plain(query, qmask, ref, rmask, splits: int,
                            tile: int = 64):
    """K8's reformulation in plain torch: the references in tiles of `tile`,
    tile t to split t % splits; each split's two nearest valid refs by
    (distance, index) in the direct form; the splits' lists merged in split
    order under that order; a place no valid ref fills, and an invalid
    query, reads (1e30, 0)."""
    nq, nr = query.shape[0], ref.shape[0]
    inf = float("inf")
    best = torch.full((nq, 2), inf, dtype=torch.float32, device=query.device)
    idx = torch.zeros((nq, 2), dtype=torch.int64, device=query.device)
    for s in range(splits):
        cols = torch.cat([torch.arange(j0, min(nr, j0 + tile))
                          for j0 in range(s * tile, nr, splits * tile)]
                         or [torch.zeros(0, dtype=torch.int64)])
        cols = cols[rmask[cols]]
        d2 = torch.sum((query[:, None, :] - ref[None, cols, :]) ** 2, -1)
        # the split's list: stable sort by distance keeps index order on ties
        order = torch.sort(d2, dim=1, stable=True).indices[:, :2]
        d = torch.full((nq, 2), inf, dtype=torch.float32, device=query.device)
        j = torch.zeros((nq, 2), dtype=torch.int64, device=query.device)
        m = order.shape[1]
        d[:, :m] = torch.gather(d2, 1, order)
        j[:, :m] = cols[order]
        for u in range(2):
            dc, jc = d[:, u], j[:, u]
            first = (dc < best[:, 0]) | ((dc == best[:, 0]) & (jc < idx[:, 0]))
            second = ~first & ((dc < best[:, 1])
                                | ((dc == best[:, 1]) & (jc < idx[:, 1])))
            best[:, 1] = torch.where(first, best[:, 0],
                                     torch.where(second, dc, best[:, 1]))
            idx[:, 1] = torch.where(first, idx[:, 0],
                                    torch.where(second, jc, idx[:, 1]))
            best[:, 0] = torch.where(first, dc, best[:, 0])
            idx[:, 0] = torch.where(first, jc, idx[:, 0])
    found = qmask[:, None] & (best < inf)
    best = torch.where(found, best, torch.full_like(best, _BIG))
    idx = torch.where(found, idx, torch.zeros_like(idx)).to(torch.int32)
    return best, idx


_K8_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p)
_K9_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_KNN2_DIM = 32            # K8 and K9 take ResUNet features only
_knn2_blocks: dict = {}


def _knn2_resident(dev: int, excl: bool) -> int:
    """Blocks of K8 (or K9, `excl`) that device `dev` holds at once."""
    n = _knn2_blocks.get((dev, excl))
    if n is None:
        fn = kernels.load("masked_knn2", (ctypes.c_int,),
                          symbol="masked_knn2_resident")
        with torch.cuda.device(dev):
            n = fn(int(excl))
        if n <= 0:
            raise RuntimeError("masked_knn2: occupancy query failed")
        _knn2_blocks[(dev, excl)] = n
    return n


def _launch_knn2(query, qmask, ref, rmask):
    """One K8 launch over B problems: (d2 [B, Nq, 2], idx [B, Nq, 2])."""
    B, Nq, D = query.shape
    Nr = ref.shape[1]
    if ref.shape != (B, Nr, D) or qmask.shape != (B, Nq) \
            or rmask.shape != (B, Nr):
        raise ValueError("masked_knn2: expected query [B, Nq, D], qmask "
                         "[B, Nq], ref [B, Nr, D], rmask [B, Nr]")
    fn = kernels.load("masked_knn2", _K8_ARGS)
    f32 = torch.float32
    dev = kernels.require_cuda("masked_knn2", query, qmask, ref, rmask,
                               dtypes=(f32, torch.bool, f32, torch.bool))
    if D != _KNN2_DIM:
        raise ValueError(f"masked_knn2: feature width {D}, expected "
                         f"{_KNN2_DIM}")
    qtiles, splits = k2_plan(B, Nq, Nr, D, _knn2_resident(dev, False))
    d2 = query.new_empty((B, Nq, 2))
    idx = query.new_empty((B, Nq, 2), dtype=torch.int32)
    part = query.new_empty(4 * B * splits * Nq) if splits > 1 else None
    p = kernels.ptr
    err = fn(p(query), p(qmask), p(ref), p(rmask), B, Nq, Nr, splits,
             p(part), p(kernels.ticket(dev, B * qtiles)), p(d2), p(idx),
             kernels.stream_handle(dev))
    kernels.check_launch("masked_knn2", err)
    return d2, idx


def masked_knn_batched(query, qmask, ref, rmask, k: int = 1):
    """The k (1 or 2) nearest valid refs of every valid query, for B
    problems at once (masked_knn of knn.py:31 under vmap).

    query [B, Nq, D] f32, ref [B, Nr, D] f32, masks [B, Nq] / [B, Nr] bool.
    Returns (d2 [B, Nq, k] f32, idx [B, Nq, k] int32) by (distance, index);
    a place that no valid ref fills, and an invalid query, read (1e30, 0).
    A CPU tensor takes the plain version; a CUDA tensor launches K2 (k = 1)
    or K8 (k = 2, D = 32) once, or raises."""
    if k not in (1, 2):
        raise ValueError(f"masked_knn: k = {k}, only 1 and 2 are ported")
    if query.is_cpu:
        return masked_knn_batched_plain(query, qmask, ref, rmask, k)
    if k == 1:
        d2, idx = masked_argmin_batched(query, qmask, ref, rmask)
        return d2[..., None], idx[..., None]
    return _launch_knn2(query, qmask, ref, rmask)


def masked_knn(query, qmask, ref, rmask, k: int = 1):
    """`masked_knn_batched` for one problem: query [Nq, D], ref [Nr, D];
    returns (d2 [Nq, k], idx [Nq, k])."""
    d2, idx = masked_knn_batched(query[None], qmask[None], ref[None],
                                 rmask[None], k)
    return d2[0], idx[0]


# ---------------------------------------------------------------- kernel K9

_EXCLUDED = 1e9          # an excluded candidate's distance (loss.py:100)


def masked_argmin_excl_plain(anchor, cand, pxyz, cxyz, r2: float):
    """JAX's safe-radius mining (loss.py:97-111): the L2 feature distances
    sqrt(pdist2 + 1e-7) with 1e9 where the candidate's coordinates lie
    within r of the anchor's partner (pdist2 of the coordinates < r2),
    then the argmin (first minimum). Returns (idx [P] int32, excluded [P]
    bool: the chosen candidate was excluded, i.e. all were)."""
    near = pdist2(pxyz, cxyz) < r2
    d = torch.where(near, torch.full_like(near, _EXCLUDED,
                                          dtype=torch.float32),
                    torch.sqrt(pdist2(anchor, cand) + 1e-7))
    ind = torch.argmin(d, dim=1)
    return ind.to(torch.int32), near.gather(1, ind[:, None])[:, 0]


def masked_argmin_excl(anchor, cand, pxyz, cxyz, r2: float):
    """The nearest candidate feature of each anchor among the candidates
    whose coordinates lie at least r from the anchor's partner.

    anchor [P, 32], cand [M, 32] f32 features; pxyz [P, 3] the partners'
    and cxyz [M, 3] the candidates' coordinates; r2 = r^2. Returns
    (idx [P] int32, excluded [P] bool: every candidate was excluded, idx 0
    then). A CPU tensor takes the plain version; a CUDA tensor launches K9
    once, or raises."""
    if anchor.is_cpu:
        return masked_argmin_excl_plain(anchor, cand, pxyz, cxyz, r2)
    P, D = anchor.shape
    M = cand.shape[0]
    if cand.shape != (M, D) or pxyz.shape != (P, 3) or cxyz.shape != (M, 3):
        raise ValueError("masked_argmin_excl: expected anchor [P, D], cand "
                         "[M, D], pxyz [P, 3], cxyz [M, 3]")
    fn = kernels.load("masked_knn2", _K9_ARGS, symbol="masked_argmin_excl")
    f32 = torch.float32
    dev = kernels.require_cuda("masked_argmin_excl", anchor, cand, pxyz,
                               cxyz, dtypes=(f32,) * 4)
    if D != _KNN2_DIM:
        raise ValueError(f"masked_argmin_excl: feature width {D}, expected "
                         f"{_KNN2_DIM}")
    qtiles, splits = k2_plan(1, P, M, D, _knn2_resident(dev, True))
    d2 = anchor.new_empty(P)
    idx = anchor.new_empty(P, dtype=torch.int32)
    excluded = anchor.new_empty(P, dtype=torch.bool)
    part = anchor.new_empty(2 * splits * P) if splits > 1 else None
    p = kernels.ptr
    err = fn(p(anchor), p(cand), p(pxyz), p(cxyz), float(r2), P, M, splits,
             p(part), p(kernels.ticket(dev, qtiles)), p(d2), p(idx),
             p(excluded), kernels.stream_handle(dev))
    kernels.check_launch("masked_argmin_excl", err)
    return idx, excluded
