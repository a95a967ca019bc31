"""Masked brute-force 1-NN (counterpart of eyoc_tpu/ops/knn.py:masked_argmin).

`masked_argmin` is kernel K2 on the card; its plain version below is the
tiled Gram-form sweep of the JAX package. Semantics: squared L2; a masked
reference costs +1e30; ties go to the lowest index; an invalid query
returns (1e30, 0).
"""

from __future__ import annotations

import ctypes

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


_K2_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p)
_K2_DIMS = (3, 32)     # GT-pair coordinates, ResUNet features


def masked_argmin(query, qmask, ref, rmask):
    """1-NN of every valid query among the valid refs.

    query [Nq, D] f32, ref [Nr, D] f32, masks bool. Returns (d2 [Nq] f32,
    idx [Nq] int32). A CPU tensor takes the plain version; a CUDA tensor
    launches K2 (D = 3 or 32) or raises."""
    if query.device.type == "cpu":
        return masked_argmin_plain(query, qmask, ref, rmask)
    fn = kernels.load("masked_argmin", _K2_ARGS)
    f32 = torch.float32
    kernels.require_cuda("masked_argmin", query, qmask, ref, rmask,
                         dtypes=(f32, torch.bool, f32, torch.bool))
    Nq, D = query.shape
    Nr = ref.shape[0]
    if D not in _K2_DIMS or ref.shape[1] != D:
        raise ValueError(f"masked_argmin: feature width {D} / "
                         f"{ref.shape[1]} not in {_K2_DIMS}")
    if qmask.shape != (Nq,) or rmask.shape != (Nr,):
        raise ValueError("masked_argmin: mask shapes")
    splits = _splits(Nq, Nr)
    part_d = torch.empty((splits, Nq), dtype=f32, device=query.device)
    part_i = torch.empty((splits, Nq), dtype=torch.int32, device=query.device)
    d2 = torch.empty(Nq, dtype=f32, device=query.device)
    idx = torch.empty(Nq, dtype=torch.int32, device=query.device)
    p = kernels.ptr
    err = fn(p(query), p(qmask), Nq, p(ref), p(rmask), Nr, D, splits,
             p(part_d), p(part_i), p(d2), p(idx), kernels.stream_handle())
    kernels.check_launch("masked_argmin", err)
    return d2, idx


def _splits(nq: int, nr: int) -> int:
    """Reference splits (gridDim.y) of the launch: enough blocks of 128
    queries to cover the card's 132 SMs about twice."""
    qblocks = -(-nq // 128)
    splits = -(-264 // max(qblocks, 1))
    splits = min(splits, -(-nr // 64), 64)
    return max(splits, 1)
