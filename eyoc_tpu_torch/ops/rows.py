"""Row gather with a zero sentinel (kernel K6) and its backward.

Counterpart of the JAX package's row gathers: `_take_pad0`
(eyoc_tpu/sparse/brick_conv.py:89-92), `bricks.take_rows`, and
`jnp.take(F, idx, axis=0)` in the loss (eyoc_tpu/training/loss.py:85-95),
which the TPU probes under proto/ (`proto_pallas_gather*.py`) computed as
Pallas kernels. `take_rows(src, idx)` is differentiable in `src`: the
backward adds each output row's gradient into its source row (duplicate
indices accumulate, since the loss samples with replacement).
"""

from __future__ import annotations

import ctypes
import math

import torch

from eyoc_tpu_torch.utils import kernels


def take_rows_plain(src, idx):
    """out[i] = src[idx[i]], a zero row where idx is outside [0, N)."""
    N = src.shape[0]
    ok = (idx >= 0) & (idx < N)
    out = src[torch.where(ok, idx, torch.zeros_like(idx)).long()]
    return out * ok.reshape((-1,) + (1,) * (src.dim() - 1)).to(src.dtype)


def take_rows_backward_plain(dout, idx, n_src):
    """dsrc [n_src, ...] f32 = sum of dout rows into their source rows."""
    ok = (idx >= 0) & (idx < n_src)
    dsrc = dout.new_zeros((n_src,) + tuple(dout.shape[1:]),
                          dtype=torch.float32)
    return dsrc.index_add_(0, idx[ok].long(), dout[ok].float())


_GATHER_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_SCATTER_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


def take_rows_gather(src, idx):
    """K6 forward on [N, ...] rows of any 2-byte-multiple width. A CPU
    tensor takes the plain version; a CUDA tensor launches or raises."""
    if src.is_cpu:
        return take_rows_plain(src, idx)
    fn = kernels.load("take_rows", _GATHER_ARGS)
    dev = kernels.require_cuda("take_rows", src, idx,
                               dtypes=(None, torch.int32))
    if idx.dim() != 1:
        raise ValueError("take_rows: idx must be 1-D")
    N = src.shape[0]
    n = idx.shape[0]
    # the 2-D case without tuple arithmetic on shapes: a few microseconds
    # of a call that moves a few hundred KB
    if src.dim() == 2:
        C = src.shape[1]
        out = src.new_empty(n, C)
    else:
        C = math.prod(src.shape[1:])
        out = src.new_empty(n, *src.shape[1:])
    row_bytes = C * src.element_size()
    if row_bytes % 2:
        raise ValueError(f"take_rows: rows of {row_bytes} bytes")
    err = fn(src.data_ptr(), N, idx.data_ptr(), n, row_bytes,
             out.data_ptr(), kernels.stream_handle(dev))
    kernels.check_launch("take_rows", err)
    return out


def take_rows_backward(dout, idx, n_src):
    """K6 backward: dsrc [n_src, C] f32 with dsrc[idx[i]] += dout[i]
    (dout [n, C] f32). A CPU tensor takes the plain version; a CUDA tensor
    launches or raises."""
    if dout.is_cpu:
        return take_rows_backward_plain(dout, idx, n_src)
    fn = kernels.load("take_rows", _SCATTER_ARGS, "take_rows_backward")
    if dout.dim() != 2:
        raise ValueError(f"take_rows_backward: dout {tuple(dout.shape)}")
    dev = kernels.require_cuda("take_rows_backward", dout, idx,
                               dtypes=(torch.float32, torch.int32))
    n, C = dout.shape
    if idx.dim() != 1 or idx.shape[0] != n:
        raise ValueError("take_rows_backward: idx shape")
    dsrc = dout.new_empty(n_src, C)          # zeroed by the C entry point
    err = fn(dout.data_ptr(), idx.data_ptr(), n, C, n_src, dsrc.data_ptr(),
             kernels.stream_handle(dev))
    kernels.check_launch("take_rows_backward", err)
    return dsrc


class TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_src = src.shape[0]
        ctx.src_dtype = src.dtype
        return take_rows_gather(src, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        dsrc = take_rows_backward(dout.float().contiguous(), idx, ctx.n_src)
        return dsrc.to(ctx.src_dtype), None


def take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [N, C] (f32 or bf16), idx [n] int32 -> [n, C]; idx outside
    [0, N) reads a zero row. Differentiable in src."""
    return TakeRows.apply(src, idx.to(torch.int32).contiguous())
