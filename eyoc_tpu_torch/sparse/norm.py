"""Masked batch normalization over valid voxels, train mode
(counterpart of eyoc_tpu/sparse/norm.py:masked_batch_norm /
masked_batch_norm_fb, :30-116).

Semantics are the JAX package's, which match torch.nn.BatchNorm1d over the
valid rows only: statistics from the sums (n, s1, s2) of the rows a mask
keeps, n = max(n, 1), mean = s1 / n, var = max(s2 / n - mean^2, 0) (the
JAX formula, not Welford), normalisation with the biased var, running
update (1 - m) run + m batch with the unbiased var, output zero at
invalid rows. The sums are kernel K7 (`masked_channel_sums`) in the
forward and in the backward; the elementwise passes are plain torch.
`masked_instance_norm` waits for a later slice (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from eyoc_tpu_torch.utils import kernels

# ---------------------------------------------------------------- kernel K7


def masked_channel_sums_plain(x, mask, y=None, shift=None):
    """Plain PyTorch version of K7: [n, sum_m x, sum_m x (y - shift)] f32
    over the rows where mask is true (y = x and no shift by default)."""
    m = mask.float()[:, None]
    xf = x.float()
    yf = xf if y is None else y.float()
    if shift is not None:
        yf = yf - shift.float()
    n = mask.sum(dtype=torch.float32).reshape(1)
    return torch.cat([n, (xf * m).sum(0), (xf * yf * m).sum(0)])


_K7_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _chunks(m: int) -> int:
    """Row chunks (gridDim.x) of a K7 launch: about 256 rows each, at most
    1024 partials to add in the second pass."""
    return max(1, min(-(-m // 256), 1024))


def masked_channel_sums(x, mask, y=None, shift=None):
    """K7: [1 + 2C] f32 = [n, sum_m x[:, c], sum_m x[:, c] (y[:, c] -
    shift[c])] over rows with mask. x, y [M, C], mask [M] bool, shift [C]
    f32 (only with y). A CPU tensor takes the plain version (any float
    dtype); a CUDA tensor launches the kernel, which takes bf16 x and y
    (the model's compute dtype on the card), or raises."""
    if x.is_cpu:
        return masked_channel_sums_plain(x, mask, y, shift)
    fn = kernels.load("masked_channel_sums", _K7_ARGS)
    if shift is not None and y is None:
        raise ValueError("masked_channel_sums: a shift needs y")
    bf = torch.bfloat16
    dev = kernels.require_cuda("masked_channel_sums", x, y, shift, mask,
                               dtypes=(bf, bf, torch.float32, torch.bool))
    M, C = x.shape
    if mask.shape != (M,) or (y is not None and y.shape != x.shape) \
            or (shift is not None and shift.shape != (C,)):
        raise ValueError("masked_channel_sums: shapes")
    chunks = _chunks(M)
    part = torch.empty((chunks, 1 + 2 * C), dtype=torch.float32,
                       device=x.device)
    out = torch.empty(1 + 2 * C, dtype=torch.float32, device=x.device)
    p = kernels.ptr
    err = fn(p(x), p(y), p(shift), p(mask), M, C, chunks, p(part), p(out),
             kernels.stream_handle(dev))
    kernels.check_launch("masked_channel_sums", err)
    return out


# ---------------------------------------------------------------- the norm


class MaskedBatchNormFunction(torch.autograd.Function):
    """y = ((x - mean) rstd scale + bias) * mask with batch statistics of
    the valid rows; returns (y in x's dtype, n, mean, var), the last three
    f32 and not differentiable (they feed the running update)."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, eps):
        C = x.shape[1]
        sums = masked_channel_sums(x, mask)
        n = torch.clamp(sums[0], min=1.0)
        mean = sums[1:1 + C] / n
        var_raw = sums[1 + C:] / n - mean * mean
        var = torch.clamp(var_raw, min=0.0)
        rstd = torch.rsqrt(var + eps)
        g = rstd * scale
        m = mask[:, None].float()
        y = ((x.float() * g + (bias - mean * g)) * m).to(x.dtype)
        ctx.save_for_backward(x, mask, scale, n, mean, rstd, var_raw > 0)
        ctx.mark_non_differentiable(n, mean, var)
        return y, n, mean, var

    @staticmethod
    def backward(ctx, dy, _dn, _dmean, _dvar):
        x, mask, scale, n, mean, rstd, var_live = ctx.saved_tensors
        C = x.shape[1]
        dy = dy.to(x.dtype).contiguous()
        sums = masked_channel_sums(dy, mask, x, mean)
        sdy = sums[1:1 + C]                    # sum_m dY
        sdyxh = sums[1 + C:] * rstd            # sum_m dY * xhat
        # a clamped variance passes no gradient (jnp.maximum(var, 0))
        coef = torch.where(var_live, sdyxh / n, torch.zeros_like(sdyxh))
        xhat = (x.float() - mean) * rstd
        m = mask[:, None].float()
        dx = (scale * rstd) * (dy.float() - sdy / n - xhat * coef) * m
        return dx.to(x.dtype), None, sdyxh, sdy, None


def masked_batch_norm(x, mask, scale, bias, running_mean, running_var, *,
                      momentum: float = 0.05, eps: float = 1e-5):
    """Train-mode masked BN: x [M, C] (bf16 on the card, bf16 or f32 on
    the CPU), mask [M] bool, scale /
    bias [C] f32 parameters. Returns y [M, C] in x's dtype, zero at invalid
    rows, and updates `running_mean` / `running_var` in place with
    (1 - momentum) run + momentum batch (unbiased var, as norm.py:60-64)."""
    y, n, mean, var = MaskedBatchNormFunction.apply(x, mask, scale, bias, eps)
    with torch.no_grad():
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
    return y
