"""Masked normalization over valid voxels (counterpart of
eyoc_tpu/sparse/norm.py): the train-mode batch norm
(masked_batch_norm / masked_batch_norm_fb, :30-116) and the per-cloud
instance norm of the instance-norm models' eval forward
(masked_instance_norm_fb, :119-148).

Semantics are the JAX package's, which match torch.nn.BatchNorm1d over the
valid rows only: statistics from the sums (n, s1, s2) of the rows a mask
keeps, n = max(n, 1), mean = s1 / n, var = max(s2 / n - mean^2, 0) (the
JAX formula, not Welford), normalisation with the biased var, running
update (1 - m) run + m batch with the unbiased var, output zero at
invalid rows. The sums are kernel K7 (`masked_channel_sums`) in the
forward and in the backward; the elementwise passes are plain torch.

The instance norm is kernel K20 (`masked_instance_norm`): per (cloud,
channel) the same formula over the cloud's valid rows, the affine, and
optionally the ReLU or the residual block's add, ReLU and mask that follow
it in the eval forward. Its backward (training an instance-norm model)
waits for a later slice (ROADMAP).
"""

from __future__ import annotations

import ctypes
import functools

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


# K7's reformulation, as plain torch: the CPU tests hold it against
# `masked_channel_sums_plain` and the JAX statistics; the main path never
# calls it (on the card the kernel computes it).

K7_THREADS = 256          # a block's threads (masked_channel_sums.cu)
K7_ROWS_IN_FLIGHT = 8     # rows a thread loads at once
K7_MAX_CHUNKS = 256       # chunks: eight for each lane of the final warp
K7_FINAL_VALUES = 32768   # chunks x (1 + 2C) partials, at most
K7_MAX_C = 256


@functools.lru_cache(maxsize=1024)
def k7_chunks(m: int, c: int):
    """(chunks, rows_per_chunk) of a K7 launch, from its shape: a block
    reads K7_THREADS / L rows at once, L = C/8 rounded up to a power of
    two; a chunk holds at least K7_ROWS_IN_FLIGHT such passes, and the
    partials the last block adds stay within K7_FINAL_VALUES."""
    lanes = 1
    while lanes < c // 8:
        lanes *= 2
    per_pass = K7_THREADS // lanes * K7_ROWS_IN_FLIGHT
    cap = max(1, min(K7_MAX_CHUNKS, K7_FINAL_VALUES // (1 + 2 * c)))
    chunks = max(1, min(cap, -(-m // per_pass)))
    rows = max(1, -(-m // chunks))
    return max(1, -(-m // rows)), rows


def masked_channel_sums_chunked_plain(x, mask, y=None, shift=None,
                                      plan=None):
    """K7's reduction order: chunk k of `k7_chunks` rows (or of `plan` =
    (chunks, rows)) gives its partial [n, sum x, sum x (y - shift)]; lane l
    of one warp adds chunks l, l + 32, ... in order, then an xor-shuffle
    tree over the 32 lanes (offsets 16, 8, 4, 2, 1) gives lane 0's sum, the
    output."""
    M, C = x.shape
    chunks, rows = plan or k7_chunks(M, C)
    parts = [masked_channel_sums_plain(x[k * rows:(k + 1) * rows],
                                       mask[k * rows:(k + 1) * rows], None
                                       if y is None else
                                       y[k * rows:(k + 1) * rows], shift)
             for k in range(chunks)]
    part = torch.stack(parts)                       # [chunks, 1 + 2C]
    lanes = part.new_zeros((32, 1 + 2 * C))
    for k in range(chunks):
        lanes[k % 32] = lanes[k % 32] + part[k]
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[lane ^ off]
    return lanes[0]


_K7_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p)
_K7_DTYPES = (torch.bfloat16, torch.bfloat16, torch.float32, torch.bool)


def masked_channel_sums(x, mask, y=None, shift=None):
    """K7: [1 + 2C] f32 = [n, sum_m x[:, c], sum_m x[:, c] (y[:, c] -
    shift[c])] over rows with mask. x, y [M, C], mask [M] bool, shift [C]
    f32 (only with y). A CPU tensor takes the plain version (any float
    dtype); a CUDA tensor launches the kernel, which takes bf16 x and y
    (the model's compute dtype on the card) with C a multiple of 8 up to
    256, or raises. One launch per call; the output is a view of the one
    buffer it allocates, which also holds the chunk partials."""
    if x.is_cpu:
        return masked_channel_sums_plain(x, mask, y, shift)
    fn = kernels.load("masked_channel_sums", _K7_ARGS)
    if shift is not None and y is None:
        raise ValueError("masked_channel_sums: a shift needs y")
    dev = kernels.require_cuda("masked_channel_sums", x, y, shift, mask,
                               dtypes=_K7_DTYPES)
    M, C = x.shape
    if mask.shape != (M,) or (y is not None and y.shape != x.shape) \
            or (shift is not None and shift.shape != (C,)):
        raise ValueError("masked_channel_sums: shapes")
    if C % 8 or C > K7_MAX_C:
        raise ValueError(f"masked_channel_sums: {C} channels, the kernel "
                         f"takes a multiple of 8 up to {K7_MAX_C}")
    chunks, rows = k7_chunks(M, C)
    W = 1 + 2 * C
    buf = x.new_empty(W * (chunks + 1), dtype=torch.float32)
    out = buf[:W]
    p = kernels.ptr
    err = fn(x.data_ptr(), p(y), p(shift), mask.data_ptr(), M, C, chunks,
             rows, buf.data_ptr() + 4 * W, kernels.ticket(dev).data_ptr(),
             out.data_ptr(), kernels.stream_handle(dev))
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
                      momentum: float | None = 0.05, eps: float = 1e-5):
    """Train-mode masked BN: x [M, C] (bf16 on the card, bf16 or f32 on
    the CPU), mask [M] bool, scale /
    bias [C] f32 parameters. Returns y [M, C] in x's dtype, zero at invalid
    rows, and updates `running_mean` / `running_var` in place with
    (1 - momentum) run + momentum batch (unbiased var, as norm.py:60-64);
    momentum None leaves them as they are (JAX discarding the new state,
    as the EYOC labeler's forwards do)."""
    y, n, mean, var = MaskedBatchNormFunction.apply(x, mask, scale, bias, eps)
    if momentum is None:
        return y
    with torch.no_grad():
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
    return y


# ---------------------------------------------------------------- kernel K20


def _segment_affine(n, s1, s2, scale, bias, eps):
    """(g, off) [B, C] of sums n [B], s1 / s2 [B, C]: n = max(n, 1), mean =
    s1 / n, var = max(s2 / n - mean^2, 0) (norm.py:135-143)."""
    n = torch.clamp(n, min=1.0)[:, None]
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    g = torch.rsqrt(var + eps) * scale
    return g, bias - mean * g


def _instance_apply(x, mask, g, off, relu, residual, skip):
    """y0 = ((x g + off) * mask) in x's dtype with each row's cloud's g and
    off [B, C]; then relu(y0), or with a residual relu(y0 + residual) *
    mask, in x's dtype; (y, y0) when `skip`."""
    B = g.shape[0]
    M, C = x.shape
    m = mask.float().reshape(B, M // B, 1)
    xf = x.float().reshape(B, M // B, C)
    y0 = ((xf * g[:, None] + off[:, None]) * m).reshape(M, C).to(x.dtype)
    y = y0
    if residual is not None:
        y = (torch.relu(y0.float() + residual.float())
             * m.reshape(M, 1)).to(x.dtype)
    elif relu:
        y = torch.relu(y0)
    return (y, y0) if skip else y


def masked_instance_norm_plain(x, mask, n_segments: int, scale, bias, *,
                               eps: float = 1e-5, relu: bool = False,
                               residual=None, skip: bool = False):
    """Plain PyTorch version of K20: x [M, C] whose rows are n_segments
    clouds of M / n_segments rows each, mask [M] bool, scale / bias [C]
    f32. Per (cloud, channel) over the masked rows, in f32: n = max(count,
    1), mean = sum x / n, var = max(sum x^2 / n - mean^2, 0), g = rsqrt(var
    + eps) scale, off = bias - mean g; then `_instance_apply`."""
    B = n_segments
    M, C = x.shape
    m = mask.float().reshape(B, M // B, 1)
    xf = x.float().reshape(B, M // B, C)
    g, off = _segment_affine(m.sum((1, 2)), (xf * m).sum(1),
                             (xf * xf * m).sum(1), scale.float(),
                             bias.float(), eps)
    return _instance_apply(x, mask, g, off, relu, residual, skip)


# K20's reformulation, as plain torch: the CPU tests hold it against
# `masked_instance_norm_plain` and the JAX norm; the main path never calls
# it (on the card the kernel computes it).

K20_MAX_C = 512          # channels: two slabs of K7_MAX_C a block
K20_SLAB = K7_MAX_C


def k20_chunks(cap: int, c: int):
    """(chunks, rows_per_chunk) of a cloud's `cap` rows in K20's statistics:
    K7's chunks for a slab of min(C, 256) channels."""
    return k7_chunks(cap, min(c, K20_SLAB))


def masked_instance_norm_chunked_plain(x, mask, n_segments: int, scale,
                                       bias, *, eps: float = 1e-5,
                                       relu: bool = False, residual=None,
                                       skip: bool = False):
    """K20's order: each cloud's sums in K7's chunked order over its rows
    (`k20_chunks`), then g = (1 / sqrt(var + eps)) scale and off = bias -
    mean g, then the same apply."""
    B = n_segments
    M, C = x.shape
    cap = M // B
    plan = k20_chunks(cap, C)
    sums = torch.stack([masked_channel_sums_chunked_plain(
        x[s * cap:(s + 1) * cap], mask[s * cap:(s + 1) * cap], plan=plan)
        for s in range(B)])
    n = torch.clamp(sums[:, 0], min=1.0)[:, None]
    mean = sums[:, 1:1 + C] / n
    var = torch.clamp(sums[:, 1 + C:] / n - mean * mean, min=0.0)
    g = 1.0 / torch.sqrt(var + eps) * scale.float()
    off = bias.float() - mean * g
    return _instance_apply(x, mask, g, off, relu, residual, skip)


_K20_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_float, ctypes.c_void_p)
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 6)


def masked_instance_norm(x, mask, n_segments: int, scale, bias, *,
                         eps: float = 1e-5, relu: bool = False,
                         residual=None, skip: bool = False):
    """K20: `masked_instance_norm_plain`. x [M, C] (rows of n_segments clouds
    of M / n_segments rows each), mask [M] bool, scale / bias [C] f32,
    residual [M, C]. Returns y [M, C] in x's dtype, or (y, y0) with the
    norm's output before the ReLU when `skip`.

    A CPU tensor takes the plain version (any float dtype); a CUDA tensor
    launches the kernel, which takes bf16 x and residual with C a multiple
    of 8 up to 512, or raises. Two launches a call (the statistics, whose
    last block a cloud makes its g and off, then the apply), counted once."""
    if x.is_cpu:
        return masked_instance_norm_plain(x, mask, n_segments, scale, bias,
                                          eps=eps, relu=relu,
                                          residual=residual, skip=skip)
    return _launch_k20(x, mask, n_segments, scale, bias, eps, relu,
                       residual, skip)


def _k20_scratch(n: int, x):
    """K20's f32 scratch: the chunk partials, then the clouds' g and off."""
    return x.new_empty(n, dtype=torch.float32)


def _launch_k20(x, mask, n_segments, scale, bias, eps, relu, residual, skip):
    fn = kernels.load("instance_norm", _K20_ARGS,
                      symbol="masked_instance_norm")
    bf16, f32 = torch.bfloat16, torch.float32
    dev = kernels.require_cuda("masked_instance_norm", x, mask, scale, bias,
                               residual,
                               dtypes=(bf16, torch.bool, f32, f32, bf16))
    M, C = x.shape
    B = n_segments
    if B < 1 or M % B or mask.shape != (M,) or scale.shape != (C,) \
            or bias.shape != (C,) \
            or (residual is not None and residual.shape != x.shape):
        raise ValueError("masked_instance_norm: shapes")
    if C % 8 or C > K20_MAX_C:
        raise ValueError(f"masked_instance_norm: {C} channels, the kernel "
                         f"takes a multiple of 8 up to {K20_MAX_C}")
    cap = M // B
    chunks, rows = k20_chunks(cap, C)
    W = 1 + 2 * C
    # one f32 buffer: the chunk partials [B, W, chunks], then g and off
    buf = _k20_scratch(B * (W * chunks + 2 * C), x)
    y = torch.empty_like(x)
    pre = torch.empty_like(x) if skip else None
    p = kernels.ptr
    err = fn(x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), eps, p(residual), B, cap, C, chunks, rows,
             int(relu), buf.data_ptr(), kernels.ticket(dev, B).data_ptr(),
             buf.data_ptr() + 4 * B * W * chunks, y.data_ptr(), p(pre),
             kernels.stream_handle(dev))
    kernels.check_launch("masked_instance_norm", err)
    return (y, pre) if skip else y
