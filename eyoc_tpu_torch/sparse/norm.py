"""Masked normalization over valid voxels (counterpart of
eyoc_tpu/sparse/norm.py): the train-mode batch norm
(masked_batch_norm / masked_batch_norm_fb, :30-116) and the per-cloud
instance norm of the instance-norm models (masked_instance_norm_fb,
:119-148), forward and backward.

Semantics are the JAX package's, which match torch.nn.BatchNorm1d over the
valid rows only: statistics from the sums (n, s1, s2) of the rows a mask
keeps, n = max(n, 1), mean = s1 / n, var = max(s2 / n - mean^2, 0) (the
JAX formula, not Welford), normalisation with the biased var, running
update (1 - m) run + m batch with the unbiased var, output zero at
invalid rows.

Kernels: K7 (`masked_channel_sums`) gives the batch norm's sums; K22
(`masked_norm_apply`) its apply; K20 (`masked_instance_norm`) the instance
norm per (cloud, channel), statistics and apply; K21
(`masked_norm_backward`) the backward of either, over S segments (the
clouds, or S = 1 for the batch norm). Each apply may go on with the ReLU,
or the residual block's add, ReLU and mask, or give the pre-ReLU output
too (SimpleNet's skip), and K21 takes the gradient back through that tail.
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


# ---------------------------------------------------------------- kernel K22


def _segment_stats(n, s1, s2, eps):
    """(stats, var) of sums n [S], s1 / s2 [S, C]: n = max(n, 1), mean =
    s1 / n, var_raw = s2 / n - mean^2, var = max(var_raw, 0) [S, C]
    (norm.py:104-107, :135-143); stats [S, 3C] f32 is (mean, rstd = rsqrt(
    var + eps), live = var_raw > 0 as 0 / 1), what the backward reads."""
    n = torch.clamp(n, min=1.0)[:, None]
    mean = s1 / n
    var_raw = s2 / n - mean * mean
    var = torch.clamp(var_raw, min=0.0)
    return torch.cat([mean, torch.rsqrt(var + eps), (var_raw > 0).float()],
                     dim=1), var


def masked_norm_apply_plain(x, mask, gof, relu=False, residual=None,
                            skip=False):
    """Plain PyTorch version of K22: y0 = ((x g + off) * mask) in x's dtype
    with each row's segment's g and off, gof [S, 2C] = (g, off) (the rows
    of segment s are [s M / S, (s + 1) M / S)); then relu(y0), or with a
    residual relu(y0 + residual) * mask, in x's dtype; (y, y0) when
    `skip`."""
    S = gof.shape[0]
    M, C = x.shape
    m = mask.float().reshape(S, M // S, 1)
    xf = x.float().reshape(S, M // S, C)
    g, off = gof[:, None, :C], gof[:, None, C:]
    y0 = ((xf * g + off) * m).reshape(M, C).to(x.dtype)
    y = y0
    if residual is not None:
        y = (torch.relu(y0.float() + residual.float())
             * m.reshape(M, 1)).to(x.dtype)
    elif relu:
        y = torch.relu(y0)
    return (y, y0) if skip else y


_K22_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p,) * 3)


def masked_norm_apply(x, mask, gof, *, relu: bool = False, residual=None,
                      skip: bool = False):
    """K22: `masked_norm_apply_plain`, the apply of a masked norm with its
    fused tail. x [M, C], mask [M] bool, gof [S, 2C] f32 (each segment's g,
    then off; S segments of M / S rows, the batch norm's S = 1), residual
    [M, C]. Returns y [M, C] in x's dtype, or (y, y0) when `skip`.

    A CPU tensor takes the plain version (any float dtype); a CUDA tensor
    launches the kernel (K20's apply), which takes bf16 x and residual with
    C a multiple of 8 up to 512, or raises. One launch a call."""
    if x.is_cpu:
        return masked_norm_apply_plain(x, mask, gof, relu, residual, skip)
    return _launch_k22(x, mask, gof, relu, residual, skip)


def _launch_k22(x, mask, gof, relu, residual, skip):
    fn = kernels.load("instance_norm", _K22_ARGS, symbol="masked_norm_apply")
    bf16, f32 = torch.bfloat16, torch.float32
    dev = kernels.require_cuda("masked_norm_apply", x, mask, gof, residual,
                               dtypes=(bf16, torch.bool, f32, bf16))
    M, C = x.shape
    S = gof.shape[0]
    if S < 1 or M % S or mask.shape != (M,) or gof.shape != (S, 2 * C) \
            or (residual is not None and residual.shape != x.shape):
        raise ValueError("masked_norm_apply: shapes")
    if C % 8 or C > K20_MAX_C:
        raise ValueError(f"masked_norm_apply: {C} channels, the kernel "
                         f"takes a multiple of 8 up to {K20_MAX_C}")
    y = torch.empty_like(x)
    pre = torch.empty_like(x) if skip else None
    p = kernels.ptr
    err = fn(x.data_ptr(), mask.data_ptr(), gof.data_ptr(), p(residual), S,
             M // S, C, int(relu), y.data_ptr(), p(pre),
             kernels.stream_handle(dev))
    kernels.check_launch("masked_norm_apply", err)
    return (y, pre) if skip else y


# ---------------------------------------------------------------- kernel K21


def _grad_at_norm(dy, y, dpre, dtype):
    """dy0 f32: dy, zero where y <= 0 (y given: a ReLU or residual tail),
    plus dpre rounded to `dtype` (the two cotangents of one tensor)."""
    d = dy.float()
    if y is not None:
        d = torch.where(y > 0, d, torch.zeros_like(d))
    if dpre is not None:
        d = (d + dpre.float()).to(dtype).float()
    return d


def _backward_finish(x, mask, n_segments, scale, stats, d, sums, residual):
    """K21's coefficients and dX from the segments' sums [S, 1 + 2C] = (n,
    sum dy0, sum dy0 (x - mean)) over their masked rows."""
    S = n_segments
    M, C = x.shape
    n = torch.clamp(sums[:, :1], min=1.0)
    sdy, sdyxc = sums[:, 1:1 + C], sums[:, 1 + C:]
    mean, rstd, live = stats.reshape(S, 3, C).unbind(1)
    sdyxh = sdyxc * rstd
    # a clamped variance passes no gradient (jnp.maximum(var, 0))
    coef = torch.where(live != 0, sdyxh / n, torch.zeros_like(sdyxh))
    a, b = scale.float() * rstd, sdy / n
    m = mask.float().reshape(S, M // S, 1)
    dm = d.reshape(S, M // S, C) * m
    xhat = (x.float().reshape(S, M // S, C) - mean[:, None]) * rstd[:, None]
    dx = (a[:, None] * ((dm - b[:, None]) - xhat * coef[:, None])) * m
    dscale, dbias = sdyxh[0], sdy[0]
    for s in range(1, S):                 # the segments added in order
        dscale, dbias = dscale + sdyxh[s], dbias + sdy[s]
    dres = dm.reshape(M, C).to(x.dtype) if residual else None
    return dx.reshape(M, C).to(x.dtype), dres, dscale, dbias


def masked_norm_backward_plain(x, mask, n_segments: int, scale, stats, dy,
                               y=None, dpre=None, residual: bool = False):
    """Plain PyTorch version of K21, the backward of a masked norm and its
    tail: x [M, C] the norm's input (S = n_segments segments of M / S rows),
    mask [M] bool, scale [C], stats [S, 3C] f32 (each segment's mean, rstd
    and var_raw > 0 as 0 / 1, from the forward), dy [M, C] the gradient at
    the output y (given with a ReLU or residual tail), dpre the gradient at
    the pre-ReLU output (SimpleNet's skip) or None. dy0 = dy (y > 0) + dpre
    at the masked rows; per segment sdy = sum dy0, sdyxh = sum dy0 xhat;
    dx = scale rstd (dy0 - sdy / n - xhat coef) * mask, coef = sdyxh / n
    where the variance was live, else 0. Returns (dx in x's dtype,
    dresidual = dy0 in x's dtype when `residual` else None, dscale [C],
    dbias [C]), the last two the segments' sdyxh and sdy added in order."""
    S = n_segments
    M, C = x.shape
    d = _grad_at_norm(dy, y, dpre, x.dtype)
    m = mask.float().reshape(S, M // S, 1)
    dm = d.reshape(S, M // S, C) * m
    xc = x.float().reshape(S, M // S, C) - stats.reshape(S, 3, C)[:, 0, None]
    sums = torch.cat([m.sum((1, 2))[:, None], dm.sum(1),
                      (d.reshape(S, M // S, C) * xc * m).sum(1)], dim=1)
    return _backward_finish(x, mask, S, scale, stats, d, sums, residual)


def masked_norm_backward_chunked_plain(x, mask, n_segments: int, scale,
                                       stats, dy, y=None, dpre=None,
                                       residual: bool = False):
    """K21's order: each segment's sums in K7's chunked order over its rows
    (`k20_chunks`, `masked_channel_sums_chunked_plain` of dy0 with y = x
    and shift = the segment's mean), then the same coefficients and dX."""
    S = n_segments
    M, C = x.shape
    cap = M // S
    plan = k20_chunks(cap, C)
    d = _grad_at_norm(dy, y, dpre, x.dtype)
    mean = stats.reshape(S, 3, C)[:, 0]
    sums = torch.stack([masked_channel_sums_chunked_plain(
        d[s * cap:(s + 1) * cap], mask[s * cap:(s + 1) * cap],
        x[s * cap:(s + 1) * cap], mean[s], plan=plan) for s in range(S)])
    return _backward_finish(x, mask, S, scale, stats, d, sums, residual)


_K21_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
             + (ctypes.c_void_p,) * 8)


def masked_norm_backward(x, mask, n_segments: int, scale, stats, dy, y=None,
                         dpre=None, residual: bool = False, *,
                         counter: str = "masked_norm_backward"):
    """K21: `masked_norm_backward_plain`. `counter` names the launch count
    it adds to: "masked_norm_backward" for the instance norm's backward,
    "masked_norm_backward_bn" for the batch norm's (S = 1).

    A CPU tensor takes the plain version (any float dtype); a CUDA tensor
    launches the kernel, which takes bf16 x, dy, y and dpre with C a
    multiple of 8 up to 512, or raises. Two launches a call (the sums,
    whose last block a segment makes its coefficients, then dX), counted
    once."""
    if x.is_cpu:
        return masked_norm_backward_plain(x, mask, n_segments, scale, stats,
                                          dy, y, dpre, residual)
    return _launch_k21(x, mask, n_segments, scale, stats, dy, y, dpre,
                       residual, counter)


def _launch_k21(x, mask, n_segments, scale, stats, dy, y, dpre, residual,
                counter):
    fn = kernels.load("norm_backward", _K21_ARGS,
                      symbol="masked_norm_backward")
    bf16, f32 = torch.bfloat16, torch.float32
    dev = kernels.require_cuda(counter, x, dy, y, dpre, mask, scale, stats,
                               dtypes=(bf16, bf16, bf16, bf16, torch.bool,
                                       f32, f32))
    M, C = x.shape
    S = n_segments
    if S < 1 or M % S or mask.shape != (M,) or scale.shape != (C,) \
            or stats.shape != (S, 3 * C) or dy.shape != x.shape \
            or any(t is not None and t.shape != x.shape for t in (y, dpre)):
        raise ValueError("masked_norm_backward: shapes")
    if C % 8 or C > K20_MAX_C:
        raise ValueError(f"masked_norm_backward: {C} channels, the kernel "
                         f"takes a multiple of 8 up to {K20_MAX_C}")
    cap = M // S
    chunks, rows = k20_chunks(cap, C)
    W = 1 + 2 * C
    # one f32 buffer: the chunk partials [S, W, chunks], then the
    # coefficients [S, 5C], then dscale and dbias
    buf = _k21_scratch(S * (W * chunks + 5 * C) + 2 * C, x)
    coefs = buf[S * W * chunks:]
    grads = buf[S * (W * chunks + 5 * C):]
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else None
    p = kernels.ptr
    err = fn(x.data_ptr(), dy.data_ptr(), p(y), p(dpre), mask.data_ptr(),
             scale.data_ptr(), stats.data_ptr(), S, cap, C, chunks, rows,
             buf.data_ptr(), kernels.ticket(dev, S).data_ptr(),
             coefs.data_ptr(), dx.data_ptr(), p(dres), grads.data_ptr(),
             grads.data_ptr() + 4 * C, kernels.stream_handle(dev))
    kernels.check_launch(counter, err)
    return dx, dres, grads[:C], grads[C:]


def _k21_scratch(n: int, x):
    """K21's f32 scratch: the chunk partials, the coefficients, the
    parameter grads."""
    return x.new_empty(n, dtype=torch.float32)


# ---------------------------------------------------------------- the norms


def _save_for_norm_backward(ctx, x, mask, scale, stats, out, n_segments,
                            relu, residual, skip, counter):
    y = out[0] if skip else out
    ctx.save_for_backward(x, mask, scale, stats,
                          y if relu or residual is not None else None)
    ctx.n_segments, ctx.residual, ctx.counter = (n_segments,
                                                 residual is not None,
                                                 counter)
    ctx.set_materialize_grads(False)


def _norm_backward(ctx, dy, dpre=None):
    """dX, dscale, dbias and dresidual of a norm with its tail: K21."""
    x, mask, scale, stats, y = ctx.saved_tensors
    dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
    if dpre is not None:
        dpre = dpre.to(x.dtype).contiguous()
    dx, dres, dscale, dbias = masked_norm_backward(
        x, mask, ctx.n_segments, scale, stats, dy, y, dpre, ctx.residual,
        counter=ctx.counter)
    return dx, None, dscale, dbias, dres


class MaskedBatchNormFunction(torch.autograd.Function):
    """The batch norm's apply with its tail, given the batch statistics
    `stats` [1, 3C] (mean, rstd, live; `masked_batch_norm` makes them from
    K7's sums): K22 with g = rstd scale, off = bias - mean g; backward K21
    at S = 1. Returns y, or (y, y0) when `skip`."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, residual, stats, relu, skip):
        C = x.shape[1]
        g = stats[:, C:2 * C] * scale
        gof = torch.cat([g, bias - stats[:, :C] * g], dim=1)
        out = masked_norm_apply(x, mask, gof, relu=relu, residual=residual,
                                skip=skip)
        _save_for_norm_backward(ctx, x, mask, scale, stats, out, 1, relu,
                                residual, skip, "masked_norm_backward_bn")
        return out

    @staticmethod
    def backward(ctx, dy, dpre=None):
        return _norm_backward(ctx, dy, dpre) + (None, None, None)


class MaskedInstanceNormFunction(torch.autograd.Function):
    """The instance norm with its tail (K20, which also gives each cloud's
    statistics); backward K21 at S = the clouds. Returns y, or (y, y0)
    when `skip`."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, residual, n_segments, eps, relu,
                skip):
        out, stats = masked_instance_norm(
            x, mask, n_segments, scale, bias, eps=eps, relu=relu,
            residual=residual, skip=skip, with_stats=True)
        _save_for_norm_backward(ctx, x, mask, scale, stats, out, n_segments,
                                relu, residual, skip, "masked_norm_backward")
        return out

    @staticmethod
    def backward(ctx, dy, dpre=None):
        return _norm_backward(ctx, dy, dpre) + (None, None, None, None)


def masked_batch_norm(x, mask, scale, bias, running_mean, running_var, *,
                      momentum: float | None = 0.05, eps: float = 1e-5,
                      relu: bool = False, residual=None, skip: bool = False):
    """Train-mode masked BN: x [M, C] (bf16 on the card, bf16 or f32 on
    the CPU), mask [M] bool, scale / bias [C] f32 parameters, then the
    fused tail of `masked_norm_apply` (relu, residual, skip). Returns y
    [M, C] in x's dtype, zero at invalid rows (or (y, y0) when `skip`), and
    updates `running_mean` / `running_var` in place with (1 - momentum)
    run + momentum batch (unbiased var, as norm.py:60-64); momentum None
    leaves them as they are (JAX discarding the new state, as the EYOC
    labeler's forwards do). The statistics are K7's sums, the apply K22,
    the backward K21."""
    C = x.shape[1]
    with torch.no_grad():
        sums = masked_channel_sums(x, mask)
        stats, var = _segment_stats(sums[:1], sums[None, 1:1 + C],
                                    sums[None, 1 + C:], eps)
        if momentum is not None:
            n = torch.clamp(sums[0], min=1.0)
            unbiased = var[0] * n / torch.clamp(n - 1.0, min=1.0)
            running_mean.mul_(1.0 - momentum).add_(momentum * stats[0, :C])
            running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
    return MaskedBatchNormFunction.apply(x, mask, scale, bias, residual,
                                         stats, relu, skip)


def instance_norm_train(x, mask, n_segments: int, scale, bias, *,
                        eps: float = 1e-5, relu: bool = False, residual=None,
                        skip: bool = False):
    """The train forward's instance norm (`masked_instance_norm`, same
    arguments) with its backward, K21; with gradients off (the EYOC
    labeler's forwards) K20 alone."""
    if not torch.is_grad_enabled():
        return masked_instance_norm(x, mask, n_segments, scale, bias,
                                    eps=eps, relu=relu, residual=residual,
                                    skip=skip)
    return MaskedInstanceNormFunction.apply(x, mask, scale, bias, residual,
                                            n_segments, eps, relu, skip)


# ---------------------------------------------------------------- kernel K20


def masked_instance_norm_plain(x, mask, n_segments: int, scale, bias, *,
                               eps: float = 1e-5, relu: bool = False,
                               residual=None, skip: bool = False,
                               with_stats: bool = False):
    """Plain PyTorch version of K20: x [M, C] whose rows are n_segments
    clouds of M / n_segments rows each, mask [M] bool, scale / bias [C]
    f32. Per (cloud, channel) over the masked rows, in f32: n = max(count,
    1), mean = sum x / n, var = max(sum x^2 / n - mean^2, 0), g = rsqrt(var
    + eps) scale, off = bias - mean g; then `masked_norm_apply_plain`. With
    `with_stats`, (out, stats [B, 3C]: mean, rstd, var_raw > 0 as 0 / 1)."""
    B = n_segments
    M, C = x.shape
    m = mask.float().reshape(B, M // B, 1)
    xf = x.float().reshape(B, M // B, C)
    stats, _ = _segment_stats(m.sum((1, 2)), (xf * m).sum(1),
                              (xf * xf * m).sum(1), eps)
    g = stats[:, C:2 * C] * scale.float()
    gof = torch.cat([g, bias.float() - stats[:, :C] * g], dim=1)
    out = masked_norm_apply_plain(x, mask, gof, relu, residual, skip)
    return (out, stats) if with_stats else out


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
    gof = torch.cat([g, bias.float() - mean * g], dim=1)
    return masked_norm_apply_plain(x, mask, gof, relu, residual, skip)


_K20_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_float, ctypes.c_void_p)
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 7)


def masked_instance_norm(x, mask, n_segments: int, scale, bias, *,
                         eps: float = 1e-5, relu: bool = False,
                         residual=None, skip: bool = False,
                         with_stats: bool = False):
    """K20: `masked_instance_norm_plain`. x [M, C] (rows of n_segments clouds
    of M / n_segments rows each), mask [M] bool, scale / bias [C] f32,
    residual [M, C]. Returns y [M, C] in x's dtype, or (y, y0) with the
    norm's output before the ReLU when `skip`; with `with_stats` (the
    train forward), (that, stats [B, 3C] f32: each cloud's mean, rstd and
    var_raw > 0 as 0 / 1, for the backward).

    A CPU tensor takes the plain version (any float dtype); a CUDA tensor
    launches the kernel, which takes bf16 x and residual with C a multiple
    of 8 up to 512, or raises. Two launches a call (the statistics, whose
    last block a cloud makes its g and off, then the apply), counted once."""
    if x.is_cpu:
        return masked_instance_norm_plain(x, mask, n_segments, scale, bias,
                                          eps=eps, relu=relu,
                                          residual=residual, skip=skip,
                                          with_stats=with_stats)
    return _launch_k20(x, mask, n_segments, scale, bias, eps, relu,
                       residual, skip, with_stats)


def _k20_scratch(n: int, x):
    """K20's f32 scratch: the chunk partials, then the clouds' g and off."""
    return x.new_empty(n, dtype=torch.float32)


def _launch_k20(x, mask, n_segments, scale, bias, eps, relu, residual, skip,
                with_stats=False):
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
    stats = x.new_empty((B, 3 * C), dtype=torch.float32) if with_stats \
        else None
    y = torch.empty_like(x)
    pre = torch.empty_like(x) if skip else None
    p = kernels.ptr
    err = fn(x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), eps, p(residual), B, cap, C, chunks, rows,
             int(relu), buf.data_ptr(), kernels.ticket(dev, B).data_ptr(),
             buf.data_ptr() + 4 * B * W * chunks, p(stats), y.data_ptr(),
             p(pre), kernels.stream_handle(dev))
    kernels.check_launch("masked_instance_norm", err)
    out = (y, pre) if skip else y
    return (out, stats) if with_stats else out
