"""The masked norms' backward (K21 `masked_norm_backward`) and the batch
norm's apply (K22 `masked_norm_apply`), plain versions, against the JAX
package on the CPU, in f32 on the same numpy inputs (numpy seeds stated in
`rows`).

The port's train-mode norms with their fused tails (`instance_norm_train`
over 3 clouds, `masked_batch_norm` over the whole batch) and torch
autograd through them (K21's plain version) against jax.vjp of
masked_instance_norm_fb / masked_batch_norm_fb followed by the same tail
in JAX (the rows of a cloud are its bricks' 8 cells each, in order): the
bare norm, the ReLU, the residual block's add, ReLU and mask, and
SimpleNet's pre-ReLU skip with a gradient on both outputs. Each case holds
a cloud with no valid row, one with a single valid row and a constant
channel (0 at every row, a dead channel: var_raw = 0, rstd = 1 / sqrt(eps);
at a nonzero constant XLA's dscale and dX are rounding noise times
(var + eps)^-1.5 ~ 3e7, the port's the exact 0), at C = 16 and
C = 512 (two of K21's channel slabs). Compared: the outputs (OUT_RTOL /
OUT_ATOL, plus 2^-22 |x g|: the apply x g + (bias - mean g) rounds at the
size of x g, which reaches |x| scale / sqrt(eps) where a segment's
variance is 0) and dX, dscale, dbias and dresidual (GRAD_RTOL / GRAD_ATOL:
f32 sums over ~1000 rows in another order and another algebra than XLA's
autodiff). K22's apply at S = 1 is the batch norm's output here.

K21's reformulation, `masked_norm_backward_chunked_plain` (each segment's
sums in K7's chunked order), against the plain version in f32 (the same
tolerance) and bf16 (dx within BF16_ULPS units in the last place, dres
bit-equal, dscale / dbias within GRAD_RTOL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse.norm import (BatchNormState, masked_batch_norm_fb,
                                  masked_instance_norm_fb)
from eyoc_tpu_torch.sparse import norm as N
from test_torch_instance_norm import ulps_apart

OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_ULPS = 1
TAILS = ["bare", "relu", "residual", "skip"]


def rows(S, cap, C, seed):
    """x [S cap, C] around per-channel offsets (channel 0 constant 0),
    mask (~70% valid; with S = 3, cloud 1 empty and cloud 2 a single valid
    row), scale, bias, residual (masked, >= 0), the output gradients dy and
    dpre."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1.5, (S * cap, C))
         + rng.normal(0, 2, C)).astype(np.float32)
    x[:, 0] = 0.0
    mask = rng.random(S * cap) < 0.7
    if S == 3:
        mask[cap:2 * cap] = False
        mask[2 * cap:] = False
        mask[2 * cap + cap // 3] = True
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    res = np.maximum(rng.normal(0, 1, (S * cap, C)), 0).astype(np.float32)
    res[~mask] = 0
    dy = rng.normal(0, 1, (S * cap, C)).astype(np.float32)
    dpre = rng.normal(0, 1, (S * cap, C)).astype(np.float32)
    return x, mask, scale, bias, res, dy, dpre


def jax_norm(kind, S, x, mask, scale, bias, res, tail):
    """The JAX norm (fb layout) and its tail as a function of (x, scale,
    bias, res): y, or (relu(y0), y0) with the skip."""
    M, C = x.shape
    occ8 = jnp.asarray(mask.reshape(M // 8, 8))
    bseg = jnp.asarray(np.arange(M // 8) // (M // S // 8), np.int32)
    m = jnp.asarray(mask, jnp.float32)[:, None]
    state = BatchNormState(jnp.zeros(C), jnp.ones(C))

    def f(x, scale, bias, res):
        fb = x.reshape(M // 8, 8 * C)
        if kind == "IN":
            y0 = masked_instance_norm_fb(fb, occ8, bseg, S, scale, bias)
        else:
            y0, _ = masked_batch_norm_fb(fb, occ8, scale, bias, state)
        y0 = y0.reshape(M, C)
        if tail == "relu":
            return jax.nn.relu(y0)
        if tail == "residual":
            return jax.nn.relu(y0 + res) * m
        if tail == "skip":
            return jax.nn.relu(y0), y0
        return y0
    return f


def port_norm(kind, S, x, mask, scale, bias, res, tail):
    kw = dict(relu=tail in ("relu", "skip"), skip=tail == "skip",
              residual=res if tail == "residual" else None)
    if kind == "IN":
        return N.instance_norm_train(x, mask, S, scale, bias, **kw)
    C = x.shape[1]
    return N.masked_batch_norm(x, mask, scale, bias, torch.zeros(C),
                               torch.ones(C), momentum=None, **kw)


@pytest.mark.parametrize("C", [16, 512])
@pytest.mark.parametrize("kind", ["IN", "BN"])
@pytest.mark.parametrize("tail", TAILS)
def test_norm_and_backward_match_jax_vjp(kind, tail, C):
    S, cap = 3, 512 if C == 16 else 64
    x, mask, scale, bias, res, dy, dpre = rows(S, cap, C, 20 + C)
    f = jax_norm(kind, S, x, mask, scale, bias, res, tail)
    want, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (x, scale, bias, res)))
    cot = (jnp.asarray(dy), jnp.asarray(dpre)) if tail == "skip" \
        else jnp.asarray(dy)
    wgrads = vjp(cot)

    t = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias, res)]
    got = port_norm(kind, S if kind == "IN" else 1, t[0],
                    torch.from_numpy(mask), *t[1:], tail)
    if tail == "skip":
        torch.autograd.backward(got, (torch.from_numpy(dy),
                                      torch.from_numpy(dpre)))
    else:
        got.backward(torch.from_numpy(dy))
    segs = S if kind == "IN" else 1
    _, stats = N.masked_instance_norm_plain(
        torch.from_numpy(x), torch.from_numpy(mask), segs,
        torch.from_numpy(scale), torch.from_numpy(bias), with_stats=True)
    xg = np.abs(x.reshape(segs, -1, C)
                * (stats[:, C:2 * C] * torch.from_numpy(scale)).numpy()
                [:, None]).reshape(x.shape)
    for g, w in zip(got if tail == "skip" else (got,),
                    want if tail == "skip" else (want,)):
        err = np.abs(g.detach().numpy() - np.asarray(w))
        assert (err <= OUT_RTOL * np.abs(np.asarray(w)) + OUT_ATOL
                + 2.0 ** -22 * xg).all(), float(err.max())
    for name, g, w in zip(("dx", "dscale", "dbias", "dresidual"), t, wgrads):
        if name == "dresidual" and tail != "residual":
            assert g.grad is None
            continue
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    dx = t[0].grad.numpy()
    assert not dx[~mask].any()                        # masked rows: no grad
    if kind == "IN":                                  # the single valid row
        assert not dx[2 * cap:].any()
        assert abs(t[1].grad[0]) <= GRAD_ATOL         # constant channel


def backward_case(S, cap, C, seed, tail, dtype):
    x, mask, scale, bias, res, dy, dpre = rows(S, cap, C, seed)
    xt = torch.from_numpy(x).to(dtype)
    mt = torch.from_numpy(mask)
    kw = dict(relu=tail in ("relu", "skip"), skip=tail == "skip",
              residual=torch.from_numpy(res).to(dtype)
              if tail == "residual" else None)
    out, stats = N.masked_instance_norm_plain(
        xt, mt, S, torch.from_numpy(scale), torch.from_numpy(bias),
        with_stats=True, **kw)
    y = out[0] if tail == "skip" else out
    return (xt, mt, S, torch.from_numpy(scale), stats,
            torch.from_numpy(dy).to(dtype),
            None if tail == "bare" else y,
            torch.from_numpy(dpre).to(dtype) if tail == "skip" else None,
            tail == "residual")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,cap,C", [(3, 1500, 64), (1, 3000, 32),
                                     (2, 200, 512)])
def test_chunked_reformulation_matches_plain(S, cap, C, dtype):
    assert N.k20_chunks(cap, C)[0] > 1 or C == 512
    for tail in TAILS:
        args = backward_case(S, cap, C, 7 + S, tail, dtype)
        got = N.masked_norm_backward_chunked_plain(*args)
        want = N.masked_norm_backward_plain(*args)
        dx, dres, ds, db = got
        assert dx.dtype == dtype and (dres is None) == (tail != "residual")
        if dtype == torch.float32:
            np.testing.assert_allclose(dx.numpy(), want[0].numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        else:
            assert ulps_apart(dx, want[0]) <= BF16_ULPS
        if dres is not None:
            assert torch.equal(dres, want[1])
        for g, w in ((ds, want[2]), (db, want[3])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)


def test_apply_at_one_segment_is_the_batch_norm_output():
    """K22's plain version at S = 1 with the batch statistics' g and off is
    masked_batch_norm_fb's output, and the per-segment form of K20's."""
    x, mask, scale, bias, res, _, _ = rows(1, 2048, 32, 3)
    C = 32
    occ8 = jnp.asarray(mask.reshape(-1, 8))
    want, _ = jax.jit(masked_batch_norm_fb)(
        jnp.asarray(x.reshape(-1, 8 * C)), occ8, jnp.asarray(scale),
        jnp.asarray(bias), BatchNormState(jnp.zeros(C), jnp.ones(C)))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    _, stats = N.masked_instance_norm_plain(
        xt, mt, 1, torch.from_numpy(scale), torch.from_numpy(bias),
        with_stats=True)
    g = stats[:, C:2 * C] * torch.from_numpy(scale)
    got = N.masked_norm_apply(
        xt, mt, torch.cat([g, torch.from_numpy(bias) - stats[:, :C] * g], 1))
    np.testing.assert_allclose(got.numpy().reshape(-1, 8 * C),
                               np.asarray(want), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    assert torch.equal(got, N.masked_instance_norm_plain(
        xt, mt, 1, torch.from_numpy(scale), torch.from_numpy(bias)))
