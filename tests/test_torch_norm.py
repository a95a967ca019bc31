"""eyoc_tpu_torch.sparse.norm (train-mode masked BatchNorm, plain version
of kernel K7) against eyoc_tpu.sparse.norm.masked_batch_norm_fb, on
voxel-layout features moved into the JAX brick layout with vox_to_fb.

Compared: the output (rtol 1e-5, atol 1e-5: f32 sums in another order),
the new running statistics (same), and the gradients of a weighted sum of
the output with respect to x, scale and bias against jax.grad (rtol 1e-4,
atol 1e-5). The port's x carries garbage at invalid rows, which the JAX
side never sees (vox_to_fb drops them): it must not reach any output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.sparse.norm import BatchNormState, masked_batch_norm_fb
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.sparse.norm import (masked_batch_norm,
                                        masked_channel_sums,
                                        masked_channel_sums_plain)
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess

CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(0)
    xyz = rng.normal(0, 4, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2500], np.int32)
    j = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                    voxel_size=0.3, window_bits=BITS)
    t = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                    caps=CAPS, voxel_size=0.3, window_bits=BITS)
    return j[1], t[1]


def jax_bn(level, x, w, scale, bias, mean, var, momentum):
    """(y_vox, new_state) and grads of sum(y_vox * w) wrt (x, scale, bias)."""
    C = x.shape[1]
    NB = level.bkeys.shape[0]
    occ8 = level.occ.reshape(NB, 8)
    state = BatchNormState(jnp.asarray(mean), jnp.asarray(var))

    def f(x, scale, bias):
        y, s = masked_batch_norm_fb(jbc.vox_to_fb(level, x), occ8, scale,
                                    bias, state, momentum=momentum)
        yv = jbc.fb_to_vox(level, y, C)
        return jnp.sum(yv * w), (yv, s)

    (_, (yv, s)), g = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return np.asarray(yv), s, [np.asarray(a) for a in g]


@pytest.mark.parametrize("level,C,offset", [(0, 8, 0.0), (1, 16, 3.0),
                                            (2, 4, -1.0)])
def test_masked_bn_matches_jax(pyramids, level, C, offset):
    jpyr, tpyr = pyramids
    mask = tpyr.vox_masks[level]
    M = mask.shape[0]
    rng = np.random.default_rng(level + C)
    x = (rng.normal(0, 2, (M, C)) + offset).astype(np.float32)
    x[~mask.numpy()] = 1e3                       # garbage the BN must ignore
    w = rng.normal(size=(M, C)).astype(np.float32)
    w[~mask.numpy()] = 0.0
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    x_j = np.where(mask.numpy()[:, None], x, 0.0).astype(np.float32)
    yj, sj, (gx, gs, gb) = jax_bn(jpyr.levels[level], x_j, w, scale, bias,
                                  mean0, var0, 0.05)

    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy())
    y = masked_batch_norm(tx, mask, ts, tb, rm, rv, momentum=0.05)
    (y * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), yj, rtol=1e-5, atol=1e-5)
    assert not y.detach().numpy()[~mask.numpy()].any()
    np.testing.assert_allclose(rm.numpy(), np.asarray(sj.mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), np.asarray(sj.var), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=1e-4, atol=1e-5)
    assert not tx.grad.numpy()[~mask.numpy()].any()
    np.testing.assert_allclose(ts.grad.numpy(), gs, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), gb, rtol=1e-4, atol=1e-5)


def test_channel_sums_layout_and_shift():
    """[n, sum x, sum x (y - shift)] over masked rows, in f64 by hand."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = rng.normal(size=(300, 5)).astype(np.float32)
    mask = rng.random(300) < 0.7
    shift = rng.normal(size=5).astype(np.float32)
    got = masked_channel_sums(torch.from_numpy(x), torch.from_numpy(mask),
                              torch.from_numpy(y), torch.from_numpy(shift))
    xm, ym = x[mask].astype(np.float64), y[mask].astype(np.float64)
    want = np.concatenate([[mask.sum()], xm.sum(0),
                           (xm * (ym - shift)).sum(0)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    plain = masked_channel_sums_plain(torch.from_numpy(x),
                                      torch.from_numpy(mask))
    np.testing.assert_allclose(
        plain.numpy()[6:], (xm * xm).sum(0), rtol=1e-5, atol=1e-4)


def test_bf16_in_bf16_out_and_empty_mask():
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(64, dtype=torch.bool)
    rm, rv = torch.zeros(4), torch.ones(4)
    y = masked_batch_norm(x.to(torch.bfloat16), mask, torch.ones(4),
                          torch.zeros(4), rm, rv)
    assert y.dtype == torch.bfloat16 and not y.float().any()
    # n clamps to 1 with nothing valid: the batch stats are 0, as in JAX
    np.testing.assert_allclose(rv.numpy(), 0.95, rtol=1e-6)
