"""The train-mode forward and backward of a ResUNetBN2C with a first conv
of side 7 in the port against eyoc_tpu.models.apply_unet(training=True,
conv1_kernel_size=7) and jax.grad, on the CPU with JAX's convs in f32: a
narrow three-level BN net on a two-cloud pyramid with jittered input
features (alone in its file: a JAX step compile costs 12-25 s here).

Compared: the features (atol 1e-5) and the grad of a weighted sum of
them for every parameter (rtol 1e-3, atol 1e-5 times the largest of the
parameter's grads when that is above 1, as
tests/test_torch_expbn2c_train.py holds them: the f32 rounding of sums
taken in another order scales with the terms they add, and conv1's grads
reach ~120 here), conv1's [343, 1, C] grad
included: each output reads 216 of its 343 taps on both sides, and every
tap is read by the outputs of some cell of a brick, so the whole grad is
held. The new BN running statistics at rtol 1e-5, atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only wait on each other, and
    stall when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


BITS = (7, 7, 6)
CAPS = (2048, 768, 256)
K1 = 7
JS = JSpec("narrow7", "BN", "BN", (8, 16, 16), (8, 8, 16))


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def test_side7_train_forward_and_grads_match_apply_unet():
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, K1))(
        jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    xyz = rng.normal(0, 3, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2600], np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    M0 = 2 * CAPS[0]
    in_feats = (1.0 + 0.01 * rng.normal(size=(M0, 1))).astype(np.float32)
    w = rng.normal(size=(M0, 16)).astype(np.float32)

    def f(p):
        feats, s = apply_unet(JS, p, bn, jpyr, jnp.asarray(in_feats),
                              conv1_kernel_size=K1, training=True,
                              n_clouds=2)
        return jnp.sum(feats * w), (feats, s)

    (_, (jfeats, jstate)), jgrads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)

    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, K1, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    model.train()
    feats = model(tpyr, torch.from_numpy(in_feats))
    (feats * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats),
                               rtol=0, atol=1e-5)
    want = params_from_jax(np_tree(jgrads), np_tree(jstate))
    assert tuple(model.conv1.weight.grad.shape) == (343, 1, 8)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # conv1's grad reaches every tap: each is read by some output
    assert bool((model.conv1.weight.grad.abs().sum((1, 2)) > 0).all())
