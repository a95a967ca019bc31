"""The train-mode forward of ResUNetExpBN2C's structure (two (norm, block)
repeats a level; the repeat norm takes batch statistics: K7's sums, K22's
apply, K21's backward) against eyoc_tpu's apply_unet(training=True,
n_clouds=2) on the CPU, JAX convs in f32, as
tests/test_torch_train_model.py holds the other families: a narrow
two-level spec of the same structure (18 BatchNorms: 3 level tails of a
norm, a block, a repeat norm and a second block), a two-cloud pyramid,
jittered input features.

Compared: the features (atol 1e-5), the grads of a weighted sum of them
for every parameter against jax.grad (rtol 1e-3, atol 1e-5 times the
largest of the parameter's grads when that is above 1: a backward through
18 norms in f32, summed in another order, whose rounding scales with the
terms it adds) and the new BN running statistics (rtol 1e-5, atol
1e-6)."""

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
from eyoc_tpu_torch.models.unet import BatchNorm
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess

BITS = (7, 7, 6)
CAPS = (2048, 768)
JS = JSpec("narrowExp", "BN", "BN", (8, 16), (8, 16), repeats=2)


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


@pytest.fixture(autouse=True, scope="module")
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def test_expbn2c_train_forward_and_grads_match_apply_unet():
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, 5))(
        jax.random.PRNGKey(5))
    # every parameter moved by N(0, 0.1): a nonzero final bias (JAX's grad
    # is NaN at a valid voxel whose feature is exactly zero)
    prng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + prng.normal(0, 0.1, a.shape).astype(
            np.float32), params)
    rng = np.random.default_rng(5)
    xyz = rng.normal(0, 4, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2700], np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    M0 = 2 * CAPS[0]
    in_feats = (1.0 + 0.01 * rng.normal(size=(M0, 1))).astype(np.float32)
    w = rng.normal(size=(M0, 16)).astype(np.float32)

    def f(p):
        feats, s = apply_unet(JS, p, bn, jpyr, jnp.asarray(in_feats),
                              conv1_kernel_size=5, training=True,
                              n_clouds=2)
        return jnp.sum(feats * w), (feats, s)

    (_, (jfeats, jstate)), jgrads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)

    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 18
    model.train()
    feats = model(tpyr, torch.from_numpy(in_feats))
    (feats * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats),
                               rtol=0, atol=1e-5)
    want = params_from_jax(np_tree(jgrads), np_tree(jstate))
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the repeat norms' running statistics moved
    assert not torch.equal(model.norm2_tr_2.running_var,
                           torch.from_numpy(np.asarray(bn["norm2_tr_2"].var)))
