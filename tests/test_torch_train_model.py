"""The train-mode forward of eyoc_tpu_torch.models.ResUNet against
eyoc_tpu.models.apply_unet(training=True), on the CPU: a narrow
three-level BN ResUNet (every conv kind, both kinds of the decoder's skip
concat: into conv_up and into conv1_tr, 15 masked BNs) on
a two-cloud pyramid with jittered input features. JAX convs run in f32.

Compared: the features (atol 1e-5), the grads of a weighted sum of them
for every parameter against jax.grad (rtol 1e-3, atol 1e-5: a backward
through 15 BNs in f32, summed in another order) and the new BN running
statistics (rtol 1e-5, atol 1e-6)."""

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

BITS = (7, 7, 6)


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def test_train_forward_and_grads_match_apply_unet():
    caps = (2048, 768, 256)
    js = JSpec("narrow", "BN", "BN", (8, 16, 16), (8, 8, 16))
    params, bn = jax.jit(lambda k: jinit(js, k, 1, 16, 5))(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 4, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2700], np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=caps,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=caps, voxel_size=0.3, window_bits=BITS)
    M0 = 2 * caps[0]
    in_feats = (1.0 + 0.01 * rng.normal(size=(M0, 1))).astype(np.float32)
    w = rng.normal(size=(M0, 16)).astype(np.float32)

    def f(p):
        feats, s = apply_unet(js, p, bn, jpyr, jnp.asarray(in_feats),
                              conv1_kernel_size=5, training=True,
                              n_clouds=2)
        return jnp.sum(feats * w), (feats, s)

    (_, (jfeats, jstate)), jgrads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)

    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    assert not model.training           # eval by default, as apply_unet
    model.train()
    feats = model(tpyr, torch.from_numpy(in_feats))
    (feats * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats),
                               rtol=0, atol=1e-5)
    want = params_from_jax(np_tree(jgrads), np_tree(jstate))
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
