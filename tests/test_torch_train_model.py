"""The train-mode forward of eyoc_tpu_torch.models.ResUNet against
eyoc_tpu.models.apply_unet(training=True, n_clouds=2), on the CPU: a narrow
three-level BN ResUNet (every conv kind, both kinds of the decoder's skip
concat: into conv_up and into conv1_tr, 15 masked BNs) on
a two-cloud pyramid with jittered input features; then the same for the
instance-norm families: a narrow ResUNetIN-shaped net (7 BN top-level
norms, 10 per-cloud IN block norms) and a narrow SimpleNetIN-shaped one
(every norm IN, with SimpleNet's pre-ReLU skips and conv1_tr's norm). JAX
convs run in f32.

Compared: the features (atol 1e-5), the grads of a weighted sum of them
for every parameter against jax.grad (rtol 1e-3, atol 1e-5: a backward
through 15 norms in f32, summed in another order) and the new BN running
statistics (rtol 1e-5, atol 1e-6)"""

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
from eyoc_tpu_torch.models.unet import InstanceNorm
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


def check_train_forward(js, perturb=0.0):
    """The features, every parameter's grad and the BN running statistics
    of the port's train forward of spec `js` against apply_unet; with
    `perturb`, every parameter moved by that much noise first (a nonzero
    final bias: the JAX grad is NaN at a valid voxel whose feature is
    exactly zero, as a ReLU'd row of 8 channels can be)."""
    caps = (2048, 768, 256)
    params, bn = jax.jit(lambda k: jinit(js, k, 1, 16, 5))(
        jax.random.PRNGKey(3))
    if perturb:
        prng = np.random.default_rng(4)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + prng.normal(0, perturb, a.shape)
            .astype(np.float32), params)
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
    return model


def test_train_forward_and_grads_match_apply_unet():
    check_train_forward(JSpec("narrow", "BN", "BN", (8, 16, 16), (8, 8, 16)))


@pytest.mark.parametrize("js", [
    JSpec("narrow", "BN", "IN", (8, 16, 16), (8, 8, 16)),
    JSpec("narrow", "IN", None, (8, 16, 16), (8, 8, 16), conv1_tr_kernel=3,
          conv1_tr_norm=True)], ids=["ResUNetIN", "SimpleNetIN"])
def test_in_train_forward_and_grads_match_apply_unet(js):
    """The instance-norm families' train forward, held as the BN net above
    (the IN norms' state is None on both sides)."""
    model = check_train_forward(js, perturb=0.1)
    n_in = sum(isinstance(m, InstanceNorm) for m in model.modules())
    assert n_in == (10 if js.block_norm_type else 6)
