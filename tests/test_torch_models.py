"""eyoc_tpu_torch.models against eyoc_tpu.models: JAX init_unet -> numpy
-> params_from_jax -> the port's eval forward, compared with JAX
apply_unet(training=False) in f32 (atol 1e-4 on the unit-norm features)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models import MODELS as JMODELS
from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.models import MODELS, ResUNet, UNetSpec, init_unet, load_model
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess

CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)
NARROW = dict(channels=(8, 16, 16, 16), tr_channels=(8, 8, 8, 16))


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def jax_init(js, seed, out_channels):
    """JAX init_unet under one jit (eager, it compiles every op apart)."""
    return jax.jit(lambda key: jinit(js, key, 1, out_channels, 5))(
        jax.random.PRNGKey(seed))


def jax_forward(js, params, bn, pyr, n_clouds):
    """JAX apply_unet(training=False) under one jit."""
    fwd = jax.jit(lambda p, s, y: apply_unet(
        js, p, s, y, training=False, conv1_kernel_size=5,
        n_clouds=n_clouds)[0])
    return fwd(params, bn, pyr)


def perturbed_params(spec_kw, seed, out_channels=16):
    """JAX init + non-trivial BN statistics and affines, as numpy trees."""
    js = JSpec(**{"name": "narrow", "norm_type": "BN",
                  "block_norm_type": "BN", **spec_kw})
    params, bn = jax_init(js, seed, out_channels)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(np.float32),
        params)
    bn = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), bn)
    return js, params, bn


@pytest.mark.parametrize("seed,B", [(0, 1), (2, 2)])
def test_forward_matches_jax(seed, B):
    js, params, bn = perturbed_params(NARROW, seed)
    rng = np.random.default_rng(100 + seed)
    xyz = rng.normal(0, 4, (B, 3000, 3)).astype(np.float32)
    counts = np.full(B, 3000, np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    want = jax_forward(js, params, bn, jpyr, B)
    model = ResUNet(UNetSpec("narrow", "BN", "BN", **NARROW), 1, 16, 5,
                    dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    got = model(tpyr).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    valid = tpyr.vox_masks[0].numpy()
    np.testing.assert_allclose(np.linalg.norm(got[valid], axis=1), 1.0,
                               atol=1e-5)
    assert not got[~valid].any()


def test_simplenet_forward_matches_jax():
    """The SimpleNet family: no residual blocks, pre-relu skips, a k=3
    conv1_tr followed by its own BN."""
    kw = dict(block_norm_type=None, channels=(8, 16, 16),
              tr_channels=(8, 8, 16), conv1_tr_kernel=3, conv1_tr_norm=True)
    js, params, bn = perturbed_params(kw, 4)
    xyz = np.random.default_rng(104).normal(0, 4, (1, 3000, 3)).astype(
        np.float32)
    counts = np.full(1, 3000, np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    want = jax_forward(js, params, bn, jpyr, 1)
    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    np.testing.assert_allclose(model(tpyr).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


def test_registry_full_width_builds_and_converts():
    spec = load_model("ResUNetBN2C")
    assert spec == UNetSpec(**vars(JMODELS["ResUNetBN2C"]))
    params, bn = jax_init(JMODELS["ResUNetBN2C"], 0, 32)
    params = jax.tree_util.tree_map(np.asarray, params)
    bn = jax.tree_util.tree_map(np.asarray, bn)
    model = ResUNet(spec, 1, 32, 5)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    assert model.conv1.weight.shape == (125, 1, 32)
    assert model.conv4_tr.weight.shape == (27, 256, 128)
    assert model.conv1_tr.weight.shape == (1, 32 + 64, 64)
    np.testing.assert_array_equal(model.block2.conv1.weight.detach().numpy(),
                                  params["block2"]["conv1"])


def test_registry_mirrors_jax():
    assert set(MODELS) == set(JMODELS)
    for name, spec in MODELS.items():
        assert vars(spec) == vars(JMODELS[name]), name


def test_init_unet_he_std():
    spec = load_model("ResUNetBN2C")
    model = init_unet(spec, torch.Generator().manual_seed(0), device="cpu")
    w = model.block3.conv1.weight.detach()
    np.testing.assert_allclose(float(w.std()), (2.0 / (27 * 128)) ** 0.5,
                               rtol=0.02)
    assert model.dtype == torch.bfloat16


def test_bf16_forward_close_to_f32():
    """The production dtype (bf16 between convs, f32 sums) on the CPU."""
    _, params, bn = perturbed_params(NARROW, 5)
    xyz = np.random.default_rng(5).normal(0, 4, (1, 3000, 3)).astype(np.float32)
    _, pyr = tpreprocess(torch.from_numpy(xyz), torch.tensor([3000]),
                         caps=CAPS, voxel_size=0.3, window_bits=BITS)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        model = ResUNet(UNetSpec("narrow", "BN", "BN", **NARROW), 1, 16, 5,
                        dtype=dtype)
        model.load_state_dict(params_from_jax(params, bn))
        out.append(model(pyr).numpy())
    assert np.isfinite(out[1]).all()
    assert np.abs(out[1] - out[0]).max() < 0.1


def test_non_foldable_spec_rejected():
    with pytest.raises(ValueError):
        ResUNet(load_model("ResUNetExpBN2C"))
