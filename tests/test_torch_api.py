"""eyoc_tpu_torch.api.extract_features against eyoc_tpu.api.extract_features:
the same numpy cloud and the same (converted) weights give the same
representative points (exactly) and descriptors (atol 1e-4, f32 convs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu import extract_features as jextract
from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu_torch import api
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax

NARROW = dict(channels=(8, 16, 16, 16), tr_channels=(8, 8, 8, 16))
CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def test_extract_features_matches_jax():
    js = JSpec("narrow", "BN", "BN", **NARROW)
    params, bn = jax.jit(lambda key: jinit(js, key, 1, 16, 5))(
        jax.random.PRNGKey(3))    # one compile; eager compiles op by op
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(np.asarray, params)
    bn = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), bn)
    xyz = rng.normal(0, 4, (2500, 3)).astype(np.float32)

    pts_j, feats_j = jextract(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, bn), xyz, spec=js,
        voxel_size=0.3, caps=CAPS, window_bits=BITS)
    model = ResUNet(UNetSpec("narrow", "BN", "BN", **NARROW), 1, 16, 5,
                    dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn))
    pts_t, feats_t = api.extract_features(model, xyz, voxel_size=0.3,
                                          caps=CAPS, window_bits=BITS,
                                          device="cpu")
    assert pts_t.shape[0] > 100
    np.testing.assert_array_equal(pts_t, pts_j)
    np.testing.assert_allclose(feats_t, feats_j, rtol=0, atol=1e-4)


def test_derive_caps_matches_jax():
    from eyoc_tpu.api import _derive_caps as jcaps
    for n in (10, 5000, 131072):
        assert api._derive_caps(n, 4) == jcaps(n, None, 4)
