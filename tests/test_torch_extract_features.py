"""api.extract_features with rgb and normals (eyoc_tpu/api.py:41-128;
reference util/misc.py:21-97) against eyoc_tpu.api.extract_features on the
CPU, the JAX convs in f32: a cloud of 2000 points with rgb (Ci = 3),
normals (Ci = 3) and both (Ci = 6: rgb - 0.5, then normal / 2, each voxel
taking its representative point's values), a narrow two-level BN spec with
conv1 k = 5 from JAX's init_unet; points equal, features within
FEAT_ATOL (unit-norm), and with normalize_feature=False within FEAT_ATOL
times their largest norm. The range and shape checks raise as JAX's do,
and a model whose input width differs from the channels given raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu import api as japi
from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu_torch import api
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax

FEAT_ATOL = 1e-4
JS = JSpec("narrow", "BN", None, (8, 16), (8, 16))
CAPS = (2048, 2048)
BITS = (8, 8, 7)


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


def cloud(seed, n=2000):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    return xyz, rgb, nrm


def models(cin, seed, normalize=True):
    params, bn = jax.jit(lambda k: jinit(JS, k, cin, 16, 5))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    bn = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), bn)
    model = ResUNet(UNetSpec(**vars(JS)), cin, 16, 5, dtype=torch.float32,
                    normalize_feature=normalize)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), bn), strict=True)
    return params, bn, model


@pytest.mark.parametrize("which", ["rgb", "normal", "both"])
def test_matches_jax(which):
    xyz, rgb, nrm = cloud(1)
    kw = dict(rgb=rgb if which != "normal" else None,
              normal=nrm if which != "rgb" else None)
    cin = 6 if which == "both" else 3
    normalize = which != "normal"
    params, bn, model = models(cin, 2 + cin, normalize)
    jpts, jf = japi.extract_features(
        params, bn, xyz, spec=JS, voxel_size=0.3, caps=CAPS,
        window_bits=BITS, normalize_feature=normalize, **kw)
    pts, f = api.extract_features(model, xyz, voxel_size=0.3, caps=CAPS,
                                  window_bits=BITS, device="cpu", **kw)
    assert f.shape == (jf.shape[0], 16) and jf.shape[0] > 1500
    np.testing.assert_array_equal(pts, jpts)
    scale = 1.0 if normalize else float(np.linalg.norm(jf, axis=1).max())
    np.testing.assert_allclose(f, jf, rtol=0, atol=FEAT_ATOL * scale)
    if not normalize:
        assert float(np.abs(np.linalg.norm(f, axis=1) - 1).max()) > 0.1


def test_checks_raise():
    xyz, rgb, nrm = cloud(2, 300)
    model = ResUNet(UNetSpec(**vars(JS)), 3, 16, 5, dtype=torch.float32)
    kw = dict(voxel_size=0.3, caps=CAPS, window_bits=BITS, device="cpu")
    with pytest.raises(ValueError, match=r"rgb must range in \[0, 1\]"):
        api.extract_features(model, xyz, rgb=rgb + 1.0, **kw)
    with pytest.raises(ValueError, match=r"normal must range in \[-1, 1\]"):
        api.extract_features(model, xyz, normal=2 * nrm, **kw)
    with pytest.raises(ValueError, match="rgb shape"):
        api.extract_features(model, xyz, rgb=rgb[:10], **kw)
    with pytest.raises(ValueError, match="input channels"):
        api.extract_features(model, xyz, rgb=rgb, normal=nrm, **kw)
    pts, f = api.extract_features("SimpleNetBNE", xyz, rgb=rgb,
                                  conv1_kernel_size=3, voxel_size=0.3,
                                  window_bits=BITS, device="cpu")
    assert f.shape == (pts.shape[0], 32) and np.isfinite(f).all()
