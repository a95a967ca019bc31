"""A ResUNetBN2C with a first conv of side 7 (FCGF's published 3DMatch
model's shape: `ResUNetBN2C(1, 32, normalize_feature=True,
conv1_kernel_size=7)`) in the port against eyoc_tpu, on the CPU in f32, at
narrow widths:

- the eval forward (`embed`, the norms folded into their convs) against
  apply_unet(conv1_kernel_size=7, training=False) on two clouds, weights
  perturbed and running statistics moved, carried across by
  models/convert.py: the unit-norm features within FEAT_ATOL;
- the importer round trip: an ME-style checkpoint (conv1.kernel [343, 1,
  C], config conv1_kernel_size 7) through the port's importer and JAX's
  gives the same parameters bit for bit (ME's tap order is both packages',
  so the kernel copies through), and the imported model gives the features
  above.
Both packages read 216 of each output's 343 taps (the taps within one
brick of its own); tests/test_torch_conv_side7.py holds the maps. The
clouds are N(0, 1.5 m), where a valid output reads 58 voxels on average
(the largest feature difference 3.3e-5). At N(0, 1 m), 101 voxels a row,
it is 1.4e-4, JAX's own rounding: its f32 forward lies 1.6e-4 from its
f64 forward there, the port's 1.8e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.tools import import_torch_ckpt as JT
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.tools import import_torch_ckpt as T
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess
from test_import_torch import _save_reference_style

FEAT_ATOL = 1e-4          # f32, folded against unfolded norms
CAPS = (2048, 768, 256)
BITS = (7, 7, 6)
K1 = 7
JS = JSpec("narrow7", "BN", "BN", (8, 16, 16), (8, 8, 16))


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


@pytest.fixture(scope="module")
def reference():
    """(params, bn, xyz, counts, features): JAX's side-7 eval forward of
    JS on two clouds, every parameter moved by N(0, 0.1) and the running
    statistics drawn from [0.5, 1.5], as numpy."""
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, K1))(
        jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(
            np.float32), params)
    bn = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), bn)
    xyz = rng.normal(0, 1.5, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2700], np.int32)
    _, pyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                         voxel_size=0.3, window_bits=BITS)
    fwd = jax.jit(lambda p, s, y: apply_unet(
        JS, p, s, y, training=False, conv1_kernel_size=K1, n_clouds=2)[0])
    return params, bn, xyz, counts, np.asarray(fwd(params, bn, pyr))


def port_features(model, xyz, counts):
    vox, pyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                           caps=CAPS, voxel_size=0.3, window_bits=BITS)
    return model.embed(pyr).numpy(), vox.mask.reshape(-1).numpy()


def check_features(model, reference):
    _, _, xyz, counts, want = reference
    got, mask = port_features(model, xyz, counts)
    assert mask.sum() > 1500
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=FEAT_ATOL)
    assert not got[~mask].any()
    np.testing.assert_allclose(np.linalg.norm(got[mask], axis=1), 1.0,
                               atol=1e-5)


def test_side7_eval_forward_matches_apply_unet(reference):
    params, bn = reference[:2]
    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, K1, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    assert tuple(model.conv1.weight.shape) == (343, 1, 8)
    check_features(model, reference)


def test_side7_importer_round_trip(reference, tmp_path, monkeypatch):
    params, bn = reference[:2]
    path = _save_reference_style(tmp_path, params, bn, "ResUNetBN2C", 16,
                                 K1)
    sd = torch.load(path, weights_only=False)["state_dict"]
    assert tuple(sd["conv1.kernel"].shape) == (343, 1, 8)
    # both importers' templates are the registry's spec: the narrow one
    # here; JAX's template trees (read for their shapes) are the
    # reference's, which its eager init would take ~10 s to draw again
    monkeypatch.setattr(T, "load_model", lambda name: UNetSpec(**vars(JS)))
    monkeypatch.setattr(JT, "load_model", lambda name: JS)
    monkeypatch.setattr(JT, "init_unet", lambda spec, key, ci, co, k:
                        (params, bn) if (spec, ci, co, k) == (JS, 1, 16, K1)
                        else None)
    state, info = T.import_checkpoint(path)
    jparams, jbn, jinfo = JT.import_checkpoint(path)
    assert info["conv1_kernel_size"] == jinfo["conv1_kernel_size"] == K1
    want = params_from_jax(jparams, jbn)
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    assert torch.equal(state["conv1.weight"],
                       torch.from_numpy(np.asarray(params["conv1"])))
    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, K1, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    check_features(model, reference)
