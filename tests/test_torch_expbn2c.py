"""ResUNetExpBN2C (two (norm, block) repeats a level, reference
model/resunet.py:406-492) in the port against eyoc_tpu, on the CPU in f32.

- The registered spec builds, with the JAX parameter tree's names
  (norm{l}_{r}, block{l}_{r}: every key of params_from_jax of JAX's
  init_unet, and no other).
- The eval forward (`embed`: the top-level and block norms folded into
  their convs, each repeat norm K22's plain version from its running
  statistics) of a narrow spec of the same structure against
  apply_unet(training=False), which runs it unfolded (can_fold_bn is
  False): atol FEAT_ATOL on the unit-norm features, two clouds, perturbed
  parameters and running statistics; with normalize_feature=False, the
  raw features within FEAT_ATOL times their largest norm.
- The importer round trip: JAX's params_to_torch_state_dict -> a
  reference-style .pth -> the port's importer gives params_from_jax's state
  dict bit for bit, and its features are the eval forward's above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models import init_unet as jinit_full
from eyoc_tpu.models import load_model as jload
from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.models import ResUNet, UNetSpec, load_model
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.tools import import_torch_ckpt as T
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess
from test_import_torch import _save_reference_style

FEAT_ATOL = 1e-4          # f32, folded against unfolded norms
CAPS = (2048, 768, 256)
BITS = (7, 7, 6)
JS = JSpec("narrowExp", "BN", "BN", (8, 16, 16), (8, 8, 16), repeats=2)


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


def perturbed(js, seed, n_out=16):
    """JAX init, every parameter moved by N(0, 0.1), running statistics
    uniform in [0.5, 1.5], as numpy trees."""
    params, bn = jax.jit(lambda k: jinit(js, k, 1, n_out, 5))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(
            np.float32), params)
    bn = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), bn)
    return params, bn


def clouds(seed, B=2, n=3000):
    xyz = np.random.default_rng(seed).normal(0, 4, (B, n, 3)).astype(
        np.float32)
    counts = np.array([n - 300 * b for b in range(B)], np.int32)
    return xyz, counts


@pytest.fixture(scope="module")
def reference():
    """(params, bn, xyz, counts, raw features): JAX's eval forward of JS
    with normalize_feature=False, compiled once (the normalized features
    are raw / (|raw| + 1e-12), as unet.py:378)."""
    params, bn = perturbed(JS, 0)
    xyz, counts = clouds(1)
    _, pyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                         voxel_size=0.3, window_bits=BITS)
    fwd = jax.jit(lambda p, s, y: apply_unet(
        JS, p, s, y, training=False, conv1_kernel_size=5,
        normalize_feature=False, n_clouds=2)[0])
    return params, bn, xyz, counts, np.asarray(fwd(params, bn, pyr))


def normalized(f):
    return f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)


def port_eval(model, xyz, counts, normalize=None):
    vox, pyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                           caps=CAPS, voxel_size=0.3, window_bits=BITS)
    return model.embed(pyr, normalize_feature=normalize).numpy(), \
        vox.mask.reshape(-1).numpy()


def test_registered_spec_builds_with_the_jax_names():
    spec = jload("ResUNetExpBN2C")
    shapes = jax.eval_shape(lambda k: jinit_full(spec, k, 1, 32, 5),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = params_from_jax(*zeros)
    model = ResUNet(load_model("ResUNetExpBN2C"), 1, 32, 5,
                    dtype=torch.float32)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    assert "norm4_tr_2.running_var" in got and "block1_2.conv2.weight" in got


@pytest.mark.parametrize("normalize", [True, False])
def test_eval_forward_matches_apply_unet(reference, normalize):
    params, bn, xyz, counts, raw = reference
    want = normalized(raw) if normalize else raw
    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, 5, dtype=torch.float32,
                    normalize_feature=normalize)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    got, mask = port_eval(model, xyz, counts)
    assert mask.sum() > 1500
    scale = 1.0 if normalize else float(np.linalg.norm(want, axis=1).max())
    assert scale > 0
    np.testing.assert_allclose(got[mask], want[mask], rtol=0,
                               atol=FEAT_ATOL * scale)
    assert not got[~mask].any()
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got[mask], axis=1), 1.0,
                                   atol=1e-5)


def test_importer_round_trip(reference, tmp_path, monkeypatch):
    params, bn, xyz, counts, raw = reference
    path = _save_reference_style(tmp_path, params, bn, "ResUNetExpBN2C",
                                 16, 5)
    # the importer's template is the registry's spec: the narrow one here
    monkeypatch.setattr(T, "load_model", lambda name: UNetSpec(**vars(JS)))
    state, info = T.import_checkpoint(path)
    assert info["model"] == "ResUNetExpBN2C"
    want = params_from_jax(params, bn)
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    got, mask = port_eval(model, xyz, counts)
    np.testing.assert_allclose(got[mask], normalized(raw)[mask], rtol=0,
                               atol=FEAT_ATOL)
