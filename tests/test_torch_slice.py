"""The slice end to end: the port's test protocol on one synthetic pair
against a composition of the JAX package's public functions
(preprocess_clouds -> apply_unet -> subset -> sc2_pcr_estimator ->
rte / rre_deg), at a small spec and small capacities, in f32.

Both sides take the same subset indices, computed once from one numpy noise
draw. Compared: the voxel masks (exactly), the features (atol 1e-4) and
T_est (1e-4 m, 1e-3 deg).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.config import Config, build_parser
from eyoc_tpu.data.datasets import SyntheticPairDataset
from eyoc_tpu.geometry.metrics import rre_deg, rte
from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.registration.sc2pcr import SC2PCRConfig as JSC2
from eyoc_tpu.registration.sc2pcr import sc2_pcr_estimator
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.sparse.norm import BatchNormState
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.data.synthetic import SyntheticPairs, collate_items
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig


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


N_POINTS = 8192
CAPS = (4096, 1536, 512, 256)
BITS = (9, 9, 7)
N_SUB = 512
NARROW = dict(channels=(8, 16, 16, 16), tr_channels=(8, 8, 8, 16))


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def jax_config():
    cfg = Config(vars(build_parser().parse_args([])))
    cfg.update(dict(voxel_size=0.3, pair_min_dist=1, pair_max_dist=5))
    return cfg


def rotation_gap_deg(Ta, Tb):
    """Small angle between two rotations from the skew part of Raᵀ Rb, in
    float64 (the trace form, arccos((tr - 1) / 2), is quantized at ~0.01
    deg near zero by the matrices' own f32 rounding)."""
    R = np.asarray(Ta, np.float64)[:3, :3].T @ np.asarray(Tb, np.float64)[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0)))


def centered_bn(bn, rng):
    """Random BN statistics around the identity (mean ~ N(0, 0.1), var in
    [0.5, 1.5]): features stay discriminative, so the registration is well
    posed and f32 rounding is not amplified by a degenerate IRLS."""
    return jax.tree_util.tree_map(
        lambda s: BatchNormState(
            rng.normal(0, 0.1, s.mean.shape).astype(np.float32),
            rng.uniform(0.5, 1.5, s.var.shape).astype(np.float32)),
        bn, is_leaf=lambda x: isinstance(x, BatchNormState))


def test_synthetic_pair_is_bit_identical_to_jax_dataset():
    port = SyntheticPairs(n_pairs=2, n_points=4096, dist=6.0)[1]
    ref = SyntheticPairDataset("test", jax_config(), random_rotation=False,
                               random_scale=False, n_pairs=2, n_points=4096,
                               dist=6.0)[1]
    for key in ("xyz0", "xyz1", "T_gt", "frame_distance", "search_radius"):
        assert np.array_equal(np.asarray(port[key]), np.asarray(ref[key])), key


def test_test_protocol_matches_jax_composition():
    batch = collate_items([SyntheticPairs(n_pairs=1, n_points=N_POINTS,
                                          dist=4.0)[0]], N_POINTS)
    js = JSpec("narrow", "BN", "BN", **NARROW)
    # one jit per JAX stage: eager, JAX compiles every op apart
    params, bn = jax.jit(lambda key: jinit(js, key, 1, 32, 5))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, params)
    bn = centered_bn(bn, rng)

    # ---- JAX side: the package's public functions, composed
    prep = jax.jit(lambda xyz, n: jpreprocess(
        xyz, n, caps=CAPS, voxel_size=0.3, window_bits=BITS))
    fwd = jax.jit(lambda p, s, pyr: apply_unet(
        js, p, s, pyr, training=False, conv1_kernel_size=5, n_clouds=1)[0])
    feats, vox = [], []
    for xyz, n in ((batch.xyz0, batch.n0), (batch.xyz1, batch.n1)):
        v, pyr = prep(jnp.asarray(xyz.numpy()), jnp.asarray(n.numpy()))
        f = fwd(params, bn, pyr)
        feats.append(np.asarray(f))
        vox.append(v)
    masks = [np.asarray(v.mask[0]) for v in vox]
    noise = [np.where(m, rng.random(m.shape), 2.0).astype(np.float32)
             for m in masks]
    sel = [np.argsort(z, kind="stable")[:N_SUB] for z in noise]
    sub = []
    for v, f, s in zip(vox, feats, sel):
        sub += [np.asarray(v.xyz[0])[s], f[s], np.asarray(v.mask[0])[s]]
    cfg_j = JSC2(max_points=N_SUB, seed_cap=64)
    T_j = jax.jit(lambda *a: sc2_pcr_estimator(*a, cfg_j)[0])(
        *map(jnp.asarray, sub))
    T_gt = jnp.asarray(batch.T_gt[0].numpy())

    # ---- the port
    model = ResUNet(UNetSpec("narrow", "BN", "BN", **NARROW), 1, 32, 5,
                    dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn))
    cfg = teval.EvalConfig(caps=CAPS, voxel_size=0.3, window_bits=BITS,
                           eval_sample_points=N_SUB,
                           sc2=SC2PCRConfig(max_points=N_SUB, seed_cap=64))
    x0, f0, m0, x1, f1, m1 = teval.embed_pair(model, batch, cfg, device="cpu")
    assert np.array_equal(m0.numpy(), masks[0])
    assert np.array_equal(m1.numpy(), masks[1])
    assert masks[0].sum() > N_SUB and masks[1].sum() > N_SUB
    np.testing.assert_allclose(f0.numpy(), feats[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(f1.numpy(), feats[1], rtol=0, atol=1e-4)
    torch_noise = tuple(torch.from_numpy(z) for z in noise)
    out = teval.test_pair(model, batch, cfg, noise=torch_noise, device="cpu")
    T_t = jnp.asarray(out["T_est"].numpy())
    assert float(rte(T_j, T_t)) < 1e-4
    assert rotation_gap_deg(T_j, T_t) < 1e-3
    np.testing.assert_allclose(float(out["rte"]), float(rte(T_j, T_gt)),
                               atol=1e-4)
    np.testing.assert_allclose(float(out["rre"]), float(rre_deg(T_j, T_gt)),
                               atol=0.05)    # f32 arccos quantization


def test_random_subset_is_stable_argsort():
    rng = np.random.default_rng(1)
    noise = rng.random(300).astype(np.float32)
    noise[rng.random(300) < 0.3] = 2.0
    got = teval.random_subset(torch.from_numpy(noise), 250).numpy()
    assert np.array_equal(got, np.argsort(noise, kind="stable")[:250])
