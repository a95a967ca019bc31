"""`training.steps.label_pairs` (the EYOC labeling of a batch) against the
JAX `StepBuilder._label_one`, pair by pair, on the CPU, at a small size
(cap 512, num_corres 256, SC2-PCR max_points 512 and 64 seeds,
rediscovery_samples 256).

Each case labels a batch of two pairs: a well-posed pair (cloud 1 is
cloud 0 under a known pose, row for row and then shuffled, with features
near cloud 0's) and a pair with 30% inliers, at frame distances in two
Similarity buckets. The cases cover both feature filters, the three
spatial filters, SC2 filtering on and off and the translation gate on and
off. The port gets JAX's own rediscovery uniforms
(`jax.random.uniform(key_b, (cap,))`, steps.py:440). pos_i, pos_j and ok
are bit-equal; labeler_hit within 1e-6, T_est within atol 1e-4. One pair
is exempt from the pose and what follows it: under feature_filter "None"
the 30%-inlier pair hands SC2-PCR its worst matches, a degenerate set
whose IRLS pose is not unique (ROADMAP §3); there pos_i and labeler_hit
are still equal and both sides' poses miss the true one by over 1 m."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.ops.matching import load_similarity_tables as jtables
from eyoc_tpu.registration.sc2pcr import SC2PCRConfig as JSC2
from eyoc_tpu.training.steps import StepBuilder, StepConfig
from eyoc_tpu_torch.ops.matching import load_similarity_tables
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
from eyoc_tpu_torch.training.steps import TrainConfig, label_pairs

CAP, C = 512, 32
SMALL = dict(num_corres=256, rediscovery_samples=256)
FRAME_DISTANCES = (8, 23)          # Similarity buckets 1 and 4


def pair(rng, fd, inlier):
    """One pair: cloud 0 (450 valid rows), cloud 1 = T cloud 0 on the
    inlier rows (random elsewhere), shuffled; features of cloud 1 near
    cloud 0's on the inlier rows. T moves 0.9 fd along x."""
    nv = 450
    x0 = np.zeros((CAP, 3), np.float32)
    x0[:nv, :2] = rng.uniform(-60, 60, (nv, 2))
    x0[:nv, 2] = rng.uniform(-3, 3, nv)
    m0 = np.arange(CAP) < nv
    a = 0.15
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]], np.float32)
    Tg = np.eye(4, dtype=np.float32)
    Tg[:3, :3] = R
    Tg[:3, 3] = [0.9 * fd, 1.0, 0.1]
    x1 = (x0 @ R.T + Tg[:3, 3] + rng.normal(0, 0.02, x0.shape))
    f0 = rng.normal(size=(CAP, C))
    f1 = f0 + 0.25 * rng.normal(size=(CAP, C))
    out = rng.random(CAP) >= inlier
    x1[out, :2] = rng.uniform(-60, 60, (int(out.sum()), 2))
    f1[out] = rng.normal(size=(int(out.sum()), C))
    perm = rng.permutation(CAP)
    x1, f1, m1 = x1[perm], f1[perm], m0[perm]
    x1[~m1] = 0.0

    def unit(f, m):
        f = f / np.linalg.norm(f, axis=1, keepdims=True)
        return (f * m[:, None]).astype(np.float32)
    return (unit(f0, m0), m0, x0, unit(f1, m1), m1, x1.astype(np.float32),
            np.int32(fd), Tg)


def batch(seed):
    rng = np.random.default_rng(seed)
    pairs = [pair(rng, FRAME_DISTANCES[0], 1.0),
             pair(rng, FRAME_DISTANCES[1], 0.3)]
    return [np.stack(x) for x in zip(*pairs)]


CASES = [   # (feature_filter, spatial_filter, use_sc2_filtering, gate)
    ("None", "Similarity", True, 0.0),       # the published KITTI recipe
    ("Lowe", "Spherical", True, 0.0),        # the package defaults
    ("Lowe", "None", True, 0.4),
    ("None", "Spherical", False, 0.0),
    ("Lowe", "Similarity", False, 0.0),
    ("None", "None", True, 0.4),
    ("Lowe", "Similarity", True, 0.4),
    ("None", "Spherical", True, 0.4),
]


@functools.lru_cache(maxsize=None)
def jax_labeler(feature_filter, spatial_filter, use_sc2, gate):
    cfg = StepConfig(
        spec=JSpec("narrow", "BN", "BN", (8,), (8,)), caps=(CAP, 256),
        voxel_size=0.3, conv1_kernel_size=3, feature_filter=feature_filter,
        spatial_filter=spatial_filter, similarity_thresh=0.6,
        use_sc2_filtering=use_sc2, label_min_translation_frac=gate,
        sc2=JSC2(max_points=512, seed_cap=64), **SMALL)
    return jax.jit(StepBuilder(cfg, jtables("waymo"))._label_one)


@pytest.mark.parametrize("feature_filter,spatial_filter,use_sc2,gate", CASES)
def test_label_pairs_matches_label_one(feature_filter, spatial_filter,
                                       use_sc2, gate):
    f0, m0, x0, f1, m1, x1, fd, Tg = batch(0)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    noise = np.stack([np.asarray(jax.random.uniform(k, (CAP,)))
                      for k in keys])
    label_one = jax_labeler(feature_filter, spatial_filter, use_sc2, gate)
    cfg = TrainConfig(caps=(CAP, 256), feature_filter=feature_filter,
                      spatial_filter=spatial_filter, similarity_thresh=0.6,
                      use_sc2_filtering=use_sc2,
                      label_min_translation_frac=gate,
                      sc2=SC2PCRConfig(max_points=512, seed_cap=64), **SMALL)
    tt = [torch.from_numpy(a) for a in (f0, m0, x0, f1, m1, x1, fd, Tg,
                                        noise)]
    got = label_pairs(cfg, *tt, similarity=load_similarity_tables("waymo"))
    n_ok = []
    for b in range(2):
        want = label_one(tuple(jnp.asarray(a[b]) for a in
                               (f0, m0, x0, f1, m1, x1, fd, Tg)) + (keys[b],))
        pos_i, pos_j, ok, hit, T_est = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(got.pos_i[b].numpy(), pos_i)
        np.testing.assert_allclose(float(got.labeler_hit[b]), hit,
                                   rtol=0, atol=1e-6)
        n_ok.append(int(ok.sum()))
        if b == 1 and feature_filter == "None" and use_sc2:
            # "None" keeps the largest distances: SC2-PCR gets the 30%
            # pair's worst matches, every seed's fitness is 4 and the IRLS
            # pose is not unique (ROADMAP §3): both sides fail the pair
            for T_b in (got.T_est[b].numpy(), T_est):
                assert np.linalg.norm(T_b[:3, 3] - Tg[b, :3, 3]) > 1.0
            continue
        np.testing.assert_array_equal(got.pos_j[b].numpy(), pos_j)
        np.testing.assert_array_equal(got.ok[b].numpy(), ok)
        np.testing.assert_allclose(got.T_est[b].numpy(), T_est, rtol=0,
                                   atol=1e-4)
    # the cases do label: the well-posed pair keeps positives
    assert n_ok[0] > 0
    if use_sc2:
        T_well = got.T_est[0].numpy()
        np.testing.assert_allclose(T_well, Tg[0], atol=0.05)
