"""eyoc_tpu_torch.registration.sc2pcr against eyoc_tpu.registration.sc2pcr
on synthetic correspondences (N = 256, seed_cap 64, 30% inliers):

- the plain version of K3 against JAX `_power_iteration` on the same SC
  matrix, rtol 1e-4;
- the plain version of K4 against JAX's SC2 product, exactly;
- seeds and fitness equal; the pose within 1e-4 m and 1e-3 deg.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry.metrics import rte
from eyoc_tpu.registration import sc2pcr as J
from eyoc_tpu_torch.registration import sc2pcr as T

N, SEEDS, D_THRE = 256, 64, 0.1


def correspondences(seed, n=N, inlier=0.3, n_invalid=10):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = rng.uniform(-3, 3, 3).astype(np.float32)
    tgt = (src @ R.T + t + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    out = rng.random(n) >= inlier
    tgt[out] = rng.uniform(-20, 20, (int(out.sum()), 3))
    valid = np.ones(n, bool)
    valid[-n_invalid:] = False
    return src, tgt, valid


def jax_cross(src, tgt):
    """The N x N part of JAX sc2_pcr (sc2pcr.py:274-285), spelled out."""
    s, t = jnp.asarray(src), jnp.asarray(tgt)
    sd = jnp.linalg.norm(s[:, None] - s[None, :], axis=-1)
    td = jnp.linalg.norm(t[:, None] - t[None, :], axis=-1)
    return jnp.abs(sd - td)


def rotation_gap_deg(Ta, Tb):
    """Small angle between two rotations from the skew part of Raᵀ Rb, in
    float64 (the trace form, arccos((tr - 1) / 2), is quantized at ~0.01
    deg near zero by the matrices' own f32 rounding)."""
    R = np.asarray(Ta, np.float64)[:3, :3].T @ np.asarray(Tb, np.float64)[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0)))


def tt(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_power_iteration_plain_matches_jax(seed):
    src, tgt, valid = correspondences(seed)
    pair_ok = jnp.asarray(valid[:, None] & valid[None, :])
    sc = jnp.clip(1.0 - jax_cross(src, tgt) ** 2 / D_THRE ** 2, 0.0,
                  None) * pair_ok
    want = np.asarray(J._power_iteration(sc, 20))
    got = T.sc2_power_iteration(*tt(src, tgt, valid), D_THRE, 20).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_counts_plain_matches_jax_exactly(seed):
    src, tgt, valid = correspondences(seed)
    seeds = np.random.default_rng(seed).permutation(N)[:SEEDS].astype(np.int32)
    cross = jax_cross(src, tgt)
    pair_ok = jnp.asarray(valid[:, None] & valid[None, :])
    hard = ((cross < D_THRE) & pair_ok).astype(jnp.bfloat16)
    tight = ((cross < D_THRE / 2.0) & pair_ok).astype(jnp.bfloat16)
    js = jnp.asarray(seeds)
    want = np.asarray(jnp.dot(jnp.take(tight, js, axis=0), tight,
                              preferred_element_type=jnp.float32)
                      * jnp.take(hard, js, axis=0).astype(jnp.float32))
    got = T.sc2_seed_counts(*tt(src, tgt, valid, seeds), D_THRE).numpy()
    assert np.array_equal(got, want)
    assert got.max() > 1


def test_pick_seeds_matches_jax():
    src, tgt, valid = correspondences(3)
    rng = np.random.default_rng(3)
    scores = rng.random(N).astype(np.float32) * valid
    pair_ok = valid[:, None] & valid[None, :]
    d = np.asarray(jnp.linalg.norm(jnp.asarray(src)[:, None]
                                   - jnp.asarray(src)[None], axis=-1))
    d = np.where(pair_ok, d, np.inf).astype(np.float32)
    sj, okj = J._pick_seeds(jnp.asarray(d), jnp.asarray(scores), 15.0, SEEDS)
    st, okt = T._pick_seeds(*tt(d, scores), 15.0, SEEDS)
    assert np.array_equal(np.asarray(okj), okt.numpy())
    assert 0 < int(okt.sum()) < SEEDS      # a tied zero-score tail exists
    # ties go to the lowest index on both sides, so even the tail agrees
    assert np.array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sc2_pcr_pose_matches_jax(seed):
    src, tgt, valid = correspondences(seed)
    cfg = dict(max_points=N, seed_cap=SEEDS)
    Tj, fj = J.sc2_pcr(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
                       J.SC2PCRConfig(**cfg))
    Tt, ft = T.sc2_pcr(*tt(src, tgt, valid), T.SC2PCRConfig(**cfg))
    assert np.array_equal(np.asarray(fj), ft.numpy())
    Tt = jnp.asarray(Tt.numpy())
    assert float(rte(Tj, Tt)) < 1e-4
    assert rotation_gap_deg(Tj, Tt) < 1e-3


def test_estimator_matches_jax():
    src, tgt, valid = correspondences(4)
    rng = np.random.default_rng(4)
    # features that make the i-th source's nearest target row perm[i]
    perm = rng.permutation(N)
    base = rng.normal(size=(N, 32)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    f_src = base
    f_tgt = np.empty_like(base)
    f_tgt[perm] = base + rng.normal(0, 0.01, base.shape).astype(np.float32)
    tgt_rows = np.empty_like(tgt)
    tgt_rows[perm] = tgt
    cfg = dict(max_points=N, seed_cap=SEEDS)
    m = np.ones(N, bool)
    Tj, lj, _, nnj = J.sc2_pcr_estimator(
        jnp.asarray(src), jnp.asarray(f_src), jnp.asarray(valid),
        jnp.asarray(tgt_rows), jnp.asarray(f_tgt), jnp.asarray(m),
        J.SC2PCRConfig(**cfg))
    Tt, lt, _, nnt = T.sc2_pcr_estimator(
        *tt(src, f_src, valid, tgt_rows, f_tgt, m), T.SC2PCRConfig(**cfg))
    assert np.array_equal(np.asarray(nnj), nnt.numpy())
    assert np.array_equal(np.asarray(lj), lt.numpy())
    Tt = jnp.asarray(Tt.numpy())
    assert float(rte(Tj, Tt)) < 1e-4 and rotation_gap_deg(Tj, Tt) < 1e-3


def test_config_defaults_match_jax():
    j, t = J.SC2PCRConfig(), T.SC2PCRConfig()
    for f in ("d_thre", "num_iterations", "ratio", "nms_radius", "max_points",
              "k1", "k2", "inlier_threshold", "seed_cap", "qcp_kabsch"):
        assert getattr(j, f) == getattr(t, f), f
    assert j.num_seeds == t.num_seeds
