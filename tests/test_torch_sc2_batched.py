"""`sc2_pcr_batched` (the batched entry point, on the plain path of K13-K15)
against JAX `eyoc_tpu.registration.sc2pcr` on the CPU, problem by problem.

Four problems of N = 256 correspondences and 64 seeds, made with numpy:
30% inliers, 10% inliers, all but 3 rows invalid, no valid row.

- the fitness of each problem bit-equal to JAX `sc2_pcr`'s, the pose
  within 1e-4 m and 1e-3 deg (the tolerances of test_torch_sc2pcr.py);
- `sc2_nms_plain`'s seeds and seed_ok bit-equal to JAX `_pick_seeds` on the
  same scores, the tied zero tail included;
- `seed_transforms_batched_plain` and `post_refine_batched_plain` equal to
  the per-pair `_seed_transforms` and `_post_refine`, the IRLS on problems
  that stop after 1-3 rounds and one that runs all 20;
- each problem of a batch the same bits as its B = 1 call (`sc2_pcr`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry.metrics import rte
from eyoc_tpu.registration import sc2pcr as J
from eyoc_tpu_torch.registration import sc2pcr as T


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


N, SEEDS = 256, 64
KW = dict(max_points=N, seed_cap=SEEDS)


def problems(seed=0):
    """The four problems: src, tgt [4, N, 3] f32, valid [4, N] (numpy)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (4, N, 3)).astype(np.float32)
    tgt = np.empty_like(src)
    for b, inlier in enumerate((0.3, 0.1, 0.3, 0.3)):
        a = rng.uniform(-0.5, 0.5)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], np.float32)
        tgt[b] = (src[b] @ R.T + rng.uniform(-3, 3, 3)
                  + rng.normal(0, 0.01, (N, 3)))
        out = rng.random(N) >= inlier
        tgt[b, out] = rng.uniform(-20, 20, (int(out.sum()), 3))
    valid = np.ones((4, N), bool)
    valid[:2, -10:] = False
    valid[2, 3:] = False
    valid[3] = False
    return src, tgt.astype(np.float32), valid


def rotation_gap_deg(Ta, Tb):
    """Small angle between two rotations from the skew part of Ra^T Rb, in
    float64 (as test_torch_sc2pcr.py)."""
    R = (np.asarray(Ta, np.float64)[:3, :3].T
         @ np.asarray(Tb, np.float64)[:3, :3])
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0)))


def tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def batch():
    """The problems, the port's batched result and JAX's per problem."""
    src, tgt, valid = problems()
    trans, fit = T.sc2_pcr_batched(*tt(src, tgt, valid), T.SC2PCRConfig(**KW))
    run = jax.jit(lambda s, t, v: J.sc2_pcr(s, t, v, J.SC2PCRConfig(**KW)))
    jax_out = [run(jnp.asarray(src[b]), jnp.asarray(tgt[b]),
                   jnp.asarray(valid[b])) for b in range(4)]
    return src, tgt, valid, trans, fit, jax_out


@pytest.mark.parametrize("b", range(4))
def test_batched_matches_jax_per_problem(batch, b):
    src, tgt, valid, trans, fit, jax_out = batch
    Tj, fj = jax_out[b]
    assert np.array_equal(np.asarray(fj), fit[b].numpy())
    Tt = jnp.asarray(trans[b].numpy())
    assert float(rte(Tj, Tt)) < 1e-4
    assert rotation_gap_deg(Tj, Tt) < 1e-3
    if b == 0:        # the 30% problem is registered
        assert float(fit[b].max()) > 30
    if b == 3:        # no valid row: fitness -1 throughout, the identity
        assert bool((fit[b] == -1).all())
        assert torch.equal(trans[b], torch.eye(4))


@pytest.mark.parametrize("b", range(4))
def test_nms_matches_jax_pick_seeds(b):
    src, _, valid = problems()
    rng = np.random.default_rng(10 + b)
    # scores with ties (quantized), zero at invalid rows, as the
    # confidence the pipeline hands in
    scores = (np.round(rng.random(N) * 20) / 20).astype(np.float32)
    scores *= valid[b]
    d = np.asarray(jnp.linalg.norm(jnp.asarray(src[b])[:, None]
                                   - jnp.asarray(src[b])[None], axis=-1))
    d = np.where(valid[b][:, None] & valid[b][None, :], d, np.inf)
    sj, okj = jax.jit(J._pick_seeds, static_argnums=(2, 3))(
        jnp.asarray(d.astype(np.float32)), jnp.asarray(scores), 8.0, SEEDS)
    st, okt = T.sc2_nms_plain(*tt(src[b:b + 1], valid[b:b + 1],
                                  scores[None]), 8.0, SEEDS)
    assert np.array_equal(np.asarray(sj), st[0].numpy())
    assert np.array_equal(np.asarray(okj), okt[0].numpy())
    # a tied zero tail after the positive local maxima
    assert (0 < int(okt.sum()) < SEEDS) == (b < 3)


def test_seed_transforms_batched_matches_per_pair():
    src, tgt, valid = map(torch.from_numpy, problems())
    cfg = T.SC2PCRConfig(**KW)
    conf = torch.stack([T.sc2_power_iteration_plain(src[b], tgt[b], valid[b],
                                                    0.1, 20)
                        for b in range(4)]) * valid.float()
    seeds, seed_ok = T.sc2_nms_plain(src, valid, conf, cfg.nms_radius, SEEDS)
    knn = torch.stack([T.sc2_seed_topk_plain(src[b], tgt[b], valid[b],
                                             seeds[b], 0.1, cfg.k1)
                       for b in range(4)])
    trans, fit, best, _ = T.seed_transforms_batched_plain(cfg, seed_ok, knn,
                                                          src, tgt, valid)
    for b in range(4):
        Tb, fb = T._seed_transforms(cfg, seed_ok[b], knn[b], src[b], tgt[b],
                                    valid[b])
        assert torch.equal(fb, fit[b])
        assert torch.equal(Tb, trans[b, int(best[b])])


def creep(seed=77, spread=3.0):
    """One problem whose rows each move by their own offset in [0,
    spread)^3: from the identity the IRLS inlier set changes a little
    every round (all 20 rounds at seed 77 and spread 3)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    tgt = (src + rng.uniform(0, spread, (N, 3))).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(tgt)


def test_post_refine_batched_matches_per_pair():
    cfg = T.SC2PCRConfig(**KW)
    src, tgt, valid = map(torch.from_numpy, problems())
    parts = [creep(), creep(0, 1.0), (src[0], tgt[0]), (src[2], tgt[2])]
    S = torch.stack([p[0] for p in parts])
    G = torch.stack([p[1] for p in parts])
    V = torch.ones((4, N), dtype=torch.bool)
    V[2], V[3] = valid[0], valid[2]
    start = torch.eye(4).expand(4, 4, 4).contiguous()
    trans, it = T.post_refine_batched_plain(cfg, start, S, G, V)
    assert it[0] == 20 and 1 < it[1] < 20 and 1 <= it[2] <= 3
    for b in range(4):
        assert torch.equal(trans[b], T._post_refine(cfg, start[b], S[b],
                                                    G[b], V[b]))


def test_batch_rows_equal_their_b1_calls(batch):
    src, tgt, valid, trans, fit, _ = batch
    cfg = T.SC2PCRConfig(**KW)
    for b in range(4):
        Tb, fb = T.sc2_pcr(*tt(src[b], tgt[b], valid[b]), cfg)
        assert torch.equal(Tb, trans[b]) and torch.equal(fb, fit[b])
