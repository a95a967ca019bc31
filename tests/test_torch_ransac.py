"""RANSAC, ICP and the Jacobi Kabsch of the port against the JAX package, on
the CPU (the port's kernels replaced by their plain versions):

- `jacobi_eigh` and `kabsch` on [64, N, 3] batches (random weights, zero
  rows, all-zero weights, a weight threshold, collinear points):
  eigenvalues within 1e-5 of the largest; poses within 1e-5 where the
  Horn matrix's eigen gap is at least 1% of its largest eigenvalue, the
  others finite proper rotations (all-zero weights: the identity on both);
- `ransac_registration_plain` against eyoc_tpu.registration.ransac on N =
  512 correspondences (50% and 10% inliers, and 200 valid rows), two-stage
  (H = 4096, subset 128, top 256) and single-stage (H = 1024), on JAX's
  own uniforms: edge flags bit-equal; hypothesis poses, where the triplet's
  Horn gap is at least 1%, rotation within 2e-6 / gap (1e-5 at a 20% gap)
  and translation within 60 m times (1e-5 + that); coarse and full counts
  equal but for rows within 1e-5 m of the threshold (f64, under the port's
  pose) or that the two poses move across it; the kept indices
  equal where no count was waived; the final pose within 1e-4 m and 1e-3
  deg; the inlier count equal;
- `icp_point_to_point` on the JAX package's own ICP test problem (1500
  points, 30 rounds, r = 0.5 m) and a masked variant: T within 1e-5,
  fitness equal, the squared RMSE within 1e-6 m^2 (both sides' distances
  are the Gram form |a|^2 + |b|^2 - 2ab, which rounds at 2^-24 |x|^2, some
  1e-6 m^2 at 4 m: at convergence the RMSE is that rounding, 5e-4 m);
  `icp_refine_numpy` within 1e-5;
- a tensor that is not on the CPU goes to the kernels (K16-K18, K2),
  never to the plain versions; without a card ICP raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry import svd3 as jsvd3
from eyoc_tpu.registration import icp as jicp
from eyoc_tpu.registration import ransac as jransac
from eyoc_tpu_torch.geometry import svd3
from eyoc_tpu_torch.registration import icp, ransac
from eyoc_tpu_torch.utils import kernels

GAP = 1e-2            # eigen gap (of the largest eigenvalue) that pins a pose
EPS = 1e-5            # m: a count test this close to the threshold is waived
# A triplet's pose is f32 Jacobi on a Horn matrix whose gap can be small:
# rotation entries are held within HYP_ROT / gap (1e-5 at a gap of 20%,
# the rounding reach 2^-24 * 34 / gap), translations within EXTENT * (1e-5
# + that), EXTENT the coordinates' reach (m)
HYP_ROT = 2e-6
EXTENT = 60.0


def np64(x):
    return np.asarray(x, np.float64)


def horn_gap(a, b, w):
    """f64 eigen gap of each set's Horn matrix over its largest eigenvalue."""
    a, b, w = np64(a), np64(b), np64(w)
    ws = w.sum(-1, keepdims=True) + 1e-6
    am = a - (a * w[..., None]).sum(-2, keepdims=True) / ws[..., None]
    bm = b - (b * w[..., None]).sum(-2, keepdims=True) / ws[..., None]
    H = np.einsum("...ni,...n,...nj->...ij", am, w, bm)
    H = H / np.maximum(np.abs(H).max((-1, -2), keepdims=True), 1e-12)
    ev = np.linalg.eigvalsh(np64(jsvd3._horn_profile_matrix(jnp.asarray(H))))
    return (ev[..., 3] - ev[..., 2]) / np.maximum(np.abs(ev).max(-1), 1e-30)


def pose_gap(Ta, Tb):
    """(translation gap m, rotation gap deg) of two poses, f64."""
    Ta, Tb = np64(Ta), np64(Tb)
    R = Ta[:3, :3].T @ Tb[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])),
            float(np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0)))))


# ------------------------------------------------------ jacobi_eigh, kabsch


def test_jacobi_eigh_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 4, 4)).astype(np.float32)
    A = A + A.transpose(0, 2, 1)
    A[:8] = np.diag([1.0, 1.0, 2.0, -1.0]).astype(np.float32)   # diagonal
    A[8:16, 0, 0] = A[8:16, 1, 1]              # a_pp = a_qq: tau = 0
    ej, vj = jax.jit(jsvd3.jacobi_eigh)(jnp.asarray(A))
    et, vt = svd3.jacobi_eigh(torch.from_numpy(A))
    ej, vj = np.asarray(ej), np.asarray(vj)
    scale = np.abs(ej).max(-1, keepdims=True)
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-5 * scale.max())
    assert (np.abs(et.numpy() - ej) <= 1e-5 * scale).all()
    # eigenvectors (columns) up to sign, where the eigenvalue is isolated
    srt = np.sort(ej, -1)
    for b in range(64):
        for k in range(4):
            d = np.abs(srt[b] - ej[b, k])
            if np.sort(d)[1] < GAP * scale[b, 0]:
                continue
            u, v = vj[b, :, k], vt.numpy()[b, :, k]
            assert min(np.abs(u - v).max(), np.abs(u + v).max()) < 1e-5


def kabsch_case(kind, rng, n=40):
    a = rng.uniform(-20, 20, (64, n, 3)).astype(np.float32)
    T = np.stack([random_pose(rng) for _ in range(64)])
    b = (np.einsum("bij,bnj->bni", T[:, :3, :3], a) + T[:, None, :3, 3]
         + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    w = rng.random((64, n)).astype(np.float32)
    thr = 0.0
    if kind == "zero_rows":
        w[:, n // 2:] = 0.0
        a[:, n // 2:] = 1e3
    elif kind == "all_zero":
        w[:] = 0.0
    elif kind == "threshold":
        thr = 0.5
    elif kind == "collinear":
        d = rng.normal(size=(64, 1, 3))
        a = (rng.normal(size=(64, n, 1)) * d).astype(np.float32)
        b = (a + rng.normal(size=(64, 1, 3))).astype(np.float32)
    return a, b, w, thr


def random_pose(rng, angle=0.6, trans=5.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-angle, angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    T[:3, 3] = rng.uniform(-trans, trans, 3)
    return T


@pytest.mark.parametrize("kind", ["weights", "zero_rows", "all_zero",
                                  "threshold", "collinear"])
def test_kabsch_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    a, b, w, thr = kabsch_case(kind, rng)
    Tj = np.asarray(jax.jit(functools.partial(
        jsvd3.kabsch, weight_threshold=thr))(*map(jnp.asarray, (a, b, w))))
    Tt = svd3.kabsch(*map(torch.from_numpy, (a, b, w)),
                     weight_threshold=thr).numpy()
    assert np.isfinite(Tt).all()
    R = Tt[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    pinned = horn_gap(a, b, np.where(w < thr, 0.0, w)) >= GAP
    if kind == "all_zero":
        assert not pinned.any()
        assert np.array_equal(Tt, np.broadcast_to(np.eye(4), Tt.shape))
        assert np.array_equal(Tj, Tt)
    elif kind == "collinear":
        assert not pinned.any()          # a rotation about the line is free
    else:
        assert pinned.sum() >= 60
    np.testing.assert_allclose(Tt[pinned], Tj[pinned], rtol=0, atol=1e-5)


# ------------------------------------------------------------------ RANSAC


def correspondences(seed, n=512, inlier=0.5, nv=512):
    """n correspondences under a known pose, `inlier` of them true, the
    first nv valid."""
    rng = np.random.default_rng(seed)
    src = (rng.random((n, 3)) * [80.0, 80.0, 6.0] - [40.0, 40.0, 3.0])
    T = random_pose(rng, angle=0.4, trans=3.0)
    tgt = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, (n, 3))
    out = rng.random(n) >= inlier
    tgt[out] = rng.random((int(out.sum()), 3)) * 80.0 - 40.0
    valid = np.arange(n) < nv
    return src.astype(np.float32), tgt.astype(np.float32), valid, T


TWO_STAGE = jransac.RansacConfig(num_hypotheses=4096, coarse_subset=128,
                                 full_verify_top=256)
ONE_STAGE = jransac.RansacConfig(num_hypotheses=1024, coarse_subset=0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def jax_stages(src, tgt, valid, key, cfg):
    """The JAX package's RANSAC stages (ransac.py:106-160) up to the full
    counts: (u_tri, u_sub, edge, hypothesis poses, coarse, keep, counts)."""
    n = src.shape[0]
    count = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    H = cfg.num_hypotheses
    k_tri, k_sub = jax.random.split(key)
    u_tri = jax.random.uniform(k_tri, (H, 3))
    s3, t3 = jransac._sample_triplets(k_tri, src, tgt, count, H)
    edge = jransac._edge_ok(s3, t3, cfg.edge_length_ratio)
    hyp = jsvd3.kabsch(s3, t3)
    u_sub = jax.random.uniform(k_sub, (max(cfg.coarse_subset, 0),))
    coarse = keep = None
    trans, edge_k = hyp, edge
    if 0 < cfg.coarse_subset < n and cfg.full_verify_top < H:
        sub = (u_sub * count).astype(jnp.int32)
        coarse = jransac._count_inliers(
            hyp, jnp.take(src, sub, axis=0), jnp.take(tgt, sub, axis=0),
            jnp.ones(cfg.coarse_subset, bool), cfg.distance_threshold,
            max(cfg.hyp_chunk, H // 128))
        coarse = jnp.where(edge, coarse, -1.0)
        _, keep = jax.lax.top_k(coarse, cfg.full_verify_top)
        trans, edge_k = hyp[keep], edge[keep]
    counts = jransac._count_inliers(trans, src, tgt, valid,
                                    cfg.distance_threshold,
                                    min(cfg.hyp_chunk, trans.shape[0]))
    counts = jnp.where(edge_k, counts, -1.0)
    return u_tri, u_sub, edge, hyp, coarse, keep, counts


def waived(trans, trans_j, src, tgt, valid, thr):
    """f64 count, for each pose, of the valid rows whose test may come out
    otherwise: within EPS of thr under the port's pose, plus as far as the
    two poses move the row."""
    T, Tj, s = np64(trans), np64(trans_j), np64(src)
    pred = np.einsum("hij,nj->hni", T[:, :3, :3], s) + T[:, None, :3, 3]
    d = np.linalg.norm(pred - np64(tgt)[None], axis=-1)
    D = T - Tj
    move = np.linalg.norm(np.einsum("hij,nj->hni", D[:, :3, :3], s)
                          + D[:, None, :3, 3], axis=-1)
    return ((np.abs(d - thr) <= EPS + move) & valid[None]).sum(-1)


def assert_counts(got, want, band):
    """Equal but for a waived row each."""
    assert (np.abs(np64(got) - np64(want)) <= band).all()


@pytest.mark.parametrize("stage", ["two", "one"])
@pytest.mark.parametrize("inlier,nv", [(0.5, 512), (0.1, 512), (0.5, 200)])
def test_ransac_matches_jax(stage, inlier, nv):
    cfg = TWO_STAGE if stage == "two" else ONE_STAGE
    src, tgt, valid, T_true = correspondences(int(inlier * 10) + nv, 512,
                                              inlier, nv)
    key = jax.random.PRNGKey(nv + int(inlier * 10))
    j = [None if x is None else np.array(x)
         for x in jax_stages(*map(jnp.asarray, (src, tgt, valid)), key, cfg)]
    u_tri, u_sub, edge_j, hyp_j, coarse_j, keep_j, counts_j = j
    T_j, inl_j = jransac.ransac_registration(
        *map(jnp.asarray, (src, tgt, valid)), key, cfg)

    tcfg = ransac.RansacConfig(**vars(cfg))
    ts, tt, tv = map(torch.from_numpy, (src, tgt, valid))
    staged = ransac.two_stage(tcfg, 512)
    assert staged == (stage == "two")
    hyp, coarse = ransac.ransac_hypotheses_plain(
        ts, tt, tv, torch.from_numpy(u_tri),
        torch.from_numpy(u_sub) if staged else None, tcfg.distance_threshold,
        tcfg.edge_length_ratio)
    edge = (coarse >= 0).numpy()
    assert np.array_equal(edge, edge_j)
    # the hypotheses: poses where the triplet pins one
    count = max(nv, 1)
    tri = (u_tri * np.float32(count)).astype(np.int32)
    ones = np.ones(tri.shape, np.float32)
    gap = horn_gap(src[tri], tgt[tri], ones)
    pinned = gap >= GAP
    assert pinned.mean() > 0.95
    rot_tol = HYP_ROT / gap[pinned]
    d = np.abs(hyp.numpy()[pinned] - hyp_j[pinned])
    assert (d[:, :3, :3].max((1, 2)) <= rot_tol).all()
    assert (d[:, :3, 3].max(1) <= EXTENT * (1e-5 + rot_tol)).all()
    thr = tcfg.distance_threshold
    if staged:
        sub = (u_sub * np.float32(count)).astype(np.int32)
        band = waived(hyp.numpy(), hyp_j, src[sub], tgt[sub],
                      np.ones(sub.shape[0], bool), thr)
        assert_counts(coarse.numpy()[edge], coarse_j[edge], band[edge])
        keep = ransac.topk(coarse, tcfg.full_verify_top)[1]
        if np.array_equal(coarse.numpy(), coarse_j):
            assert np.array_equal(keep.numpy(), keep_j)
        keep_j = torch.from_numpy(keep_j.astype(np.int64))
    else:
        keep = keep_j = None
    # full verification on the JAX package's kept set
    counts, best = ransac.ransac_verify_plain(hyp, coarse, keep_j, ts, tt,
                                              tv, thr)
    rows = np.arange(cfg.num_hypotheses) if keep_j is None else \
        keep_j.numpy()
    band = waived(hyp.numpy()[rows], hyp_j[rows], src, tgt, valid, thr)
    assert_counts(counts.numpy(), counts_j, band)
    # the whole path, on the port's own kept set
    T_t, inl_t = ransac.ransac_registration_plain(
        ts, tt, tv, tcfg, (torch.from_numpy(u_tri), torch.from_numpy(u_sub)))
    te, re = pose_gap(T_t.numpy(), T_j)
    assert te < 1e-4 and re < 1e-3, (te, re)
    assert int(inl_t) == int(inl_j)
    # the wrapper takes the same plain versions on the CPU
    T_w, inl_w = ransac.ransac_registration(
        ts, tt, tv, tcfg, (torch.from_numpy(u_tri), torch.from_numpy(u_sub)))
    assert torch.equal(T_w, T_t) and int(inl_w) == int(inl_t)
    if inlier == 0.5:
        te, re = pose_gap(T_t.numpy(), T_true)
        assert te < 0.1 and re < 0.5


# --------------------------------------------------------------------- ICP


def icp_problem(masked):
    """The JAX package's ICP test problem (test_datasets_golden.py:254); the
    masked variant drops a third of each cloud's rows."""
    rng = np.random.default_rng(2)
    cloud = rng.uniform(-4, 4, (1500, 3)).astype(np.float32)
    from eyoc_tpu.data.augment import rotation_about
    R = rotation_about(np.asarray([0.2, 0.5, 1.0]), 0.05)
    t = np.asarray([0.08, -0.05, 0.03])
    tgt = (cloud @ R.T + t).astype(np.float32)
    sm = np.ones(1500, bool)
    tm = np.ones(1500, bool)
    if masked:
        sm = rng.random(1500) > 0.33
        tm = rng.random(1500) > 0.33
    return cloud, sm, tgt, tm


@pytest.mark.parametrize("masked", [False, True])
def test_icp_matches_jax(masked):
    s, sm, t, tm = icp_problem(masked)
    init = np.eye(4, dtype=np.float32)
    Tj, fj, rj = jicp.icp_point_to_point(
        *map(jnp.asarray, (s, sm, t, tm, init)), max_corr_dist=0.5,
        iterations=30, knn_tile=512)
    Tt, ft, rt = icp.icp_point_to_point(
        *map(torch.from_numpy, (s, sm, t, tm, init)), max_corr_dist=0.5,
        iterations=30)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5)
    assert float(ft) == float(fj)
    assert abs(float(rt) ** 2 - float(rj) ** 2) < 1e-6
    if not masked:
        assert float(ft) > 0.99 and float(rt) < 1e-3


def test_icp_refine_numpy_matches_jax():
    rng = np.random.default_rng(7)
    xyz0 = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    T = random_pose(rng, angle=0.03, trans=0.05)
    xyz1 = (xyz0 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    init = np.eye(4)
    Tj = jicp.icp_refine_numpy(xyz0, xyz1, init, iterations=10)
    Tt = icp.icp_refine_numpy(xyz0, xyz1, init, iterations=10, device="cpu")
    assert Tt.dtype == np.float64
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-5)


# ----------------------------------------------- kernels never fall back


class _LoaderDown(RuntimeError):
    pass


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's loader (here one
    that fails), never to the plain version; no launch is counted."""
    def fail(name, argtypes, symbol=None):
        raise _LoaderDown(symbol or name)

    monkeypatch.setattr(kernels, "load", fail)
    before = dict(kernels.launches)
    b, i32 = torch.bool, torch.int32
    cfg = ransac.RansacConfig(num_hypotheses=64, coarse_subset=8,
                              full_verify_top=16)
    pts, ok = meta(32, 3), meta(32, dtype=b)
    with pytest.raises(_LoaderDown, match="ransac_hypotheses"):
        ransac.ransac_registration(pts, pts, ok, cfg,
                                   draws=(meta(64, 3), meta(8)))
    with pytest.raises(_LoaderDown, match="ransac_verify"):
        ransac.ransac_verify(meta(64, 4, 4), meta(64), meta(16, dtype=i32),
                             pts, pts, ok, 0.3)
    with pytest.raises(_LoaderDown, match="ransac_polish"):
        ransac.ransac_polish(meta(64, 4, 4), meta(dtype=i32), pts, pts, ok,
                             0.3, 5)
    with pytest.raises(_LoaderDown, match="icp_solve"):
        icp.icp_solve(pts, ok, pts, meta(32, dtype=i32), meta(32), 0.04)
    with pytest.raises(_LoaderDown, match="masked_argmin"):
        icp.icp_point_to_point(pts, ok, pts, ok, meta(4, 4), iterations=1)
    assert kernels.launches == before
    assert {"ransac_hypotheses", "ransac_verify", "ransac_polish",
            "icp_solve"} <= set(kernels.COUNTERS)
    assert "ransac" in kernels.KERNELS


def test_no_card_no_cpu_fallback():
    """Without a device argument ICP runs on the card, and raises when
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: ICP runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        icp.icp_refine_numpy(np.zeros((8, 3)), np.zeros((8, 3)), np.eye(4))
