"""The reformulations of kernels K3 (`sc2_power_iteration`) and K2
(`masked_argmin`) in plain torch, against the plain versions and the JAX
package, on numpy inputs made from a seed:

(a) K3's tile-pair walk of the upper triangle (each SC block made once,
    its row sums to y_I and its column sums to y_J, the partials added in
    the kernel's order, 1/d^2 multiplied) against
    `sc2_power_iteration_plain` and the JAX `_power_iteration` over the
    JAX `sc`, with tiles that do not divide N and masked rows; rtol 1e-5,
    atol 1e-7;
(b) the symmetry K3 relies on: |a_i - a_j| and |a_j - a_i| are the same
    bits;
(c) K2's reference splits (tiles handed to the splits in turn, valid
    refs only) reduced in split order against
    `masked_argmin_plain` and the JAX `masked_argmin`: duplicate refs
    across split boundaries (the lowest index wins), every ref masked,
    invalid queries;
(d) `masked_argmin_batched` and the batched `gt_positive_pairs` against
    the JAX `vmap`ped call and the JAX `gt_positive_pairs`: indices and
    `valid` bit-equal, d2 within rtol/atol 1e-5 (as tests/test_torch_knn.py);
and the launch planner `k2_plan` on the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.ops.knn import masked_argmin as jargmin
from eyoc_tpu.registration import sc2pcr as J
from eyoc_tpu.training.pipeline import gt_positive_pairs as jgt_pairs
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.ops import knn
from eyoc_tpu_torch.registration import sc2pcr as T
from eyoc_tpu_torch.training.pipeline import gt_positive_pairs
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess


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


D_THRE = 0.1


def correspondences(seed, n, inlier=0.4, n_invalid=5):
    """SC2-PCR inputs: a rigid motion, 40% inliers, masked rows spread
    over the set (not only at its end)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = rng.uniform(-3, 3, 3).astype(np.float32)
    tgt = (src @ R.T + t + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    out = rng.random(n) >= inlier
    tgt[out] = rng.uniform(-20, 20, (int(out.sum()), 3))
    valid = np.ones(n, bool)
    valid[rng.permutation(n)[:n_invalid]] = False
    return src, tgt, valid


def jax_sc(src, tgt, valid):
    s, t = jnp.asarray(src), jnp.asarray(tgt)
    cross = jnp.abs(jnp.linalg.norm(s[:, None] - s[None, :], axis=-1)
                    - jnp.linalg.norm(t[:, None] - t[None, :], axis=-1))
    pair_ok = jnp.asarray(valid[:, None] & valid[None, :])
    return jnp.clip(1.0 - cross ** 2 / D_THRE ** 2, 0.0, None) * pair_ok


# ----------------------------------------------------------------- (a) K3


@pytest.mark.parametrize("n,tile", [(37, 16), (37, 128), (300, 48),
                                    (300, 128), (1000, 128), (1000, 96)])
def test_k3_tile_pairs_match_plain_and_jax(n, tile):
    assert n % tile != 0
    src, tgt, valid = correspondences(n + tile, n)
    ts, tt, tv = map(torch.from_numpy, (src, tgt, valid))
    got = T.sc2_power_iteration_tiled_plain(ts, tt, tv, D_THRE, 20,
                                            tile=tile).numpy()
    plain = T.sc2_power_iteration_plain(ts, tt, tv, D_THRE, 20).numpy()
    want = np.asarray(J._power_iteration(jax_sc(src, tgt, valid), 20))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (got[~valid] == 0).all() and (got[valid] > 0).any()


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_k3_tile_pairs_few_iterations(iters):
    src, tgt, valid = correspondences(7, 200)
    ts, tt, tv = map(torch.from_numpy, (src, tgt, valid))
    got = T.sc2_power_iteration_tiled_plain(ts, tt, tv, D_THRE, iters,
                                            tile=64).numpy()
    want = T.sc2_power_iteration_plain(ts, tt, tv, D_THRE, iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_k3_tile_pairs_all_masked_is_zero():
    src, tgt, valid = correspondences(8, 150)
    valid[:] = False
    got = T.sc2_power_iteration_tiled_plain(
        *map(torch.from_numpy, (src, tgt, valid)), D_THRE, 20, tile=64)
    assert torch.equal(got, torch.zeros(150))


# ----------------------------------------------------------------- (b) K3


@pytest.mark.parametrize("scale", [1.0, 20.0, 80.0])
def test_norm3_is_symmetric_bit_for_bit(scale):
    rng = np.random.default_rng(int(scale))
    a = torch.from_numpy(rng.uniform(-scale, scale, (400, 3))
                         .astype(np.float32))
    fwd = T._norm3(a[:, None, :] - a[None, :, :])
    assert torch.equal(fwd, T._norm3(a[None, :, :] - a[:, None, :]))
    assert torch.equal(fwd, fwd.T)


# ----------------------------------------------------------------- (c) K2


def k2_inputs(seed, nq, nr, dim):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, dim)).astype(np.float32)
    r = rng.normal(size=(nr, dim)).astype(np.float32)
    qm = rng.random(nq) < 0.9
    rm = rng.random(nr) < 0.9
    return q, qm, r, rm


@pytest.mark.parametrize("splits", [1, 3, 7, 64])
@pytest.mark.parametrize("dim", [3, 32])
def test_k2_splits_keep_the_lowest_duplicate(splits, dim):
    nq, nr, tile = 90, 500, 16
    q, qm, r, rm = k2_inputs(splits * 100 + dim, nq, nr, dim)
    # ref j0 and copies of it in later tiles: some in other splits, one in
    # an earlier split (tile `splits` belongs to split 0, after j0's tile 1)
    j0s = (tile + 3, 2 * tile - 1, 5 * tile + 5)
    for k, j0 in enumerate(j0s):
        rm[j0] = True
        for j in (j0 + tile, j0 + 2 * tile, j0 + (splits - 1) * tile,
                  j0 + 1):
            if j < nr and j not in j0s:
                r[j] = r[j0]
                rm[j] = True
        q[k] = r[j0]
        qm[k] = True
    args = [torch.from_numpy(x) for x in (q, qm, r, rm)]
    d, i = knn.masked_argmin_split_plain(*args, splits, tile=tile)
    dp, ip = knn.masked_argmin_plain(*args)
    dj, ij = jargmin(*map(jnp.asarray, (q, qm, r, rm)))
    assert i.dtype == torch.int32
    assert np.array_equal(i.numpy(), ip.numpy())
    assert np.array_equal(i.numpy(), np.asarray(ij))
    # d2 against the direct form in f64 (the plain version's Gram form is
    # ~1e-5 off zero at an exact duplicate)
    q64, r64 = q.astype(np.float64), r.astype(np.float64)
    want = ((q64 - r64[i.numpy()]) ** 2).sum(1)
    np.testing.assert_allclose(d.numpy()[qm], want[qm], rtol=1e-5, atol=1e-6)
    for k, j0 in enumerate(j0s):
        assert int(i[k]) == j0
        assert float(d[k]) == 0.0


@pytest.mark.parametrize("splits", [1, 4])
def test_k2_splits_all_refs_masked(splits):
    q, qm, r, rm = k2_inputs(11, 40, 130, 32)
    qm[:] = True
    rm[:] = False
    args = [torch.from_numpy(x) for x in (q, qm, r, rm)]
    d, i = knn.masked_argmin_split_plain(*args, splits, tile=32)
    _, ip = knn.masked_argmin_plain(*args)
    _, ij = jargmin(*map(jnp.asarray, (q, qm, r, rm)))
    assert np.array_equal(i.numpy(), ip.numpy())
    assert np.array_equal(i.numpy(), np.asarray(ij))
    assert (i.numpy() == 0).all() and (d.numpy() >= 1e30).all()


@pytest.mark.parametrize("splits", [2, 5])
def test_k2_splits_invalid_queries(splits):
    q, qm, r, rm = k2_inputs(12, 200, 300, 3)
    qm[::3] = False
    args = [torch.from_numpy(x) for x in (q, qm, r, rm)]
    d, i = knn.masked_argmin_split_plain(*args, splits, tile=32)
    dp, ip = knn.masked_argmin_plain(*args)
    assert (i.numpy()[~qm] == 0).all() and (d.numpy()[~qm] == 1e30).all()
    assert np.array_equal(i.numpy(), ip.numpy())
    np.testing.assert_allclose(d.numpy(), dp.numpy(), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- (d) K2


@pytest.mark.parametrize("dim", [3, 32])
def test_masked_argmin_batched_matches_jax_vmap(dim):
    rng = np.random.default_rng(dim)
    B, nq, nr = 3, 260, 300
    q = rng.normal(size=(B, nq, dim)).astype(np.float32)
    r = rng.normal(size=(B, nr, dim)).astype(np.float32)
    qm = rng.random((B, nq)) < 0.9
    rm = rng.random((B, nr)) < 0.9
    rm[1] = False                     # one problem with every ref masked
    dj, ij = jax.vmap(jargmin)(*map(jnp.asarray, (q, qm, r, rm)))
    dt, it = knn.masked_argmin_batched(*map(torch.from_numpy, (q, qm, r, rm)))
    assert it.shape == (B, nq) and it.dtype == torch.int32
    assert np.array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    for b in range(B):                # the batch of one is masked_argmin
        d1, i1 = knn.masked_argmin(*(torch.from_numpy(x[b])
                                     for x in (q, qm, r, rm)))
        assert torch.equal(i1, it[b]) and torch.equal(d1, dt[b])


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_gt_positive_pairs_bit_equal(seed):
    rng = np.random.default_rng(100 + seed)
    B, P = 3, 2500
    xyz0 = rng.normal(0, 5, (B, P, 3)).astype(np.float32)
    T_ = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        yaw = rng.uniform(-0.3, 0.3)
        T_[b, :3, :3] = [[np.cos(yaw), -np.sin(yaw), 0],
                         [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        T_[b, :3, 3] = rng.uniform(-1, 1, 3)
    xyz1 = (np.einsum("bij,bnj->bni", T_[:, :3, :3], xyz0)
            + T_[:, None, :3, 3]
            + rng.normal(0, 0.05, xyz0.shape)).astype(np.float32)
    counts = np.array([P, P - 700, 0 if seed else P - 1], np.int32)
    radius = np.array([0.45, 0.3, 0.6], np.float32)
    caps, bits = (2048, 768), (7, 7, 6)
    jv = [jpreprocess(jnp.asarray(x), jnp.asarray(counts), caps=caps,
                      voxel_size=0.3, window_bits=bits)[0]
          for x in (xyz0, xyz1)]
    tv = [tpreprocess(torch.from_numpy(x), torch.from_numpy(counts),
                      caps=caps, voxel_size=0.3, window_bits=bits)[0]
          for x in (xyz0, xyz1)]
    want = jgt_pairs(jv[0], jv[1], jnp.asarray(T_), jnp.asarray(radius))
    got = gt_positive_pairs(tv[0], tv[1], torch.from_numpy(T_),
                            torch.from_numpy(radius))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 or g.dtype == torch.bool
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 100


# ------------------------------------------------------------ the planner


@pytest.mark.parametrize("resident", [396, 792])   # 3 or 6 blocks an SM
@pytest.mark.parametrize("batch,nq,nr,dim", [
    (1, 5000, 5000, 32),        # eval feature matching
    (8, 16384, 16384, 3),       # the GT pairs of a train step
    (1, 8192, 2048, 32),        # the loss's mining
    (1, 100, 50, 3),            # fewer refs than one split's least
    (64, 5000, 300, 3),         # more query tiles than resident blocks
])
def test_k2_plan_grid(batch, nq, nr, dim, resident):
    qtiles, splits = knn.k2_plan(batch, nq, nr, dim, resident)
    assert qtiles * knn._K2_QUERIES[dim] >= nq
    assert (qtiles - 1) * knn._K2_QUERIES[dim] < nq
    assert 1 <= splits <= knn._K2_MAX_SPLITS
    # every split gets at least one reference tile
    assert splits <= -(-nr // knn._K2_REF_TILE[dim])
    # one wave: every block resident at once, unless one split is too many
    assert splits == 1 or batch * qtiles * splits <= resident
    # one ticket per query tile of each problem (kernels.ticket grows)
    assert batch * qtiles >= 1
