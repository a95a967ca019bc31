"""The labeling's kernels and matching helpers against the JAX package, on
the CPU, on numpy inputs made from a seed:

(a) masked_knn at k = 1 and k = 2 (plain versions of kernels K2 and K8)
    against the JAX masked_knn: invalid queries, queries with one or no
    valid ref, duplicate ref rows; indices bit-equal, d2 rtol 1e-6 (atol
    1e-6 for distances near 0: the two Gram forms round their cross terms
    apart);
(b) K8's split-and-merge order in plain torch against the plain version,
    bit-equal;
(c) K9's plain version against JAX's safe-radius mining (loss.py:97-111
    rebuilt from the JAX package's pdist/pdist2), indices and flags
    bit-equal;
(d) ratio_test_weights, mutual_topk_matches (both feature filters, two
    pairs in one call), spatial_filter_mask (all three filters, both
    tables, all 6 frame buckets, ranges past the tables' edges),
    compact_matches, load_similarity_tables (array-equal) and hit_ratio;
(e) ema_update against the JAX ema_update, and sync_labeler's init / EMA /
    Sync against the trainer's _sync_labeler rule (trainer.py:352-377).
The K8 and K9 wrappers never fall back to their plain versions for a
tensor that is not on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry.metrics import hit_ratio as jhit_ratio
from eyoc_tpu.geometry.metrics import pdist as jpdist
from eyoc_tpu.geometry.metrics import pdist2 as jpdist2
from eyoc_tpu.ops import matching as J
from eyoc_tpu.ops.knn import masked_knn as jknn
from eyoc_tpu.training.optim import ema_update as jema
from eyoc_tpu_torch.geometry.metrics import hit_ratio
from eyoc_tpu_torch.models import UNetSpec, init_unet
from eyoc_tpu_torch.ops import knn
from eyoc_tpu_torch.ops import matching as T
from eyoc_tpu_torch.training.optim import ema_update, sync_labeler
from eyoc_tpu_torch.utils import kernels


def unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def knn_inputs(seed, nq=300, nr=260, D=32):
    """Features with duplicate ref rows (1 = 3 = 4, across the JAX tile
    edge too) and masks with invalid queries."""
    rng = np.random.default_rng(seed)
    q, r = unit(rng, nq, D), unit(rng, nr, D)
    r[3] = r[4] = r[1]
    r[200] = r[7]
    qm = rng.random(nq) < 0.8
    rm = rng.random(nr) < 0.7
    rm[[1, 3, 4, 7, 200]] = True
    return q, qm, r, rm


def t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# -------------------------------------------------------------------- (a)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", ["mixed", "one_valid_ref", "no_valid_ref"])
def test_masked_knn_matches_jax(k, case):
    q, qm, r, rm = knn_inputs(k)
    if case == "one_valid_ref":
        rm[:] = False
        rm[57] = True
    elif case == "no_valid_ref":
        rm[:] = False
    d_j, i_j = jax.jit(functools.partial(jknn, k=k, tile=128))(q, qm, r, rm)
    d_t, i_t = knn.masked_knn(*t(q, qm, r, rm), k=k)
    assert d_t.shape == (q.shape[0], k) and i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6,
                               atol=1e-6)
    if case == "no_valid_ref" or (case == "one_valid_ref" and k == 2):
        # a place no valid ref fills reads (1e30, 0), as JAX
        np.testing.assert_array_equal(i_t[:, -1].numpy(), 0)
        assert bool((d_t[:, -1] == 1e30).all())
    if k == 2 and case == "mixed":
        # the tie at the first place: the duplicate with the higher index
        # comes second
        hit = (i_t[:, 0] == 1) & torch.from_numpy(qm)
        assert bool(hit.any()) and bool((i_t[hit, 1] == 3).all())


def test_masked_knn_batched_matches_per_problem():
    rng = np.random.default_rng(5)
    B, nq, nr = 3, 90, 70
    q, r = unit(rng, B, nq, 32), unit(rng, B, nr, 32)
    qm, rm = rng.random((B, nq)) < 0.8, rng.random((B, nr)) < 0.6
    for k in (1, 2):
        d, i = knn.masked_knn_batched(*t(q, qm, r, rm), k=k)
        for b in range(B):
            db, ib = knn.masked_knn(*t(q[b], qm[b], r[b], rm[b]), k=k)
            assert torch.equal(d[b], db) and torch.equal(i[b], ib)


# -------------------------------------------------------------------- (b)


@pytest.mark.parametrize("splits,tile", [(1, 64), (3, 16), (5, 64)])
def test_k8_split_merge_matches_plain(splits, tile):
    q, qm, r, rm = knn_inputs(7)
    rm[150:] = False          # some splits see no valid ref at all
    d_p, i_p = knn.masked_knn2_plain(*t(q, qm, r, rm))
    d_s, i_s = knn.masked_knn2_split_plain(*t(q, qm, r, rm), splits=splits,
                                           tile=tile)
    assert torch.equal(i_s, i_p)
    np.testing.assert_allclose(d_s.numpy(), d_p.numpy(), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------------------- (c)


@jax.jit
def _jax_excl_mining(a, c, pxyz, cxyz, r2):
    """loss.py:97-111 for one direction: the L2 feature distances, 1e9
    where the candidate lies within r of the anchor's partner, argmin."""
    near = jpdist2(pxyz, cxyz) < r2
    D = jnp.where(near, jnp.float32(1e9), jpdist(a, c))
    ind = jnp.argmin(D, axis=1)
    return ind, jnp.min(D, axis=1) >= 1e9


@pytest.mark.parametrize("radius", [1.5, 6.0, 100.0])
def test_k9_plain_matches_jax_safe_radius_mining(radius):
    rng = np.random.default_rng(11)
    P, M = 200, 96
    a, c = unit(rng, P, 32), unit(rng, M, 32)
    pxyz = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    cxyz = rng.uniform(-10, 10, (M, 3)).astype(np.float32)
    r2 = np.float32(radius * radius)
    ind_j, ex_j = _jax_excl_mining(a, c, pxyz, cxyz, r2)
    ind_t, ex_t = knn.masked_argmin_excl(*t(a, c, pxyz, cxyz), radius ** 2)
    np.testing.assert_array_equal(ind_t.numpy(), np.asarray(ind_j))
    np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_j))
    if radius == 100.0:
        assert bool(ex_t.all()) and not bool(ind_t.any())
    else:
        assert not bool(ex_t.all())


# -------------------------------------------------------------------- (d)


def test_ratio_test_weights_match_jax():
    rng = np.random.default_rng(2)
    d2 = np.sort(rng.uniform(0, 4, (500, 2)).astype(np.float32), axis=1)
    d2[:5, 0] = 0.0
    d2[5:10, 1] = 1e30
    want = np.asarray(jax.jit(J.ratio_test_weights)(d2))
    got = T.ratio_test_weights(torch.from_numpy(d2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("feature_filter", ["Lowe", "None"])
def test_mutual_topk_matches_match_jax(feature_filter):
    rng = np.random.default_rng(3)
    B, N, nc = 2, 256, 100
    F0 = unit(rng, B, N, 32)
    F1 = unit(rng, B, N, 32)
    F1[:, :120] = unit(rng, B, 120, 32) * 0.3 + F0[:, :120]
    F1 /= np.linalg.norm(F1, axis=-1, keepdims=True)
    m0, m1 = rng.random((B, N)) < 0.85, rng.random((B, N)) < 0.85
    got = T.mutual_topk_matches(*t(F0, m0, F1, m1), num_corres=nc,
                                feature_filter=feature_filter)
    fn = jax.jit(functools.partial(J.mutual_topk_matches, num_corres=nc,
                                   feature_filter=feature_filter,
                                   knn_tile=128))
    for b in range(B):
        want = fn(F0[b], m0[b], F1[b], m1[b])
        for name, g, w in zip(("idx0", "idx1", "weight", "valid"), got,
                              want):
            if name == "weight":
                np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w),
                                              err_msg=name)
    assert got[0].shape == (B, 2 * nc) and got[0].dtype == torch.int32


@pytest.mark.parametrize("dataset", ["kitti", "waymo"])
def test_load_similarity_tables_array_equal(dataset):
    want = J.load_similarity_tables(dataset)
    got = T.load_similarity_tables(dataset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.ygrid.numpy(),
                                  [1, 1.5, 2, 2.5, 2.5, 2.5])


def endpoints(seed, M=3000):
    """Matched endpoint pairs whose ranges run past both tables' edges
    (min range to 160 m, |d range| to 70 m)."""
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(0, 160, M)
    r1 = np.clip(r0 + rng.uniform(-70, 70, M), 0, None)

    def on_sphere(r):
        d = rng.normal(size=(M, 3))
        return (d / np.linalg.norm(d, axis=1, keepdims=True)
                * r[:, None]).astype(np.float32)
    return on_sphere(r0), on_sphere(r1)


@pytest.mark.parametrize("dataset", ["kitti", "waymo"])
def test_spatial_filter_mask_matches_jax(dataset):
    x0, x1 = endpoints(4)
    tj, tt = J.load_similarity_tables(dataset), T.load_similarity_tables(
        dataset)
    # frame distances of every bucket, and past the last one
    fds = np.array([0, 4, 5, 9, 12, 17, 24, 27, 29, 30, 64], np.int32)
    B = len(fds)
    xb0, xb1 = np.stack([x0] * B), np.stack([x1] * B)
    for filt in ("None", "Spherical", "Similarity"):
        kw = dict(spatial_filter=filt, radius=40.0, similarity_thresh=0.6)
        got = T.spatial_filter_mask(*t(xb0, xb1), similarity=tt,
                                    frame_distance=torch.from_numpy(fds),
                                    **kw)
        fn = jax.jit(functools.partial(J.spatial_filter_mask, **kw),
                     static_argnames=())
        for b, fd in enumerate(fds):
            want = fn(x0, x1, similarity=tj, frame_distance=jnp.int32(fd))
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want),
                                          err_msg=f"{filt} fd={fd}")
            if filt == "Similarity":
                assert 0 < int(got[b].sum()) < x0.shape[0]


def test_compact_matches_matches_jax():
    rng = np.random.default_rng(6)
    B, M = 3, 400
    idx0 = rng.integers(0, 1000, (B, M)).astype(np.int32)
    idx1 = rng.integers(0, 1000, (B, M)).astype(np.int32)
    valid = rng.random((B, M)) < 0.4
    valid[2] = False
    for cap in (100, 400, 512):
        got = T.compact_matches(*t(idx0, idx1, valid), cap)
        for b in range(B):
            want = J.compact_matches(idx0[b], idx1[b], valid[b], cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_hit_ratio_matches_jax():
    rng = np.random.default_rng(8)
    B, M = 2, 500
    x0 = rng.uniform(-30, 30, (B, M, 3)).astype(np.float32)
    Tg = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    Tg[:, :3, 3] = [[1.0, -2.0, 0.3], [0.0, 0.5, 0.0]]
    x1 = (x0 + Tg[:, None, :3, 3]
          + rng.normal(0, 0.3, x0.shape)).astype(np.float32)
    mask = rng.random((B, M)) < 0.6
    got = hit_ratio(*t(x0, x1, Tg), 0.3, mask=torch.from_numpy(mask))
    want = jax.jit(jax.vmap(lambda a, b, c, m: jhit_ratio(a, b, c, 0.3,
                                                          mask=m)))(
        x0, x1, Tg, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(hit_ratio(*t(x0, x1, Tg), 0.3).numpy(),
                               np.asarray(jhit_ratio(x0, x1, Tg, 0.3)),
                               rtol=1e-6)
    assert float(hit_ratio(*t(x0, x1, Tg), 0.3,
                           mask=torch.zeros(B, M, dtype=torch.bool))[0]) == 0


# -------------------------------------------------------------------- (e)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(9)
    lab = rng.normal(size=(27, 8, 16)).astype(np.float32)
    mod = rng.normal(size=(27, 8, 16)).astype(np.float32)
    for n in (1, 2, 7):
        want = np.asarray(jema({"w": lab}, {"w": mod}, 0.2, n)["w"])
        got = ema_update(*t(lab, mod), 0.2, n).numpy()
        np.testing.assert_array_equal(got, want)


def test_sync_labeler_init_ema_and_sync():
    spec = UNetSpec("narrow", "BN", "BN", (8, 16), (8, 16))
    make = functools.partial(init_unet, spec, in_channels=1,
                             out_channels=16, conv1_kernel_size=3,
                             dtype=torch.float32, device="cpu")
    student = make(torch.Generator().manual_seed(0))
    labeler = make(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for b in student.buffers():
            b.add_(torch.rand(b.shape, generator=torch.Generator()
                              .manual_seed(2)))
    n = sync_labeler(labeler, student, 0)           # init: a copy
    assert n == 1
    for a, b in zip(labeler.state_dict().values(),
                    student.state_dict().values()):
        assert torch.equal(a, b)
    old = {k: v.clone() for k, v in labeler.state_dict().items()}
    with torch.no_grad():
        for p in student.parameters():
            p.mul_(1.5).add_(0.1)
        for b in student.buffers():
            b.mul_(0.5)
    n = sync_labeler(labeler, student, n, "EMA", 0.2)
    assert n == 2
    lab, stu = labeler.state_dict(), student.state_dict()
    params = {k for k, _ in labeler.named_parameters()}
    for k in lab:
        want = (np.asarray(jema({"w": old[k].numpy()},
                                {"w": stu[k].numpy()}, 0.2, 1)["w"])
                if k in params else stu[k].numpy())
        np.testing.assert_array_equal(lab[k].numpy(), want, err_msg=k)
    assert sync_labeler(labeler, student, n, "Sync") == 2
    for a, b in zip(labeler.state_dict().values(), stu.values()):
        assert torch.equal(a, b)


# ------------------------------------------------- kernels never fall back


class _LoaderDown(RuntimeError):
    pass


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_k8_k9_wrappers_never_fall_back(monkeypatch):
    def fail(name, argtypes, symbol=None):
        raise _LoaderDown(symbol or name)

    monkeypatch.setattr(kernels, "load", fail)
    before = dict(kernels.launches)
    b = torch.bool
    with pytest.raises(_LoaderDown, match="masked_knn2"):
        knn.masked_knn_batched(meta(2, 8, 32), meta(2, 8, dtype=b),
                               meta(2, 6, 32), meta(2, 6, dtype=b), k=2)
    with pytest.raises(_LoaderDown, match="masked_knn2"):
        T.mutual_topk_matches(meta(1, 8, 32), meta(1, 8, dtype=b),
                              meta(1, 8, 32), meta(1, 8, dtype=b),
                              num_corres=4)
    with pytest.raises(_LoaderDown, match="masked_argmin_excl"):
        knn.masked_argmin_excl(meta(8, 32), meta(6, 32), meta(8, 3),
                               meta(6, 3), 2.25)
    assert kernels.launches == before
    assert {"masked_knn2", "masked_argmin_excl"} <= set(kernels.COUNTERS)
