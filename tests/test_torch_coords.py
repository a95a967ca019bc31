"""The sparse coordinate kernels' reformulations (K10 voxelize, K11
brick_pyramid, K12 conv_maps) in plain torch, against the plain versions
and the JAX package on the same numpy inputs; and their wrappers'
dispatch. Every index, key, mask and map is compared bit for bit.

The JAX side runs under `jax.jit` with the voxel size as a traced f32, so
that `xyz / voxel_size` is an IEEE division, as the port's (torch's f32
division, K10's `__fdiv_rn`, the reference's numpy `floor(xyz /
voxel_size)`). The JAX package's own `preprocess_clouds` jits with a
static voxel size, and XLA folds the division by that constant into a
product with its reciprocal: `test_jax_static_voxel_size_takes_the_reciprocal`
pins where that differs (points on voxel faces).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse import morton as jmorton
from eyoc_tpu.sparse.bricks import build_pyramid as jbuild_pyramid
from eyoc_tpu.sparse.voxelize import voxelize as jvoxelize
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.sparse import bricks as tbricks
from eyoc_tpu_torch.sparse import voxelize as tvox
from eyoc_tpu_torch.training import pipeline as tpipe
from eyoc_tpu_torch.utils import kernels

BITS = (7, 7, 6)
VOXEL = 0.3
# (clouds, caps): no overflow; brick overflow; voxel, brick and parent
# overflow (the third case of test_torch_sparse.py's pyramid test)
CASES = [(1, (4096, 1024, 256, 128)), (2, (2048, 768, 256, 96)),
         (3, (700, 256, 64, 32))]


def clouds(B, n=3000, seed=0, bits=BITS):
    """B padded clouds [B, n, 3] f32 and their point counts (masked
    tails): Gaussian points, a sixth of them exactly on voxel faces (k *
    0.3 in f32), a sixth duplicating other points, points in the voxels on
    the window's edges and points outside the window, shuffled."""
    rng = np.random.default_rng(seed)
    h = np.array([1 << (b - 1) for b in bits], np.float32)
    xyz = rng.normal(0, 4.0, (B, n, 3)).astype(np.float32)
    k = n // 6
    xyz[:, :k] = rng.integers(-40, 40, (B, k, 3)).astype(np.float32) \
        * np.float32(VOXEL)
    xyz[:, k:2 * k] = xyz[:, rng.integers(0, n, k)]
    edge = rng.integers(-8, 8, (B, 60, 3)).astype(np.float32)
    edge[:, :30, 0] = np.where(edge[:, :30, 0] < 0, -h[0], h[0] - 1)
    edge[:, 30:, 1] = np.where(edge[:, 30:, 1] < 0, -h[1], h[1] - 1)
    xyz[:, 2 * k:2 * k + 60] = (edge + 0.5) * np.float32(VOXEL)
    xyz[:, 2 * k + 60:2 * k + 100] *= 20.0             # outside the window
    for b in range(B):
        xyz[b] = xyz[b][rng.permutation(n)]
    counts = np.array([n - 300 * b for b in range(B)], np.int32)
    return xyz, counts


@functools.lru_cache(maxsize=None)
def _jit_voxelize(capacity, bits):
    return jax.jit(lambda x, m, v: jvoxelize(x, m, v, capacity, bits))


@functools.lru_cache(maxsize=None)
def _jit_preprocess(caps, bits):
    """JAX's preprocess_clouds with the voxel size traced (IEEE division)."""
    return jax.jit(lambda x, n, v: jpreprocess.__wrapped__(
        x, n, caps=caps, voxel_size=v, window_bits=bits))


@functools.lru_cache(maxsize=None)
def _jit_pyramid(B, brick_caps, bits):
    return jax.jit(lambda k, m: jbuild_pyramid(k, m, B, brick_caps, bits))


def assert_equal(a, b, what=""):
    """Bit-equal trees (named tuples of arrays, None where both None)."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, tuple):
        assert len(a) == len(b), what
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            assert_equal(x, y, f"{what}.{name}")
        return
    x = np.asarray(a) if not torch.is_tensor(a) else a.numpy()
    y = np.asarray(b) if not torch.is_tensor(b) else b.numpy()
    assert x.dtype == y.dtype and x.shape == y.shape, what
    assert np.array_equal(x, y), f"{what}: {int((x != y).sum())} differ"


def pyramid_equal(a, b):
    for l, (x, y) in enumerate(zip(a.levels, b.levels)):
        assert_equal(tuple(x), tuple(y), f"level {l}")
    assert len(a.levels) == len(b.levels)
    assert_equal(tuple(a.vox_masks), tuple(b.vox_masks), "vox_masks")


def mirror_preprocess(xyz, counts, caps, bits=BITS):
    """preprocess_clouds through K10's and K11's reformulations."""
    B, cap = xyz.shape[0], caps[0]
    vox, keys = tvox.voxelize_composite_plain(xyz, counts, VOXEL, cap, bits)
    pyr = tbricks.build_pyramid_search_plain(
        keys, vox.mask.reshape(-1), B, tpipe.brick_caps(caps), bits)
    return vox._replace(mask=pyr.vox_masks[0].reshape(B, cap),
                        count=pyr.counts), pyr, keys


# ------------------------------------------------------------------- K10


@pytest.mark.parametrize("B,caps", CASES)
def test_k10_mirror_matches_jax_voxelize(B, caps):
    """The batched composite-key voxelize against eyoc_tpu's voxelize of
    each cloud and the port's plain version, keys included."""
    xyz, counts = clouds(B, seed=B)
    cap = caps[0]
    t = torch.from_numpy(xyz)
    n = torch.from_numpy(counts)
    vox, keys = tvox.voxelize_composite_plain(t, n, VOXEL, cap, BITS)
    plain, pkeys = tvox.voxelize_batched_plain(t, n, VOXEL, cap, BITS)
    assert_equal(tuple(vox), tuple(plain), "vs plain")
    assert_equal(keys, pkeys, "keys vs plain")
    f = _jit_voxelize(cap, BITS)
    for b in range(B):
        m = np.arange(xyz.shape[1]) < counts[b]
        j = f(jnp.asarray(xyz[b]), jnp.asarray(m), jnp.float32(VOXEL))
        assert_equal(tuple(j), tuple(f_[b] for f_ in vox), f"cloud {b}")
        jk = jmorton.encode(j.coords, j.mask, BITS)
        assert_equal(jk, keys.reshape(B, cap)[b], f"keys of cloud {b}")
    if cap == 700:                          # capacity overflow saturates
        assert vox.count.tolist() == [700] * B


@pytest.mark.parametrize("B,caps", CASES)
def test_k10_k11_mirrors_match_preprocess_of_both_packages(B, caps):
    """K10's and K11's reformulations chained as preprocess_clouds chains
    the kernels, against the port's preprocess_clouds (CPU: the plain
    versions) and eyoc_tpu's (voxel size traced)."""
    xyz, counts = clouds(B, seed=10 + B)
    t = torch.from_numpy(xyz)
    n = torch.from_numpy(counts)
    vox, pyr, _ = mirror_preprocess(t, n, caps)
    tv, tp = tpipe.preprocess_clouds(t, n, caps=caps, voxel_size=VOXEL,
                                     window_bits=BITS)
    jv, jp = _jit_preprocess(caps, BITS)(jnp.asarray(xyz),
                                         jnp.asarray(counts),
                                         jnp.float32(VOXEL))
    for other in ((tv, tp), (jv, jp)):
        assert_equal(tuple(vox), tuple(other[0]), "vox")
        pyramid_equal(pyr, other[1])
    assert_equal(pyr.counts, tp.counts, "counts")
    assert (vox.count > 0).all()


def test_jax_static_voxel_size_takes_the_reciprocal():
    """eyoc_tpu's preprocess_clouds, jitted with a static voxel size,
    quantizes by x * (1 / 0.3) (XLA folds the division by a constant): on
    points exactly on voxel faces it puts some in the voxel below. The
    port divides (IEEE), as the JAX voxelize does with a traced size and
    as the reference's numpy floor(xyz / voxel_size) does."""
    rng = np.random.default_rng(5)
    xyz = (rng.integers(-60, 60, (1, 2000, 3)).astype(np.float32)
           * np.float32(VOXEL))
    counts = np.array([2000], np.int32)
    caps = (4096, 1024, 256, 128)
    js, _ = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=caps,
                        voxel_size=VOXEL, window_bits=BITS)
    jt, _ = _jit_preprocess(caps, BITS)(jnp.asarray(xyz),
                                        jnp.asarray(counts),
                                        jnp.float32(VOXEL))
    tv, _ = tpipe.preprocess_clouds(torch.from_numpy(xyz),
                                    torch.from_numpy(counts), caps=caps,
                                    voxel_size=VOXEL, window_bits=BITS)
    assert_equal(tuple(jt), tuple(tv), "traced voxel size")
    ieee = np.floor(xyz[0] / np.float32(VOXEL))
    recip = np.floor(xyz[0] * (np.float32(1) / np.float32(VOXEL)))
    assert (ieee != recip).any()                 # faces the two split
    assert not np.array_equal(np.asarray(js.coords), tv.coords.numpy())


# ------------------------------------------------------------------- K11


def _sorted_within_clouds(level, B):
    keys = level.bkeys.reshape(B, -1)
    mask = level.bmask.reshape(B, -1)
    for k, m in zip(keys, mask):
        valid = k[m]
        assert torch.equal(m, torch.arange(len(m)) < len(valid))  # a prefix
        assert bool((valid[1:] > valid[:-1]).all())


@pytest.mark.parametrize("B,caps", CASES)
def test_k11_search_matches_grid_and_jax(B, caps):
    """The sorted-key neighbour search against the grid form and eyoc_tpu's
    build_pyramid (window edges, brick and parent overflow); every
    cloud's valid brick keys are a sorted prefix, which the search needs."""
    xyz, counts = clouds(B, seed=20 + B)
    vox, keys = tvox.voxelize_batched_plain(torch.from_numpy(xyz),
                                            torch.from_numpy(counts), VOXEL,
                                            caps[0], BITS)
    mask = vox.mask.reshape(-1)
    bcs = tpipe.brick_caps(caps)
    search = tbricks.build_pyramid_search_plain(keys, mask, B, bcs, BITS)
    grid = tbricks.build_pyramid_plain(keys, mask, B, bcs, BITS)
    jp = _jit_pyramid(B, bcs, BITS)(jnp.asarray(keys.numpy()),
                                    jnp.asarray(mask.numpy()))
    pyramid_equal(search, grid)
    pyramid_equal(search, jp)
    assert_equal(search.counts, grid.counts, "counts")
    for level in search.levels:
        _sorted_within_clouds(level, B)
    # the window's -x edge holds bricks whose outward face finds nothing
    # (the +x edge's high Morton keys are the first a brick overflow drops)
    lv = search.levels[0]
    edge = lv.bmask & (tbricks.morton.axes_of(lv.bkeys)[0] == 0)
    assert bool(edge.any()) and bool((lv.nbr6[0][edge] == len(lv.bmask)).all())
    if caps[1] == 256:                   # the overflow case drops voxels
        assert int(search.counts.sum()) < int(vox.mask.sum())
        up = search.levels[1].up_slots
        assert bool((up == len(search.levels[2].occ)).any())


@pytest.mark.parametrize("brick_caps,msg", [
    ((40000, 64), "brick_cap"), ((256, 20000, 64), "parent capacity")])
def test_k11_refuses_what_jax_refuses(brick_caps, msg):
    """Both versions keep `_neighbors`' row-pack budget: what the JAX
    package's asserts refuse, they refuse with a ValueError."""
    keys = torch.full((512,), tbricks.morton.INVALID_KEY, dtype=torch.int32)
    mask = torch.zeros(512, dtype=torch.bool)
    for build in (tbricks.build_pyramid_plain,
                  tbricks.build_pyramid_search_plain):
        with pytest.raises(ValueError, match=msg):
            build(keys, mask, 1, brick_caps, BITS)
    with pytest.raises(AssertionError):
        jbuild_pyramid(jnp.asarray(keys.numpy()), jnp.asarray(mask.numpy()),
                       1, brick_caps, BITS)


# ------------------------------------------------------------------- K12


@pytest.fixture(scope="module")
def pyramids():
    """(B, plain pyramid) for the no-overflow and the overflow case."""
    out = []
    for B, caps in CASES[1:]:
        xyz, counts = clouds(B, seed=30 + B)
        _, pyr = tpipe.preprocess_clouds(torch.from_numpy(xyz),
                                         torch.from_numpy(counts), caps=caps,
                                         voxel_size=VOXEL, window_bits=BITS)
        out.append(pyr)
    return out


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("inverse,k1", [(False, 5), (True, 5), (True, 3)])
def test_k12_rowtap_matches_conv_maps(pyramids, case, inverse, k1):
    """The per-(row, tap) map build, with the cell table built without a
    fill and the inverses with a collision count, against conv_maps and
    invert_map: the 125- and 27-tap maps, down, up and the inverses."""
    pyr = pyramids[case]
    got = tbc.conv_maps_rowtap_plain(pyr, 4, k1, inverse)
    want = tbc.conv_maps_plain(pyr, 4, k1, inverse)
    assert_equal(tuple(got), tuple(want), "maps")
    assert got.first.shape[1] == k1 ** 3
    for lv in pyr.levels:
        assert_equal(tbc.cell_to_voxel_occ_plain(lv), tbc.cell_to_voxel(lv),
                     "cell_to_voxel")
    if inverse:
        M = [lv.cellslot.shape[0] for lv in pyr.levels]
        for l, m in enumerate(want.same3):
            inv, n = tbc.invert_map_counted_plain(m, M[l])
            assert n == 0
            assert_equal(inv, tbc.invert_map(m, M[l]), f"inv same3 {l}")


def test_k12_dropped_diagonal_tap():
    """Voxels (1,1,0) and (2,2,0) lie in diagonal bricks whose face bricks
    are empty: K12's map build drops the tap, as conv_same_map and the JAX
    package do (tests/test_torch_sparse.py::test_dropped_diagonal_tap)."""
    coords = np.asarray([[1, 1, 0], [2, 2, 0]], np.int32)
    xyz = (coords.astype(np.float32) * 0.3 + 0.05)[None]
    _, pyr = tpipe.preprocess_clouds(torch.from_numpy(xyz),
                                     torch.tensor([2], dtype=torch.int32),
                                     caps=(64, 32, 16, 8), voxel_size=VOXEL,
                                     window_bits=jmorton.BITS)
    got = tbc.conv_maps_rowtap_plain(pyr, 4, 3)
    assert_equal(got.same3[0], tbc.conv_same_map(pyr.levels[0], 3), "same3")
    rows = torch.nonzero(pyr.vox_masks[0])[:, 0]
    M = pyr.vox_masks[0].shape[0]
    assert sorted(got.same3[0][rows[0]].tolist()).count(M) == 26  # only self


def test_k12_collisions_raise():
    """A crafted pyramid whose bricks all take one brick as their +z
    neighbour: outputs of different bricks read one input through one tap;
    the map build counts those collisions as invert_map does and raises."""
    xyz, counts = clouds(1, seed=40)
    _, pyr = tpipe.preprocess_clouds(torch.from_numpy(xyz),
                                     torch.from_numpy(counts),
                                     caps=(4096, 1024, 256, 128),
                                     voxel_size=VOXEL, window_bits=BITS)
    lv = pyr.levels[0]
    # the target: the brick with the most voxels at z = 0 within it
    target = int(lv.occ.reshape(-1, 8)[:, 0::2].sum(1).argmax())
    nbr6 = lv.nbr6.clone()
    nbr6[5] = torch.where(lv.bmask, torch.full_like(nbr6[5], target),
                          nbr6[5])
    bad = pyr._replace(levels=(lv._replace(nbr6=nbr6),) + pyr.levels[1:])
    maps = tbc.conv_maps_plain(bad, 4, 5)
    _, n = tbc.invert_map_counted_plain(maps.same3[0], lv.cellslot.shape[0])
    assert n > 0
    with pytest.raises(ValueError, match=f"{n} .input, tap. slots"):
        tbc.invert_map(maps.same3[0], lv.cellslot.shape[0])
    for build in (tbc.conv_maps_plain, tbc.conv_maps_rowtap_plain):
        with pytest.raises(ValueError, match="read by more than one"):
            build(bad, 4, 5, inverse=True)


# -------------------------------------------------------------- dispatch


class _LoaderDown(RuntimeError):
    pass


def meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_pyramid():
    level = tbricks.BrickLevel(meta(16), meta(16, dtype=torch.bool),
                               meta(16), meta(128, dtype=torch.bool),
                               meta(6, 16), meta(64), None)
    return tbricks.BrickPyramid((level,), (meta(64, dtype=torch.bool),))


def test_k10_k12_wrappers_never_fall_back(monkeypatch):
    """A tensor off the CPU goes to the kernel's loader, which raises here:
    no wrapper gives way to its plain version, and nothing is counted."""
    def fail(name, argtypes, symbol=None):
        raise _LoaderDown(name)

    monkeypatch.setattr(kernels, "load", fail)
    before = dict(kernels.launches)
    xyz = meta(2, 64, 3, dtype=torch.float32)
    counts = meta(2)
    with pytest.raises(_LoaderDown, match="voxelize"):
        tvox.voxelize_batched(xyz, counts, VOXEL, 32, BITS)
    with pytest.raises(_LoaderDown, match="voxelize"):
        tpipe.preprocess_clouds(xyz, counts, caps=(32, 16), voxel_size=VOXEL,
                                window_bits=BITS)
    with pytest.raises(_LoaderDown, match="brick_pyramid"):
        tbricks.build_pyramid(meta(64), meta(64, dtype=torch.bool), 2,
                              (16, 8), BITS)
    with pytest.raises(_LoaderDown, match="conv_maps"):
        tbc.conv_maps(meta_pyramid(), 1, 3)
    assert kernels.launches == before
    assert {"voxelize", "brick_pyramid", "conv_maps"} <= set(kernels.KERNELS)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU nothing is built or loaded and nothing is counted: the
    wrappers return what the plain versions return."""
    def fail(name, argtypes, symbol=None):
        raise _LoaderDown(name)

    monkeypatch.setattr(kernels, "load", fail)
    before = dict(kernels.launches)
    xyz, counts = clouds(2, n=1200, seed=50)
    t, n = torch.from_numpy(xyz), torch.from_numpy(counts)
    caps = (1024, 512, 256, 128)
    vox, keys = tvox.voxelize_batched(t, n, VOXEL, caps[0], BITS)
    assert_equal((vox, keys), tvox.voxelize_batched_plain(t, n, VOXEL,
                                                          caps[0], BITS))
    args = (keys, vox.mask.reshape(-1), 2, tpipe.brick_caps(caps), BITS)
    pyr = tbricks.build_pyramid(*args)
    pyramid_equal(pyr, tbricks.build_pyramid_plain(*args))
    assert_equal(tuple(tbc.conv_maps(pyr, 4, 5, inverse=True)),
                 tuple(tbc.conv_maps_plain(pyr, 4, 5, inverse=True)))
    assert kernels.launches == before
