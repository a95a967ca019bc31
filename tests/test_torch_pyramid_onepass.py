"""K11's one pass (`build_pyramid_onepass_plain`: every level's skeleton
from per-level counts and the last valid key over the level-0 rows, tile
by tile with a carried state) on crafted level-0 rows, against eyoc_tpu's
build_pyramid under jax.jit and the port's plain version: B of 1, 3 and
8, capacities cut at every level and inside a tile, an empty cloud, a
cloud whose rows are all masked, and masks with masked rows between
voxels of one brick (each such row starts a new brick, as `_skeleton`
does). Every index and mask is compared bit for bit; K12's staged map
build is held to the plain maps on the masked pyramids."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse.bricks import build_pyramid as jbuild_pyramid
from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.sparse import bricks as tbricks
from eyoc_tpu_torch.sparse import morton


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


BITS = (7, 7, 6)
CAP0 = 384
# (clouds, brick caps): none cut; every level cut (the clouds below hold
# 170-260 level-0 bricks, 140-220 level-1, 75-95 level-2, 18 level-3)
CASES = [(1, (256, 256, 128, 32)), (3, (256, 256, 128, 32)),
         (8, (150, 60, 20, 4))]


def level0_rows(B, seed):
    """[B * CAP0] sorted Morton keys and masks: clouds of 100 cells of a
    dense 6 x 6 x 6 box (bricks of several voxels) and 150-250 cells spread
    over 48 x 48 x 24 (many bricks at every level), valid rows first; cloud
    1 (B > 1) is empty (INVALID keys, masked); cloud 2 (B > 2) keeps its
    keys but masks every row; clouds 3 and 5 mask a fifth of their rows at
    random, so that masked rows fall between voxels of one brick."""
    rng = np.random.default_rng(seed)
    keys = np.full((B, CAP0), morton.INVALID_KEY, np.int32)
    mask = np.zeros((B, CAP0), bool)
    for b in range(B):
        cells = np.concatenate([
            rng.integers(0, 6, (100, 3)) + 30,
            rng.integers(0, (48, 48, 24), (rng.integers(150, 250), 3)) + 16])
        cells = np.unique(cells, axis=0)
        key = np.sort(((_spread(cells[:, 0]) << 2) | (_spread(cells[:, 1])
                                                      << 1)
                       | _spread(cells[:, 2])).astype(np.int32))
        keys[b, :len(key)] = key
        mask[b, :len(key)] = True
        if b in (3, 5):
            mask[b] &= rng.random(CAP0) > 0.2
    if B > 1:
        keys[1], mask[1] = morton.INVALID_KEY, False
    if B > 2:
        mask[2] = False
    return keys.reshape(-1), mask.reshape(-1)


def _spread(v):
    v = v.astype(np.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


@functools.lru_cache(maxsize=None)
def _jit_pyramid(B, brick_caps):
    return jax.jit(lambda k, m: jbuild_pyramid(k, m, B, brick_caps, BITS))


def assert_equal(a, b, what=""):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, tuple):
        assert len(a) == len(b), what
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            assert_equal(x, y, f"{what}.{name}")
        return
    x = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    y = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape, what
    assert np.array_equal(x, y), f"{what}: {int((x != y).sum())} differ"


def pyramid_equal(a, b, what):
    assert len(a.levels) == len(b.levels)
    for l, (x, y) in enumerate(zip(a.levels, b.levels)):
        assert_equal(tuple(x), tuple(y), f"{what} level {l}")
    assert_equal(tuple(a.vox_masks), tuple(b.vox_masks), f"{what} masks")


def level0_starts(keys, mask, B):
    """[B, CAP0] bool: the rows where a level-0 brick starts (numpy)."""
    k, m = keys.reshape(B, CAP0), mask.reshape(B, CAP0)
    bk = np.where(m, k >> 3, morton.INVALID_KEY)
    prev = np.concatenate([np.full((B, 1), -1), bk[:, :-1]], 1)
    return m & (bk != prev)


@pytest.mark.parametrize("B,caps", CASES)
@pytest.mark.parametrize("tile", [7, 64, 4096])
def test_onepass_matches_jax_and_plain(B, caps, tile):
    keys, mask = level0_rows(B, seed=B)
    tk, tm = torch.from_numpy(keys), torch.from_numpy(mask)
    got = tbricks.build_pyramid_onepass_plain(tk, tm, B, caps, BITS, tile)
    plain = tbricks.build_pyramid_plain(tk, tm, B, caps, BITS)
    jp = _jit_pyramid(B, caps)(jnp.asarray(keys), jnp.asarray(mask))
    pyramid_equal(got, plain, "plain")
    pyramid_equal(got, jp, "jax")
    assert_equal(got.counts, plain.counts, "counts")
    bmask = [lv.bmask.reshape(B, -1).sum(1) for lv in got.levels]
    if B > 1:                       # the empty and the all-masked cloud
        assert int(got.counts[1]) == int(got.counts[2]) == 0
        assert all(int(n[1]) == int(n[2]) == 0 for n in bmask)
    if B == 8:
        # every level cut in some cloud; the level-0 cut inside a tile
        assert all(bool((n == bc).any()) for n, bc in zip(bmask, caps))
        starts = level0_starts(keys, mask, B)
        cut = [np.flatnonzero(s)[caps[0]] for s in starts
               if s.sum() > caps[0]]
        assert cut and any(c % tile for c in cut)
        # masked rows between voxels of one brick start a new brick there
        k, m = keys.reshape(B, CAP0), mask.reshape(B, CAP0)
        gap = (~m[3, 1:-1] & m[3, :-2] & m[3, 2:]
               & (k[3, :-2] >> 3 == k[3, 2:] >> 3))
        assert gap.any()


@pytest.mark.parametrize("tile", [1, 5, 384])
def test_onepass_counts_carry_across_tiles(tile):
    """The per-field counts of `_onepass_counts_plain` do not depend on the
    tile: the carried state (counts, last valid key) joins the tiles."""
    keys, mask = level0_rows(8, seed=3)
    k = torch.from_numpy(keys).reshape(8, CAP0)
    m = torch.from_numpy(mask).reshape(8, CAP0)
    f, c = tbricks._onepass_counts_plain(k, m, 4, tile)
    f1, c1 = tbricks._onepass_counts_plain(k, m, 4, CAP0)
    assert torch.equal(f, f1) and torch.equal(c, c1)
    # field 0 counts the valid rows, field 1 the level-0 brick starts
    assert torch.equal(c[..., 0], torch.cumsum(m.to(torch.int32), 1,
                                               dtype=torch.int32))
    starts = torch.from_numpy(level0_starts(keys, mask, 8))
    assert torch.equal(f[..., 1], starts)


def test_staged_maps_on_masked_pyramids():
    """K12's staged map build on the pyramids of masked rows between
    voxels of one brick (duplicate level-1 cells included) and of the
    empty and all-masked clouds, against the plain maps."""
    caps = CASES[2][1]
    keys, mask = level0_rows(8, seed=8)
    pyr = tbricks.build_pyramid_plain(torch.from_numpy(keys),
                                      torch.from_numpy(mask), 8, caps, BITS)
    for k1, inverse in ((5, False), (3, False)):
        assert_equal(tuple(tbc.conv_maps_staged_plain(pyr, 4, k1, inverse)),
                     tuple(tbc.conv_maps_plain(pyr, 4, k1, inverse)),
                     f"k1={k1}")
