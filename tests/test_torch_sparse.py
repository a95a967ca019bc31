"""eyoc_tpu_torch.sparse against eyoc_tpu.sparse on the same numpy inputs.

Morton keys, voxelize and build_pyramid must be bit-equal. Every conv kind
goes through the port's gather maps and the plain version of kernel K1 and
is compared with the JAX brick conv in f32 (rtol 1e-4): features move
between the two layouts with the JAX package's own vox_to_fb / fb_to_vox.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.sparse import morton as jmorton
from eyoc_tpu.sparse.voxelize import voxelize as jvoxelize
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.sparse import morton as tmorton
from eyoc_tpu_torch.sparse.voxelize import voxelize as tvoxelize
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


BITS = (7, 7, 6)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _f32_convs():
    # module-global JAX state: restore it for the next file in this worker
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def clouds(B, n=3000, seed=0, scale=4.0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, scale, (B, n, 3)).astype(np.float32)
    counts = np.array([n - 400 * b for b in range(B)], np.int32)
    return xyz, counts


def both(xyz, counts, caps, bits=BITS):
    j = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=caps,
                    voxel_size=0.3, window_bits=bits)
    t = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                    caps=caps, voxel_size=0.3, window_bits=bits)
    return j, t


def assert_tree_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        assert np.array_equal(np.asarray(x), y.numpy()), name


# ------------------------------------------------------------------ morton


@pytest.mark.parametrize("bits", [BITS, jmorton.BITS])
def test_morton_encode_decode(bits):
    rng = np.random.default_rng(1)
    c = rng.integers(-600, 600, (2000, 3)).astype(np.int32)
    valid = rng.random(2000) < 0.9
    kj = np.asarray(jmorton.encode(jnp.asarray(c), jnp.asarray(valid), bits))
    kt = tmorton.encode(torch.from_numpy(c), torch.from_numpy(valid), bits)
    assert np.array_equal(kj, kt.numpy())
    assert (kj == jmorton.INVALID_KEY).any()
    assert np.array_equal(np.asarray(jmorton.decode(jnp.asarray(kj))),
                          tmorton.decode(kt).numpy())


# ---------------------------------------------------------------- voxelize


@pytest.mark.parametrize("capacity", [4096, 700])
def test_voxelize_bit_equal(capacity):
    xyz, _ = clouds(1, n=2500, seed=2)
    pts = np.repeat(xyz[0], 2, axis=0)           # duplicate points per voxel
    np.random.default_rng(3).shuffle(pts)
    mask = np.ones(len(pts), bool)
    mask[-100:] = False
    j = jvoxelize(jnp.asarray(pts), jnp.asarray(mask), 0.3, capacity, BITS)
    t = tvoxelize(torch.from_numpy(pts), torch.from_numpy(mask), 0.3,
                  capacity, BITS)
    assert_tree_equal(j, t)
    if capacity == 700:
        assert int(t.count) == 700               # overflow saturates


# ----------------------------------------------------------------- pyramid


@pytest.mark.parametrize("B,caps", [
    (1, (4096, 1024, 256, 128)),
    (2, (2048, 768, 256, 96)),
    (2, (2048, 256, 64, 32)),        # brick capacities overflow
])
def test_pyramid_bit_equal(B, caps):
    xyz, counts = clouds(B, seed=10 + B)
    (jvox, jpyr), (tvox, tpyr) = both(xyz, counts, caps)
    assert_tree_equal(jvox, tvox)
    for lj, lt in zip(jpyr.levels, tpyr.levels):
        assert_tree_equal(lj, lt)
    for mj, mt in zip(jpyr.vox_masks, tpyr.vox_masks):
        assert np.array_equal(np.asarray(mj), mt.numpy())
    if caps[1] == 256:   # the overflow case really drops voxels
        assert int(tvox.count.sum()) < int((tvox.src < xyz.shape[1]).sum())


def test_take_rows_sentinel_reads_zero():
    from eyoc_tpu.sparse.bricks import take_rows as jtake
    from eyoc_tpu_torch.sparse.bricks import take_rows as ttake
    rng = np.random.default_rng(4)
    arr = rng.normal(size=(50, 3, 2)).astype(np.float32)
    idx = rng.integers(0, 51, 200).astype(np.int32)   # 50 = the sentinel
    assert (idx == 50).any()
    got = ttake(torch.from_numpy(arr), torch.from_numpy(idx)).numpy()
    assert np.array_equal(got, np.asarray(jtake(jnp.asarray(arr),
                                                jnp.asarray(idx))))
    assert not got[idx == 50].any()


# ------------------------------------------------------------------- convs


@pytest.fixture(scope="module")
def pyramids():
    xyz, counts = clouds(2, seed=20)
    return both(xyz, counts, (2048, 768, 256, 96))


def feats(mask, C, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((len(mask), C)).astype(np.float32)
    f[~mask] = 0.0
    return f


def weights(T, Ci, Co, seed):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((T, Ci, Co)) * 0.3).astype(np.float32)
    return W, rng.standard_normal(Co).astype(np.float32)


def compare(jout_vox, tout, mask, masked):
    want = np.asarray(jout_vox)
    got = tout.numpy()
    rows = slice(None) if masked else mask      # unmasked: valid rows only
    np.testing.assert_allclose(got[rows], want[rows], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("level,k", [(0, 3), (0, 5), (1, 3), (2, 3), (3, 3)])
def test_conv_same(pyramids, level, k, masked):
    (_, jpyr), (_, tpyr) = pyramids
    maps = tbc.conv_maps(tpyr, 4, 5)
    lv, m = jpyr.levels[level], tpyr.vox_masks[level]
    f = feats(m.numpy(), 4, level + k)
    W, b = weights(k ** 3, 4, 6, level)
    bias = b if masked else None
    jo = jbc.conv_same(jbc.vox_to_fb(lv, jnp.asarray(f)), lv, jnp.asarray(W),
                       k=k, bias=None if bias is None else jnp.asarray(bias),
                       mask_output=masked)
    nmap = maps.first if k == 5 else maps.same3[level]
    to = tbc.sparse_conv(torch.from_numpy(f), torch.from_numpy(W), nmap,
                         bias=None if bias is None else torch.from_numpy(bias),
                         mask=m if masked else None)
    compare(jbc.fb_to_vox(lv, jo, 6), to, m.numpy(), masked)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_conv_down(pyramids, level, masked):
    (_, jpyr), (_, tpyr) = pyramids
    maps = tbc.conv_maps(tpyr, 4, 5)
    lv, nxt = jpyr.levels[level], jpyr.levels[level + 1]
    f = feats(tpyr.vox_masks[level].numpy(), 4, 30 + level)
    W, b = weights(27, 4, 6, 40 + level)
    jo = jbc.conv_down(jbc.vox_to_fb(lv, jnp.asarray(f)), lv, nxt,
                       jnp.asarray(W),
                       bias=jnp.asarray(b) if masked else None,
                       mask_output=masked)
    m1 = tpyr.vox_masks[level + 1]
    to = tbc.sparse_conv(torch.from_numpy(f), torch.from_numpy(W),
                         maps.down[level],
                         bias=torch.from_numpy(b) if masked else None,
                         mask=m1 if masked else None)
    compare(jbc.fb_to_vox(nxt, jo, 6), to, m1.numpy(), masked)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_conv_up(pyramids, level, masked):
    (_, jpyr), (_, tpyr) = pyramids
    maps = tbc.conv_maps(tpyr, 4, 5)
    fine, coarse = jpyr.levels[level], jpyr.levels[level + 1]
    f = feats(tpyr.vox_masks[level + 1].numpy(), 4, 50 + level)
    W, b = weights(27, 4, 6, 60 + level)
    jo = jbc.conv_up(jbc.vox_to_fb(coarse, jnp.asarray(f)), fine,
                     jnp.asarray(W), bias=jnp.asarray(b) if masked else None,
                     mask_output=masked)
    m = tpyr.vox_masks[level]
    to = tbc.sparse_conv(torch.from_numpy(f), torch.from_numpy(W),
                         maps.up[level],
                         bias=torch.from_numpy(b) if masked else None,
                         mask=m if masked else None)
    compare(jbc.fb_to_vox(fine, jo, 6), to, m.numpy(), masked)


@pytest.mark.parametrize("masked", [True, False])
def test_conv1x1_and_skip_concat(pyramids, masked):
    """conv1x1 over the decoder's skip concat: fb_concat + conv1x1 in JAX,
    one K1 call with two inputs and the identity map in the port."""
    (_, jpyr), (_, tpyr) = pyramids
    lv, m = jpyr.levels[0], tpyr.vox_masks[0]
    fa = feats(m.numpy(), 3, 70)
    fb = feats(m.numpy(), 5, 71)
    W, b = weights(1, 8, 6, 72)
    cat = jbc.fb_concat(jbc.vox_to_fb(lv, jnp.asarray(fa)), 3,
                        jbc.vox_to_fb(lv, jnp.asarray(fb)), 5)
    jo = jbc.conv1x1(cat, jnp.asarray(W[0]),
                     bias=jnp.asarray(b) if masked else None,
                     level=lv if masked else None)
    to = tbc.sparse_conv(torch.from_numpy(fa), torch.from_numpy(W),
                         tbc.identity_map(len(m), "cpu"),
                         x2=torch.from_numpy(fb),
                         bias=torch.from_numpy(b) if masked else None,
                         mask=m if masked else None)
    compare(jbc.fb_to_vox(lv, jo, 6), to, m.numpy(), masked)


def test_residual_relu_epilogue(pyramids):
    """The block epilogue relu(conv + bias + residual) against JAX."""
    (_, jpyr), (_, tpyr) = pyramids
    lv, m = jpyr.levels[1], tpyr.vox_masks[1]
    maps = tbc.conv_maps(tpyr, 4, 5)
    f = feats(m.numpy(), 6, 80)
    W, b = weights(27, 6, 6, 81)
    fbj = jbc.vox_to_fb(lv, jnp.asarray(f))
    jo = jnp.maximum(jbc.conv_same(fbj, lv, jnp.asarray(W),
                                   bias=jnp.asarray(b)) + fbj, 0.0)
    tf = torch.from_numpy(f)
    to = tbc.sparse_conv(tf, torch.from_numpy(W), maps.same3[1],
                         bias=torch.from_numpy(b), mask=m, residual=tf,
                         relu=True)
    compare(jbc.fb_to_vox(lv, jo, 6), to, m.numpy(), True)


def test_dropped_diagonal_tap():
    """Voxels (1,1,0) and (2,2,0) are neighbours in diagonal bricks whose
    face bricks are empty: both packages drop the tap (exact conv: 2)."""
    coords = np.asarray([[1, 1, 0], [2, 2, 0]], np.int32)
    xyz = (coords.astype(np.float32) * 0.3 + 0.05)[None]
    counts = np.array([2], np.int32)
    (jvox, jpyr), (tvox, tpyr) = both(xyz, counts, (64, 32, 16, 8),
                                      bits=jmorton.BITS)
    m = tpyr.vox_masks[0]
    f = m.numpy()[:, None].astype(np.float32)
    W = np.ones((27, 1, 1), np.float32)
    lv = jpyr.levels[0]
    jo = jbc.fb_to_vox(lv, jbc.conv_same(jbc.vox_to_fb(lv, jnp.asarray(f)),
                                         lv, jnp.asarray(W)), 1)
    to = tbc.sparse_conv(torch.from_numpy(f), torch.from_numpy(W),
                         tbc.conv_same_map(tpyr.levels[0], 3), mask=m)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy()[m.numpy(), 0], [1.0, 1.0])
