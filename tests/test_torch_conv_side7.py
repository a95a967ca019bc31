"""A first conv of side 7 (FCGF's published 3DMatch model): both packages
reach 216 of the 343 taps of each output, the taps within one brick of
the output's own (the JAX halo, `_conv_src_for_cells(halo_order(3)[0], 7)`;
the port's maps, `brick_conv._beyond_reach`), and read zero at the other
127. MinkowskiEngine reads all 343.

- On a dense 12^3 block of voxels at 0.3 m, against a brute-force
  neighbour lookup: every side-5 tap names its neighbour; every side-7 tap
  names its neighbour where the output's cell plus the offset lies in
  [-2, 3]^3 of its brick, and the sentinel elsewhere, in the plain map,
  the dispatching `conv_maps` and K12's staged reformulation alike (the
  same bits); each interior output reaches exactly 216 voxels.
- JAX's halo reaches 216 taps of each output cell.
- JAX's `conv_same(k=7)` in f32 against the port's plain conv and its
  packed-taps form over the side-7 map, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.sparse.brick_conv import CELLS, _conv_src_for_cells, halo_order
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.sparse.brick_conv import (_cell_coords, _offsets,
                                              conv_maps,
                                              conv_maps_staged_plain,
                                              conv_same_map,
                                              sparse_conv_plain,
                                              sparse_conv_tap_packed_plain)
from eyoc_tpu_torch.training.pipeline import preprocess_clouds


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDE = 12                              # voxels a side of the dense block
CAPS = (2048, 512, 128, 64)
BITS = (7, 7, 7)
ATOL = 1e-4


def block_xyz():
    g = np.stack(np.meshgrid(*[np.arange(SIDE)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    xyz = np.zeros((1, 4096, 3), np.float32)
    xyz[0, :len(g)] = g * 0.3 + 0.15
    return xyz, np.array([len(g)], np.int32)


@pytest.fixture(scope="module")
def dense_block():
    xyz, n = block_xyz()
    return preprocess_clouds(torch.from_numpy(xyz), torch.from_numpy(n),
                             caps=CAPS, voxel_size=0.3, window_bits=BITS)


def brute_map(vox, pyr, k):
    """[M, k^3] the map a side-k conv should read on the block: the voxel
    at c + off by a lookup of the voxels' coordinates, where the output's
    cell u plus off lies in [-2, 3]^3 (one brick around its own), else the
    sentinel M; an invalid row reads the sentinel at every tap."""
    M = pyr.levels[0].cellslot.shape[0]
    valid = vox.mask[0].numpy()
    c = np.floor(vox.xyz[0].numpy() / 0.3).astype(np.int64) + 16
    key = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    order = np.argsort(np.where(valid, key, -1))
    skey = np.where(valid, key, -1)[order]
    rows = np.where(valid)[0]
    off = np.asarray(_offsets(k))
    q = c[rows][:, None, :] + off[None]
    qkey = (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]
    pos = np.clip(np.searchsorted(skey, qkey), 0, M - 1)
    found = np.where(skey[pos] == qkey, order[pos], M)
    _, u = _cell_coords(pyr.levels[0].cellslot)
    p = u.numpy()[rows][:, None, :] + off[None]
    reach = ((p >= -2) & (p <= 3)).all(-1)
    want = np.full((M, k ** 3), M, np.int64)
    want[rows] = np.where(reach, found, M)
    return want, rows, c[rows] - 16


def test_side5_reaches_every_neighbour(dense_block):
    vox, pyr = dense_block
    want, rows, _ = brute_map(vox, pyr, 5)
    assert len(rows) == SIDE ** 3
    assert np.array_equal(conv_same_map(pyr.levels[0], 5).numpy(), want)


@pytest.mark.parametrize("build", [
    lambda vox, pyr: conv_same_map(pyr.levels[0], 7),
    lambda vox, pyr: conv_maps(pyr, 4, 7).first,
    lambda vox, pyr: conv_maps_staged_plain(pyr, 4, 7).first,
], ids=["conv_same_map", "conv_maps", "conv_maps_staged_plain"])
def test_side7_refused_on_the_host(dense_block, build):
    """Each side-7 tap on the dense block names the brute-force neighbour
    where the output's cell plus the offset lies in [-2, 3]^3, and the
    sentinel elsewhere (no tap names a wrong voxel): the same map, bit for
    bit, from each of the three. Every output at least 3 voxels inside the
    block reaches exactly 216 voxels, each of its in-reach taps. (The name
    is the one this test had while side 7 was refused; it is kept so that
    its results compare across versions.)"""
    vox, pyr = dense_block
    want, rows, g = brute_map(vox, pyr, 7)
    got = build(vox, pyr)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    M = want.shape[0]
    inside = ((g >= 3) & (g < SIDE - 3)).all(1)
    assert int(inside.sum()) == (SIDE - 6) ** 3
    assert ((want[rows][inside] != M).sum(1) == 216).all()


def test_jax_side7_reaches_216_taps():
    src = _conv_src_for_cells(tuple(halo_order(3)[0]), 7)
    for u in range(len(CELLS)):
        taps = set(int(t) for t in src[:, u]) - {7 ** 3}
        assert len(taps) == 216


@pytest.fixture
def _f32_convs():
    # module-global JAX state: restore it for the next file in this worker
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


@pytest.mark.parametrize("ci", [1, 3])
def test_side7_conv_matches_jax(_f32_convs, ci):
    """JAX conv_same(k=7) on a cloud with gaps (the dropped diagonal taps
    too) against sparse_conv_plain and sparse_conv_tap_packed_plain over
    the port's side-7 map, f32, within 1e-4 at every row."""
    rng = np.random.default_rng(70 + ci)
    xyz = rng.normal(0, 2.0, (1, 1500, 3)).astype(np.float32)
    n = np.array([1500], np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(n), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = preprocess_clouds(torch.from_numpy(xyz), torch.from_numpy(n),
                                caps=CAPS, voxel_size=0.3, window_bits=BITS)
    mask = tpyr.vox_masks[0].numpy()
    f = rng.standard_normal((len(mask), ci)).astype(np.float32)
    f[~mask] = 0.0
    W = (rng.standard_normal((343, ci, 8)) * 0.3).astype(np.float32)
    lv = jpyr.levels[0]

    @jax.jit
    def jconv(f, W):
        return jbc.fb_to_vox(lv, jbc.conv_same(jbc.vox_to_fb(lv, f), lv, W,
                                               k=7), 8)

    want = np.asarray(jconv(jnp.asarray(f), jnp.asarray(W)))
    nmap = conv_maps(tpyr, 4, 7).first
    m = torch.from_numpy(mask)
    for conv in (sparse_conv_plain, sparse_conv_tap_packed_plain):
        got = conv(torch.from_numpy(f), torch.from_numpy(W), nmap,
                   mask=m).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert float(np.abs(want).max()) > 1.0
