"""A first conv of side 7 (FCGF's published 3DMatch model), which neither
package computes in full (ROADMAP.md queue 1 item 8):

- the port's conv maps read one brick around each output. On a dense 12^3
  block of voxels at 0.3 m, against a brute-force neighbour lookup, every
  side-5 tap names its neighbour; a side-7 map is refused on the host as
  on the card (`check_conv_side`), since its taps two bricks away would
  name another voxel;
- JAX's conv reaches 216 of the 343 taps of each output cell
  (`_conv_src_for_cells(halo_order(3)[0], 7)`: its halo stops at one
  brick), the other 127 weights never read.

These tests hold the two behaviours until that decision; they change with
it.
"""

import numpy as np
import pytest
import torch

from eyoc_tpu.sparse.brick_conv import CELLS, _conv_src_for_cells, halo_order
from eyoc_tpu_torch.sparse.brick_conv import (_offsets, conv_maps,
                                              conv_maps_staged_plain,
                                              conv_same_map)
from eyoc_tpu_torch.training.pipeline import preprocess_clouds


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense_block():
    g = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    xyz = np.zeros((1, 4096, 3), np.float32)
    xyz[0, :len(g)] = g * 0.3 + 0.15
    vox, pyr = preprocess_clouds(torch.from_numpy(xyz),
                                 torch.tensor([len(g)], dtype=torch.int32),
                                 caps=(2048, 512, 128, 64), voxel_size=0.3,
                                 window_bits=(7, 7, 7))
    return vox, pyr


def tap_outcomes(vox, pyr, k):
    """(right, wrong voxel, sentinel) counts of the side-k map's taps on
    the valid voxels against the brute-force neighbour (the sentinel M
    where there is none)."""
    m = conv_same_map(pyr.levels[0], k).numpy()
    M = m.shape[0]
    valid = vox.mask[0].numpy()
    c = np.floor(vox.xyz[0].numpy() / 0.3).astype(np.int64) + 16
    key = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    order = np.argsort(np.where(valid, key, -1))
    skey = np.where(valid, key, -1)[order]
    rows = np.where(valid)[0]
    q = c[rows][:, None, :] + np.asarray(_offsets(k))[None]
    qkey = (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]
    pos = np.clip(np.searchsorted(skey, qkey), 0, M - 1)
    want = np.where(skey[pos] == qkey, order[pos], M)
    got = m[rows]
    return (int((got == want).sum()),
            int(((got != want) & (got != M)).sum()),
            int(((got != want) & (got == M)).sum()))


def test_side5_reaches_every_neighbour(dense_block):
    assert tap_outcomes(*dense_block, 5) == (1728 * 125, 0, 0)


@pytest.mark.parametrize("build", [
    lambda vox, pyr: conv_same_map(pyr.levels[0], 7),
    lambda vox, pyr: conv_maps(pyr, 4, 7),
    lambda vox, pyr: conv_maps_staged_plain(pyr, 4, 7),
], ids=["conv_same_map", "conv_maps", "conv_maps_staged_plain"])
def test_side7_refused_on_the_host(dense_block, build):
    with pytest.raises(ValueError, match="side 7"):
        build(*dense_block)


def test_jax_side7_reaches_216_taps():
    src = _conv_src_for_cells(tuple(halo_order(3)[0]), 7)
    for u in range(len(CELLS)):
        taps = set(int(t) for t in src[:, u]) - {7 ** 3}
        assert len(taps) == 216
