"""K5's narrow-input route (taps packed into M) at a first conv of side 7:
T = 343 taps of one input channel (K5's M = 343, three tiles of
K5_PACKED_BM), and of 3 (rgb, M = 1029), as plain torch
(`sparse_conv_wgrad_tap_packed_plain`) against `sparse_conv_wgrad_plain`
and jax.grad of JAX's conv_same(k=7) with respect to W, f32, rtol 1e-4 and
atol 1e-4 (tests/test_torch_wgrad_tc.py's tolerances).

The outputs of one cell of a brick reach 216 of the 343 taps: with dY
nonzero only at the rows of cell (0, 0, 0), the 127 taps past that cell's
reach (an offset of -3 on some axis) take a dW of exactly 0 on both sides.
Over all eight cells every tap is read by some output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.sparse import brick_conv as tbc
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


CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)
RTOL, ATOL = 1e-4, 1e-4
CO = 32


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


@pytest.fixture(scope="module")
def level0():
    rng = np.random.default_rng(27)
    xyz = rng.normal(0, 3, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2600], np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    return jpyr.levels[0], tpyr, tbc.conv_maps(tpyr, 4, 7).first


def case(level0, ci, seed, cell0=False):
    """(x, dY, map, jax.grad's dW): x with garbage at invalid rows (the
    map never reads them; JAX takes zeros there), dY N(0, 1) at the valid
    rows (only those of cell (0, 0, 0) with `cell0`)."""
    lv, tpyr, nmap = level0
    m = tpyr.vox_masks[0].numpy()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(m), ci)).astype(np.float32)
    x[~m] = 7.0
    keep = m & ((tpyr.levels[0].cellslot.numpy() & 7) == 0) if cell0 else m
    dy = np.where(keep[:, None], rng.standard_normal((len(m), CO)), 0.0)
    dy = dy.astype(np.float32)
    W = (rng.standard_normal((343, ci, CO)) * 0.3).astype(np.float32)
    xj = jnp.asarray(np.where(m[:, None], x, 0.0))

    def loss(W):
        out = jbc.fb_to_vox(lv, jbc.conv_same(jbc.vox_to_fb(lv, xj), lv, W,
                                              k=7, mask_output=False), CO)
        return jnp.sum(out * dy)
    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(W)))
    return torch.from_numpy(x), torch.from_numpy(dy), nmap, want


@pytest.mark.parametrize("ci", [1, 3])
def test_tap_packed_side7(level0, ci):
    x, dy, nmap, want = case(level0, ci, 30 + ci)
    plan = tbc.k5_plan(nmap.shape[0], 343, ci, 0, CO)
    assert plan.packed and plan.bm == tbc.K5_PACKED_BM
    got = tbc.sparse_conv_wgrad_tap_packed_plain(x, dy, nmap)
    np.testing.assert_allclose(got, tbc.sparse_conv_wgrad_plain(x, dy, nmap),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # every tap is read by some output, so every tap takes a gradient
    assert bool((got.abs().sum((1, 2)) > 0).all())


def test_taps_past_one_cells_reach_take_no_gradient(level0):
    x, dy, nmap, want = case(level0, 1, 40, cell0=True)
    got = tbc.sparse_conv_wgrad_tap_packed_plain(x, dy, nmap)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    off = np.asarray(tbc._offsets(7))
    past = (off == -3).any(1)                 # cell 0 reaches [-2, 3]
    assert int(past.sum()) == 127
    assert not got[torch.from_numpy(past)].any()
    assert not want[past].any()
