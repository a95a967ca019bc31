"""K5's tensor-core reformulations, as the plain torch emulations in
eyoc_tpu_torch.sparse.brick_conv, against `sparse_conv_wgrad_plain` and
jax.grad of the JAX brick convs with respect to W on the same numpy inputs
(f32: rtol 1e-4, atol 1e-4, sums of up to a few thousand products in
another order), and the launch planner's grid against every K5 shape of
ResUNetBN2C's train step.

- the row split, partials added in split order: same (levels 0 and 1) and
  down convs at several split sizes;
- the narrow route (taps packed into M): conv1 at k = 5 with one input
  channel, and a narrow skip concat;
- a skip-concat input (`xb`) over conv_up, split;
- k-slices whose rows all read the sentinel, which the kernel skips.
dW is written in its own layout ([T, Ci, Co] = [T*Ci, Co]), so the packed
route repacks nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.models import load_model
from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess

CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(21)
    xyz = rng.normal(0, 4, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2600], np.int32)
    j = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                    voxel_size=0.3, window_bits=BITS)
    t = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                    caps=CAPS, voxel_size=0.3, window_bits=BITS)
    return j[1], t[1], tbc.conv_maps(t[1], 4, 5)


def rows(mask, C, seed, garbage=True):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((len(mask), C)).astype(np.float32)
    f[~mask] = 7.0 if garbage else 0.0
    return f


def weights(T, Ci, Co, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, Ci, Co)) * 0.3).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def t(a):
    return None if a is None else torch.from_numpy(a)


def jax_dw(conv, xs, masks, W, w):
    """jax.grad of sum(conv(inputs, W) * w) with respect to W; the inputs
    are zero at invalid rows (the JAX layout has no such rows)."""
    xs = [jnp.asarray(np.where(m[:, None], x, 0.0)) for x, m in zip(xs, masks)]
    return jax.jit(jax.grad(lambda W: jnp.sum(conv(*xs, W) * w)))(
        jnp.asarray(W))


def same_case(pyramids, level, k, Ci, Co, seed):
    jpyr, tpyr, maps = pyramids
    lv, m = jpyr.levels[level], tpyr.vox_masks[level].numpy()
    x, w = rows(m, Ci, seed), rows(m, Co, seed + 1, garbage=False)
    W = weights(k ** 3, Ci, Co, seed + 2)

    def conv(x, W):
        return jbc.fb_to_vox(lv, jbc.conv_same(jbc.vox_to_fb(lv, x), lv, W,
                                               k=k, mask_output=False), Co)
    want = jax_dw(conv, [x], [m], W, w)
    nmap = maps.first if k == 5 else maps.same3[level]
    return x, w, nmap, want


def down_case(pyramids, level, Ci, Co, seed):
    jpyr, tpyr, maps = pyramids
    lv, nxt = jpyr.levels[level], jpyr.levels[level + 1]
    m, m1 = tpyr.vox_masks[level].numpy(), tpyr.vox_masks[level + 1].numpy()
    x, w = rows(m, Ci, seed), rows(m1, Co, seed + 1, garbage=False)
    W = weights(27, Ci, Co, seed + 2)

    def conv(x, W):
        return jbc.fb_to_vox(nxt, jbc.conv_down(jbc.vox_to_fb(lv, x), lv, nxt,
                                                W, mask_output=False), Co)
    return x, w, maps.down[level], jax_dw(conv, [x], [m], W, w)


def up_case(pyramids, level, ca, cb, Co, seed):
    """The decoder's conv_up over fb_concat(decoder, skip) at level l+1."""
    jpyr, tpyr, maps = pyramids
    fine, coarse = jpyr.levels[level], jpyr.levels[level + 1]
    mc, mf = tpyr.vox_masks[level + 1].numpy(), tpyr.vox_masks[level].numpy()
    xa, xb = rows(mc, ca, seed), rows(mc, cb, seed + 1)
    w = rows(mf, Co, seed + 2, garbage=False)
    W = weights(27, ca + cb, Co, seed + 3)

    def conv(xa, xb, W):
        cat = jbc.fb_concat(jbc.vox_to_fb(coarse, xa), ca,
                            jbc.vox_to_fb(coarse, xb), cb)
        return jbc.fb_to_vox(fine, jbc.conv_up(cat, fine, W,
                                               mask_output=False), Co)
    return xa, xb, w, maps.up[level], jax_dw(conv, [xa, xb], [mc, mc], W, w)


# ---------------------------------------------------------- the row split


@pytest.mark.parametrize("rows_per_split", [32, 96, 512])
@pytest.mark.parametrize("level", [0, 1])
def test_row_split_same_conv(pyramids, level, rows_per_split):
    x, w, nmap, want = same_case(pyramids, level, 3, 8, 16, 10 + level)
    got = tbc.sparse_conv_wgrad_split_plain(t(x), t(w), nmap, rows_per_split)
    close(got, tbc.sparse_conv_wgrad_plain(t(x), t(w), nmap))
    close(got, want)


@pytest.mark.parametrize("rows_per_split", [64, 256])
def test_row_split_down_conv(pyramids, rows_per_split):
    x, w, nmap, want = down_case(pyramids, 0, 16, 8, 20)
    got = tbc.sparse_conv_wgrad_split_plain(t(x), t(w), nmap, rows_per_split)
    close(got, tbc.sparse_conv_wgrad_plain(t(x), t(w), nmap))
    close(got, want)


def test_row_split_as_planned(pyramids):
    """The split that k5_plan picks for a level-0 same conv."""
    x, w, nmap, want = same_case(pyramids, 0, 3, 8, 8, 25)
    plan = tbc.k5_plan(nmap.shape[0], 27, 8, 0, 8)
    assert not plan.packed and plan.splits > 1
    got = tbc.sparse_conv_wgrad_split_plain(t(x), t(w), nmap,
                                            plan.rows_per_split)
    close(got, want)


# -------------------------------------------------------- the narrow route


def test_tap_packed_conv1(pyramids):
    """conv1: k = 5, one input channel, 125 taps packed into M = 128."""
    x, w, nmap, want = same_case(pyramids, 0, 5, 1, 32, 30)
    assert tbc.k5_plan(nmap.shape[0], 125, 1, 0, 32).packed
    got = tbc.sparse_conv_wgrad_tap_packed_plain(t(x), t(w), nmap)
    close(got, tbc.sparse_conv_wgrad_plain(t(x), t(w), nmap))
    close(got, want)


def test_tap_packed_narrow_skip_concat(pyramids):
    """A narrow skip concat (3 + 5 channels) over conv_up: T*Ci = 216 rows
    of dW, two packed tiles."""
    xa, xb, w, nmap, want = up_case(pyramids, 0, 3, 5, 8, 40)
    plan = tbc.k5_plan(nmap.shape[0], 27, 3, 5, 8)
    assert plan.packed and plan.bm == tbc.K5_PACKED_BM
    got = tbc.sparse_conv_wgrad_tap_packed_plain(t(xa), t(w), nmap, x2=t(xb))
    close(got, tbc.sparse_conv_wgrad_plain(t(xa), t(w), nmap, x2=t(xb)))
    close(got, want)


# ------------------------------------------------------ the skip concat


@pytest.mark.parametrize("rows_per_split", [32, 160])
@pytest.mark.parametrize("level", [0, 1])
def test_skip_concat_conv_up_split(pyramids, level, rows_per_split):
    xa, xb, w, nmap, want = up_case(pyramids, level, 16, 8, 8, 50 + level)
    assert not tbc.k5_plan(nmap.shape[0], 27, 16, 8, 8).packed
    got = tbc.sparse_conv_wgrad_split_plain(t(xa), t(w), nmap,
                                            rows_per_split, x2=t(xb))
    close(got, tbc.sparse_conv_wgrad_plain(t(xa), t(w), nmap, x2=t(xb)))
    close(got, want)


# ------------------------------------------------ sentinel-only k-slices


def test_sentinel_only_slices_are_skipped(pyramids):
    """Rows [32, 96) read the sentinel through every tap: their k-slices
    are dead, the split walk skips them, and dW is that of the map without
    those rows (the dense per-row oracle in f64)."""
    _, tpyr, maps = pyramids
    m = tpyr.vox_masks[0].numpy()
    nmap = maps.same3[0].clone()
    M_in = nmap.shape[0]
    nmap[32:96] = M_in
    live = tbc.k5_live_slices(nmap, M_in)
    assert not live[:, 1:3].any() and live[:, 0].any() and live[:, 3].any()
    x, w = rows(m, 8, 60), rows(m, 8, 61, garbage=False)
    got = tbc.sparse_conv_wgrad_split_plain(t(x), t(w), nmap, 64)
    close(got, tbc.sparse_conv_wgrad_plain(t(x), t(w), nmap))
    nm = nmap.numpy()
    ok = nm < M_in
    a = np.where(ok[..., None], x.astype(np.float64)[np.minimum(nm, M_in - 1)],
                 0.0)                                     # [M_out, T, Ci]
    close(got, np.einsum("otk,on->tkn", a, w.astype(np.float64)))


def test_tap_with_no_live_slice():
    """A tap whose entries are all sentinels gives a zero dW[t]."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    dy = rng.normal(size=(70, 8)).astype(np.float32)
    nmap = rng.integers(0, 50, (70, 4)).astype(np.int32)
    nmap[:, 2] = 50
    got = tbc.sparse_conv_wgrad_split_plain(t(x), t(dy), t(nmap), 32)
    assert not tbc.k5_live_slices(t(nmap), 50)[2].any()
    assert not got[2].any()
    close(got, tbc.sparse_conv_wgrad_plain(t(x), t(dy), t(nmap)))


# ------------------------------------------------------------ the planner


def k5_shapes():
    """(name, M_out, T, Ca, Cb, Co) of every K5 call of ResUNetBN2C's train
    step at B = 8 (8 clouds stacked per side): dW has the forward's shape."""
    spec = load_model("ResUNetBN2C")
    ch, tr = spec.channels, spec.tr_channels
    M = (131072, 40960, 12288, 4096)
    out = [("conv1", M[0], 125, 1, 0, ch[0])]
    for l in range(4):
        if l:
            out.append((f"conv{l + 1}", M[l], 27, ch[l - 1], 0, ch[l]))
        out.append((f"block{l + 1}", M[l], 27, ch[l], 0, ch[l]))
    for l in range(3, 0, -1):
        cb = 0 if l == 3 else ch[l]
        out.append((f"conv{l + 1}_tr", M[l - 1], 27, ch[l] if l == 3
                    else tr[l + 1], cb, tr[l]))
        out.append((f"block{l + 1}_tr", M[l - 1], 27, tr[l], 0, tr[l]))
    out.append(("conv1_tr", M[0], 1, tr[1], ch[0], tr[0]))
    out.append(("final", M[0], 1, tr[0], 0, 32))
    out.append(("empty", 0, 27, 32, 0, 32))
    return out


@pytest.mark.parametrize("name,m_out,taps,ca,cb,co", k5_shapes(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_k5_plan_covers_each_tap_channel_and_row_once(name, m_out, taps, ca,
                                                      cb, co):
    plan = tbc.k5_plan(m_out, taps, ca, cb, co)
    ci = ca + cb
    assert plan.packed == (name == "conv1")
    assert plan.bm == (tbc.K5_PACKED_BM if plan.packed else
                       32 if ci <= 32 else 64)
    assert plan.bn == (32 if co <= 32 else 64)
    assert plan.rows_per_split % tbc.K5_BK == 0
    # the kernel's grid: (tap block, dW row tile x column tile, row split)
    hits = np.zeros((taps * ci, co), np.int64)       # dW as [T*Ci, Co]
    ktot = taps * ci if plan.packed else ci
    for tb in range(1 if plan.packed else taps):
        for i in range(-(-ktot // plan.bm)):
            for j in range(-(-co // plan.bn)):
                k = np.arange(i * plan.bm, min(ktot, (i + 1) * plan.bm))
                hits[tb * ci + k, j * plan.bn:(j + 1) * plan.bn] += 1
    assert (hits == 1).all()
    row_hits = np.zeros(m_out, np.int64)
    for z in range(plan.splits):
        lo = z * plan.rows_per_split
        assert lo < max(m_out, 1)                    # no empty split
        row_hits[lo:lo + plan.rows_per_split] += 1
    assert (row_hits == 1).all()
    blocks = (1 if plan.packed else taps) * -(-ktot // plan.bm) \
        * -(-co // plan.bn)
    if plan.splits > 1:
        assert blocks * (plan.splits - 1) < tbc.K5_TARGET_BLOCKS
        assert plan.rows_per_split >= tbc.K5_MIN_SLICES * tbc.K5_BK
        assert plan.splits * taps * ci * co * 4 <= tbc.K5_MAX_PART_BYTES
    # a four-stage ring of the A and B tiles
    assert 4 * 32 * (plan.bm + 8 + plan.bn + 8) * 2 <= 227 * 1024
