"""K1's tensor-core reformulations, as the plain torch emulations in
eyoc_tpu_torch.sparse.brick_conv, against `sparse_conv_plain` and the JAX
brick convs on the same numpy inputs (f32: rtol 1e-4, atol 1e-5 for the
forward; atol 1e-4 for the dgrad, sums of up to 27 taps in another order),
and the launch planner's grid against every K1 shape of ResUNetBN2C.

- the tap-packed product of narrow inputs: conv1 (k = 5, one input
  channel), masked and unmasked, and a narrow skip concat;
- the tap split with the epilogue after the sum: same convs at 2 and 4
  splits, conv_up over the skip concat;
- the dgrad: both routes over `invert_map`'s inverse against jax.grad.
The kernel reads W in its own layout (the packed route views [T, Ci, Co]
as [T*Ci, Co]), so there is no repacked W to hold apart."""

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
RTOL, ATOL = 1e-4, 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(20)
    xyz = rng.normal(0, 4, (2, 3000, 3)).astype(np.float32)
    counts = np.array([3000, 2600], np.int32)
    j = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                    voxel_size=0.3, window_bits=BITS)
    t = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                    caps=CAPS, voxel_size=0.3, window_bits=BITS)
    return j[1], t[1], tbc.conv_maps(t[1], 4, 5, inverse=True)


def feats(mask, C, seed, garbage=0.0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((len(mask), C)).astype(np.float32)
    f[~mask] = garbage
    return f


def weights(T, Ci, Co, seed):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((T, Ci, Co)) * 0.3).astype(np.float32)
    return W, rng.standard_normal(Co).astype(np.float32)


def close(got, want, rows=slice(None), atol=ATOL):
    np.testing.assert_allclose(np.asarray(got)[rows], np.asarray(want)[rows],
                               rtol=RTOL, atol=atol)


def t(a):
    return None if a is None else torch.from_numpy(a)


# ---------------------------------------------------- the tap-packed route


@pytest.mark.parametrize("masked", [True, False])
def test_tap_packed_conv1(pyramids, masked):
    """conv1: k = 5, one input channel, 125 taps packed into K = 128."""
    jpyr, tpyr, maps = pyramids
    lv, m = jpyr.levels[0], tpyr.vox_masks[0]
    f = feats(m.numpy(), 1, 1)
    W, b = weights(125, 1, 32, 2)
    bias = b if masked else None
    jo = jbc.fb_to_vox(lv, jbc.conv_same(
        jbc.vox_to_fb(lv, jnp.asarray(f)), lv, jnp.asarray(W), k=5,
        bias=None if bias is None else jnp.asarray(bias),
        mask_output=masked), 32)
    kw = dict(bias=t(bias), mask=m if masked else None)
    got = tbc.sparse_conv_tap_packed_plain(t(f), t(W), maps.first, **kw)
    assert tbc.k1_plan(maps.first.shape[0], 125, 1, 0, 32).packed
    close(got, tbc.sparse_conv_plain(t(f), t(W), maps.first, **kw))
    close(got, jo, slice(None) if masked else m.numpy())


def test_tap_packed_skip_concat(pyramids):
    """A narrow skip concat (3 + 5 channels) over conv_up: the packed route
    reads both inputs, with the block epilogue."""
    jpyr, tpyr, maps = pyramids
    fine, coarse = jpyr.levels[0], jpyr.levels[1]
    mc, mf = tpyr.vox_masks[1], tpyr.vox_masks[0]
    fa, fb = feats(mc.numpy(), 3, 3), feats(mc.numpy(), 5, 4)
    W, b = weights(27, 8, 16, 5)
    res = feats(mf.numpy(), 16, 6)
    cat = jbc.fb_concat(jbc.vox_to_fb(coarse, jnp.asarray(fa)), 3,
                        jbc.vox_to_fb(coarse, jnp.asarray(fb)), 5)
    jo = jbc.fb_to_vox(fine, jbc.conv_up(cat, fine, jnp.asarray(W),
                                         bias=jnp.asarray(b)), 16)
    jo = np.maximum(np.asarray(jo) + res, 0.0)
    kw = dict(x2=t(fb), bias=t(b), mask=mf, residual=t(res), relu=True)
    assert tbc.k1_plan(mf.shape[0], 27, 3, 5, 16).packed
    got = tbc.sparse_conv_tap_packed_plain(t(fa), t(W), maps.up[0], **kw)
    close(got, tbc.sparse_conv_plain(t(fa), t(W), maps.up[0], **kw))
    close(got, jo)


# ----------------------------------------------------------- the tap split


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("level", [0, 1])
def test_tap_split_same_conv(pyramids, level, splits):
    """The block conv's epilogue (bias, mask, residual, ReLU) runs once,
    after the split partials are added."""
    jpyr, tpyr, maps = pyramids
    lv, m = jpyr.levels[level], tpyr.vox_masks[level]
    f = feats(m.numpy(), 16, 10 + level)
    W, b = weights(27, 16, 16, 11 + level)
    fbj = jbc.vox_to_fb(lv, jnp.asarray(f))
    jo = jnp.maximum(jbc.conv_same(fbj, lv, jnp.asarray(W),
                                   bias=jnp.asarray(b)) + fbj, 0.0)
    kw = dict(bias=t(b), mask=m, residual=t(f), relu=True)
    nmap = maps.same3[level]
    got = tbc.sparse_conv_split_plain(t(f), t(W), nmap, splits, **kw)
    close(got, tbc.sparse_conv_plain(t(f), t(W), nmap, **kw))
    close(got, jbc.fb_to_vox(lv, jo, 16))


@pytest.mark.parametrize("splits", [2, 4])
def test_tap_split_conv_up_skip_concat(pyramids, splits):
    """The decoder's conv_up over fb_concat(decoder, skip), split."""
    jpyr, tpyr, maps = pyramids
    fine, coarse = jpyr.levels[1], jpyr.levels[2]
    mc, mf = tpyr.vox_masks[2], tpyr.vox_masks[1]
    fa, fb = feats(mc.numpy(), 16, 20), feats(mc.numpy(), 8, 21)
    W, b = weights(27, 24, 8, 22)
    cat = jbc.fb_concat(jbc.vox_to_fb(coarse, jnp.asarray(fa)), 16,
                        jbc.vox_to_fb(coarse, jnp.asarray(fb)), 8)
    jo = jbc.fb_to_vox(fine, jbc.conv_up(cat, fine, jnp.asarray(W),
                                         bias=jnp.asarray(b)), 8)
    kw = dict(x2=t(fb), bias=t(b), mask=mf)
    got = tbc.sparse_conv_split_plain(t(fa), t(W), maps.up[1], splits, **kw)
    close(got, tbc.sparse_conv_plain(t(fa), t(W), maps.up[1], **kw))
    close(got, jo)


# ------------------------------------------------------------- the dgrad


@pytest.mark.parametrize("route", ["split2", "split4", "packed"])
@pytest.mark.parametrize("kind", ["same", "down"])
def test_dgrad_over_inverse_map(pyramids, kind, route):
    """dX = K1 over `invert_map`'s inverse with W transposed per tap, by
    each route, against jax.grad of the JAX conv (w zero at invalid output
    rows, as the masked BN after each train-mode conv makes it)."""
    jpyr, tpyr, maps = pyramids
    lv, nxt = jpyr.levels[1], jpyr.levels[2]
    m = tpyr.vox_masks[1].numpy()
    if kind == "same":
        out_lv, mo, nmap, inv = lv, m, maps.same3[1], maps.inv_same3[1]
    else:
        out_lv, mo = nxt, tpyr.vox_masks[2].numpy()
        nmap, inv = maps.down[1], maps.inv_down[1]
    assert torch.equal(inv, tbc.invert_map(nmap, len(m)))
    Ci, Co = 8, (4 if route == "packed" else 16)   # dY of 4 channels: narrow
    assert tbc.k1_plan(len(m), 27, Co, 0, Ci).packed == (route == "packed")
    x = feats(m, Ci, 30, garbage=7.0)
    w = feats(mo, Co, 31)
    W, _ = weights(27, Ci, Co, 32)

    def f(x):
        fbx = jbc.vox_to_fb(lv, x)
        if kind == "same":
            y = jbc.conv_same(fbx, lv, jnp.asarray(W), mask_output=False)
        else:
            y = jbc.conv_down(fbx, lv, nxt, jnp.asarray(W), mask_output=False)
        return jnp.sum(jbc.fb_to_vox(out_lv, y, Co) * w)

    want = jax.jit(jax.grad(f))(jnp.asarray(np.where(m[:, None], x, 0.0)))
    Wt = t(W).transpose(1, 2).contiguous()
    dy = t(w)
    if route == "packed":
        got = tbc.sparse_conv_tap_packed_plain(dy, Wt, inv)
    else:
        got = tbc.sparse_conv_split_plain(dy, Wt, inv, int(route[-1]))
    close(got, tbc.sparse_conv_plain(dy, Wt, inv), atol=GRAD_ATOL)
    close(got, want, atol=GRAD_ATOL)


# ------------------------------------------------------------ the planner


def k1_shapes():
    """(name, M_out, T, Ca, Cb, Co) of every K1 call of ResUNetBN2C's eval
    forward (one cloud, caps (16384, 5120, 1536, 512)) and its train
    forward and dgrad (8 clouds stacked per side)."""
    spec = load_model("ResUNetBN2C")
    ch, tr = spec.channels, spec.tr_channels
    out = []
    for B, caps in ((1, (16384, 5120, 1536, 512)),
                    (8, (131072, 40960, 12288, 4096))):
        M = caps
        fwd = [("conv1", M[0], 125, 1, 0, ch[0])]
        for l in range(4):
            if l:
                fwd.append((f"conv{l + 1}", M[l], 27, ch[l - 1], 0, ch[l]))
            fwd.append((f"block{l + 1}", M[l], 27, ch[l], 0, ch[l]))
        for l in range(3, 0, -1):
            cb = 0 if l == 3 else ch[l]
            fwd.append((f"conv{l + 1}_tr", M[l - 1], 27, ch[l] if l == 3
                        else tr[l + 1], cb, tr[l]))
            fwd.append((f"block{l + 1}_tr", M[l - 1], 27, tr[l], 0, tr[l]))
        fwd.append(("conv1_tr", M[0], 1, tr[1], ch[0], tr[0]))
        fwd.append(("final", M[0], 1, tr[0], 0, 32))
        out += [(f"B{B} {n}", *s) for n, *s in fwd]
        if B == 8:     # the dgrad: the transposed shapes, conv1 has none
            M_in = {"conv2": M[0], "conv3": M[1], "conv4": M[2],
                    "conv4_tr": M[3], "conv3_tr": M[2], "conv2_tr": M[1]}
            for n, m_out, T, ca, cb, co in fwd[1:]:
                out.append((f"B8 dgrad {n}", M_in.get(n, m_out), T, co, 0,
                            ca + cb))
    return out


@pytest.mark.parametrize("name,m_out,taps,ca,cb,co", k1_shapes(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_k1_plan_covers_each_output_and_tap_once(name, m_out, taps, ca, cb,
                                                 co):
    plan = tbc.k1_plan(m_out, taps, ca, cb, co)
    assert plan.packed == (name.endswith("conv1") or (ca + cb) % 8 != 0)
    assert (plan.bm, plan.bn) in ((128, 32), (64, 64), (64, 128))
    rows = np.zeros(m_out, np.int64)
    for i in range(-(-m_out // plan.bm)):
        rows[i * plan.bm:(i + 1) * plan.bm] += 1
    cols = np.zeros(co, np.int64)
    for j in range(-(-co // plan.bn)):
        cols[j * plan.bn:(j + 1) * plan.bn] += 1
    taps_hit = np.zeros(taps, np.int64)
    for s in range(plan.splits):
        lo, hi = s * taps // plan.splits, (s + 1) * taps // plan.splits
        assert hi - lo >= 1
        taps_hit[lo:hi] += 1
    assert (rows == 1).all() and (cols == 1).all() and (taps_hit == 1).all()
    if plan.packed:
        assert plan.splits == 1
    else:
        assert ca % 8 == 0 and cb % 8 == 0 and co % 8 == 0
    tiles = -(-m_out // plan.bm) * -(-co // plan.bn)
    if plan.splits > 1:    # split only where the tiles do not fill the card
        assert tiles < tbc.K1_TARGET_BLOCKS
        assert taps // plan.splits >= tbc.K1_MIN_TAPS_PER_SPLIT
    # the kernel's shared memory: a 3-stage ring and the tile's map entries
    nt = -(-taps // plan.splits) if not plan.packed else 0
    smem = 3 * (plan.bm * 40 + 32 * (plan.bn + 8)) * 2 + (plan.bm + 1) * nt * 4
    assert smem <= 227 * 1024
