"""The conv backward: `invert_map` and `SparseConvFunction` (plain versions
of kernels K1-as-dgrad and K5) against jax.grad of the JAX brick convs.

(b) invert_map on every map kind of a real two-cloud pyramid: no
    collisions, and the round trip holds both ways (exact).
(c) grads of sum(conv(x) * w) with respect to the inputs and W, w zero at
    invalid output rows (as the masked BN that follows each train-mode
    conv makes it), against jax.grad of conv_same (k = 3, 5), conv_down,
    conv_up over a skip concat (fb_concat) and conv1x1 over a skip concat,
    in f32: rtol 1e-4, atol 1e-4 (sums of up to 125 taps in another
    order)."""

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


# ------------------------------------------------------------ invert_map


def map_cases(tpyr, maps):
    M = [m.shape[0] for m in tpyr.vox_masks]
    cases = [("first", maps.first, M[0])]
    cases += [(f"same3[{l}]", m, M[l]) for l, m in enumerate(maps.same3)]
    cases += [(f"down[{l}]", m, M[l]) for l, m in enumerate(maps.down)]
    cases += [(f"up[{l}]", m, M[l + 1]) for l, m in enumerate(maps.up)]
    cases += [("identity", tbc.identity_map(M[0], "cpu"), M[0])]
    return cases


def test_invert_map_round_trip_on_every_map_kind(pyramids):
    _, tpyr, maps = pyramids
    for name, nmap, m_in in map_cases(tpyr, maps):
        inv = tbc.invert_map(nmap, m_in)          # raises on a collision
        M_out, T = nmap.shape
        assert inv.shape == (m_in, T) and inv.dtype == torch.int32, name
        o, t = torch.nonzero((nmap >= 0) & (nmap < m_in), as_tuple=True)
        assert len(o) > 0, name
        assert torch.equal(inv[nmap[o, t].long(), t], o.to(torch.int32)), name
        i, t2 = torch.nonzero(inv < M_out, as_tuple=True)
        assert torch.equal(nmap[inv[i, t2].long(), t2], i.to(torch.int32)), \
            name
        assert len(i) == len(o), name
    for l, inv in enumerate(maps.inv_same3):
        assert torch.equal(inv, tbc.invert_map(maps.same3[l],
                                               maps.same3[l].shape[0]))


def test_invert_map_raises_on_collision():
    nmap = torch.tensor([[0, 1], [2, 1], [3, 4]], dtype=torch.int32)
    with pytest.raises(ValueError, match="more than one output"):
        tbc.invert_map(nmap, 4)
    inv = tbc.invert_map(torch.tensor([[0, 4], [2, 1]], dtype=torch.int32), 4)
    assert inv.tolist() == [[0, 2], [2, 1], [1, 2], [2, 2]]


# --------------------------------------------------------- conv gradients


def rows(mask, C, seed, garbage=True):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((len(mask), C)).astype(np.float32)
    f[~mask] = 7.0 if garbage else 0.0
    return f


def weights(T, Ci, Co, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, Ci, Co)) * 0.3).astype(np.float32)


def port_grads(xs, W, nmap, inv, w):
    """grads of sum(SparseConvFunction(x, x2, W) * w): (dx, dx2, dW)."""
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    tW = torch.from_numpy(W).requires_grad_()
    out = tbc.SparseConvFunction.apply(tx[0], tx[1] if len(tx) > 1 else None,
                                       tW, nmap, inv)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in tx] + [tW.grad.numpy()], out.detach()


def check(got, want):
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("level,k", [(0, 3), (0, 5), (1, 3), (3, 3)])
def test_conv_same_grads(pyramids, level, k):
    jpyr, tpyr, maps = pyramids
    lv, m = jpyr.levels[level], tpyr.vox_masks[level].numpy()
    x = rows(m, 4, level + k)
    w = rows(m, 6, 100 + level, garbage=False)
    W = weights(k ** 3, 4, 6, level)

    def f(x, W):
        y = jbc.conv_same(jbc.vox_to_fb(lv, x), lv, W, k=k,
                          mask_output=False)
        return jnp.sum(jbc.fb_to_vox(lv, y, 6) * w)

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(np.where(
        m[:, None], x, 0.0)), jnp.asarray(W))
    nmap = maps.first if k == 5 else maps.same3[level]
    inv = tbc.invert_map(nmap, len(m))
    got, _ = port_grads([x], W, nmap, inv, w)
    check(got, want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_conv_down_grads(pyramids, level):
    jpyr, tpyr, maps = pyramids
    lv, nxt = jpyr.levels[level], jpyr.levels[level + 1]
    m, m1 = tpyr.vox_masks[level].numpy(), tpyr.vox_masks[level + 1].numpy()
    x = rows(m, 4, 30 + level)
    w = rows(m1, 6, 130 + level, garbage=False)
    W = weights(27, 4, 6, 40 + level)

    def f(x, W):
        y = jbc.conv_down(jbc.vox_to_fb(lv, x), lv, nxt, W, mask_output=False)
        return jnp.sum(jbc.fb_to_vox(nxt, y, 6) * w)

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(np.where(m[:, None], x, 0.0)), jnp.asarray(W))
    got, _ = port_grads([x], W, maps.down[level], maps.inv_down[level], w)
    check(got, want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_conv_up_over_skip_concat_grads(pyramids, level):
    """The decoder's conv_up reads fb_concat(decoder, skip) at level l+1."""
    jpyr, tpyr, maps = pyramids
    fine, coarse = jpyr.levels[level], jpyr.levels[level + 1]
    mc, mf = tpyr.vox_masks[level + 1].numpy(), tpyr.vox_masks[level].numpy()
    xa, xb = rows(mc, 3, 50 + level), rows(mc, 5, 60 + level)
    w = rows(mf, 6, 150 + level, garbage=False)
    W = weights(27, 8, 6, 70 + level)

    def f(xa, xb, W):
        cat = jbc.fb_concat(jbc.vox_to_fb(coarse, xa), 3,
                            jbc.vox_to_fb(coarse, xb), 5)
        y = jbc.conv_up(cat, fine, W, mask_output=False)
        return jnp.sum(jbc.fb_to_vox(fine, y, 6) * w)

    z = mc[:, None]
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(np.where(z, xa, 0.0)), jnp.asarray(np.where(z, xb, 0.0)),
        jnp.asarray(W))
    got, _ = port_grads([xa, xb], W, maps.up[level], maps.inv_up[level], w)
    check(got, want)


def test_conv1x1_over_skip_concat_grads(pyramids):
    jpyr, tpyr, _ = pyramids
    lv, m = jpyr.levels[0], tpyr.vox_masks[0].numpy()
    xa, xb = rows(m, 3, 80), rows(m, 5, 81)
    w = rows(m, 6, 82, garbage=False)
    W = weights(1, 8, 6, 83)

    def f(xa, xb, W):
        cat = jbc.fb_concat(jbc.vox_to_fb(lv, xa), 3, jbc.vox_to_fb(lv, xb),
                            5)
        return jnp.sum(jbc.fb_to_vox(lv, jbc.conv1x1(cat, W[0], level=lv), 6)
                       * w)

    z = m[:, None]
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(np.where(z, xa, 0.0)), jnp.asarray(np.where(z, xb, 0.0)),
        jnp.asarray(W))
    ident = tbc.identity_map(len(m), "cpu")
    got, _ = port_grads([xa, xb], W, ident, ident, w)
    # the garbage rows are invalid inputs: JAX never sees them, and their
    # only reader (the identity map) has a zero cotangent there
    check(got, want)


def test_forward_is_k1_and_no_inverse_means_no_dx(pyramids):
    _, tpyr, maps = pyramids
    m = tpyr.vox_masks[1]
    x = torch.from_numpy(rows(m.numpy(), 4, 90))
    W = torch.from_numpy(weights(27, 4, 6, 91)).requires_grad_()
    out = tbc.SparseConvFunction.apply(x, None, W, maps.same3[1], None)
    assert torch.equal(out, tbc.sparse_conv(x, W.detach(), maps.same3[1]))
    out.sum().backward()                        # x needs no grad: fine
    assert W.grad is not None
    with pytest.raises(ValueError, match="inverse"):
        xg = x.clone().requires_grad_()
        tbc.SparseConvFunction.apply(xg, None, W, maps.same3[1],
                                     None).sum().backward()


def test_wgrad_plain_matches_a_dense_oracle():
    """K5's plain version against a per-row loop in float64."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    x2 = rng.normal(size=(20, 2)).astype(np.float32)
    dy = rng.normal(size=(15, 4)).astype(np.float32)
    nmap = rng.integers(0, 23, (15, 6)).astype(np.int32)   # >= 20: sentinel
    got = tbc.sparse_conv_wgrad(torch.from_numpy(x), torch.from_numpy(dy),
                                torch.from_numpy(nmap),
                                x2=torch.from_numpy(x2)).numpy()
    cat = np.concatenate([x, x2], 1).astype(np.float64)
    want = np.zeros((6, 5, 4))
    for o in range(15):
        for t in range(6):
            if nmap[o, t] < 20:
                want[t] += np.outer(cat[nmap[o, t]], dy[o])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
