"""Feature widths other than 3 and 32 on the CPU: the kNN wrappers' zero
padding (`knn.pad_features` to `knn.k2_width` / `knn.knn_width`) and K1's
padded output route (`brick_conv.pad_out`, `sparse_conv_diff`).

- The padding keeps the kernels' sums: at D = 16, 33 and 64, the direct
  form (K2) and the 3xTF32 cross term (K8, K9) summed feature by feature
  in order, as the kernels' chains run, give the same bits on the padded
  features (the widths the kernels run at) as on the real ones: a zero
  column adds an exact +0.
- The padding gives the plain versions' bits (`masked_argmin_plain`,
  `masked_knn2_plain`, `masked_argmin_excl_plain` and the reformulations
  `masked_argmin_split_plain`, `masked_knn2_gram_split_plain`,
  `masked_argmin_excl_gram_split_plain`) at D = 16 and 64; at D = 33
  torch's vectorised CPU reductions group a 33-wide row's columns
  otherwise than a 64-wide row's, so there K2's reformulation at the
  padded width is held to the plain version at the real one by d2 within
  1e-4 and indices equal past K2_GAP (at every width).
- K8's reformulation at those widths, run at the padded width, against
  `masked_knn2_plain` at tests/test_torch_knn2_gram.py's tolerances (d2
  within 1e-4 relative plus the Gram form's rounding; indices equal past
  K2_GAP plus twice that), and K9's against `masked_argmin_excl_plain`
  where the exclusion test is clear of r^2.
- K1 at an output width of 20: `sparse_conv` (the padded route: W, bias
  and residual padded with zero columns, the output sliced) equal to the
  plain version at 20 columns; `sparse_conv_diff` (the pad inside
  autograd) gives the unpadded function's output and gradients, dW's real
  columns the same bits.
- A narrow ResUNetBN2C-family model (BN norms and BN blocks, tests/
  test_torch_models.py's NARROW widths) with n_out = 20 through the
  port's eval forward against JAX apply_unet(training=False) at atol 1e-4
  in f32, on the padded route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import apply_unet, init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.ops import knn
from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess
from test_torch_knn2_gram import check


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


WIDTHS = (16, 33, 64)
NQ, NR = 300, 400


def features(seed, d):
    """Unit query and ref features [N, d] with masks (a tie: query 0 on
    ref 5, which ref 9 repeats), partner and candidate coordinates."""
    rng = np.random.default_rng(seed)

    def unit(n):
        x = rng.normal(size=(n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    q, r = unit(NQ), unit(NR)
    r[9] = r[5]
    q[0] = r[5]
    qm, rm = rng.random(NQ) < 0.8, rng.random(NR) < 0.7
    qm[0] = rm[5] = rm[9] = True
    pxyz = rng.uniform(-3, 3, (NQ, 3)).astype(np.float32)
    cxyz = rng.uniform(-3, 3, (NR, 3)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, qm, r, rm, pxyz, cxyz)]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def seq_direct(q, r):
    """[nq, nr] direct-form squared distances summed feature by feature in
    order, as K2's chain over a row's features."""
    acc = torch.zeros(q.shape[0], r.shape[0])
    for j in range(q.shape[1]):
        dj = q[:, j, None] - r[None, :, j]
        acc = acc + dj * dj
    return acc


def seq_gram3(q, r):
    """[nq, nr] 3xTF32 cross terms lo_q hi_r + hi_q lo_r + hi_q hi_r added
    feature by feature in order (K8's k steps, one product at a time)."""
    (qh, ql), (rh, rl) = knn.tf32_split(q), knn.tf32_split(r)
    acc = torch.zeros(q.shape[0], r.shape[0])
    for j in range(q.shape[1]):
        a, b = qh[:, j, None], ql[:, j, None]
        acc = acc + b * rh[None, :, j]
        acc = acc + a * rl[None, :, j]
        acc = acc + a * rh[None, :, j]
    return acc


@pytest.mark.parametrize("d", WIDTHS)
def test_padding_keeps_the_kernels_sums(d):
    """Summed in the kernels' order, feature by feature, the padded
    features give the bits of the unpadded ones: each zero column adds an
    exact +0 (K2's direct form, K8's and K9's 3xTF32 cross term)."""
    q, qm, r, rm, _, _ = features(d, d)
    w2, w8 = knn.k2_width(d), knn.knn_width(d)
    assert (w2, w8) == ({16: 32, 33: 64, 64: 64}[d],) * 2
    q2, r2 = knn.pad_features(q, w2), knn.pad_features(r, w2)
    q8, r8 = knn.pad_features(q, w8), knn.pad_features(r, w8)
    assert q8.shape == (NQ, w8) and q8.is_contiguous()
    assert torch.equal(q8[:, :d], q) and not q8[:, d:].any()
    assert knn.pad_features(q2, w2) is q2          # no copy at its width
    assert torch.equal(seq_direct(q2, r2), seq_direct(q, r))
    assert torch.equal(seq_gram3(q8, r8), seq_gram3(q, r))


@pytest.mark.parametrize("d", (16, 64))
def test_padding_gives_the_plain_versions_bits(d):
    """The plain versions on the padded features, at widths where torch's
    CPU reductions group a padded row's real columns as the unpadded row's
    (16 into 32, 64 itself): their bits."""
    q, qm, r, rm, pxyz, cxyz = features(d, d)
    w2, w8 = knn.k2_width(d), knn.knn_width(d)
    q2, r2 = knn.pad_features(q, w2), knn.pad_features(r, w2)
    q8, r8 = knn.pad_features(q, w8), knn.pad_features(r, w8)
    assert same(knn.masked_argmin_plain(q2, qm, r2, rm),
                knn.masked_argmin_plain(q, qm, r, rm))
    assert same(knn.masked_argmin_split_plain(q2, qm, r2, rm, 3),
                knn.masked_argmin_split_plain(q, qm, r, rm, 3))
    assert same(knn.masked_knn2_plain(q8, qm, r8, rm),
                knn.masked_knn2_plain(q, qm, r, rm))
    assert same(knn.masked_knn2_gram_split_plain(q8, qm, r8, rm, 2, 64),
                knn.masked_knn2_gram_split_plain(q, qm, r, rm, 2, 64))
    assert same(knn.masked_argmin_excl_plain(q8, r8, pxyz, cxyz, 1.0),
                knn.masked_argmin_excl_plain(q, r, pxyz, cxyz, 1.0))
    assert same(knn.masked_argmin_excl_gram_split_plain(
        q8, r8, pxyz, cxyz, 1.0, 3, 64),
        knn.masked_argmin_excl_gram_split_plain(q, r, pxyz, cxyz, 1.0, 3,
                                                64))


@pytest.mark.parametrize("d", WIDTHS)
def test_padded_argmin_matches_plain(d):
    """K2's reformulation (the direct form, its splits) at the padded
    width against the plain version at the real one: d2 within the Gram
    form's rounding, indices equal past K2_GAP."""
    q, qm, r, rm, _, _ = features(200 + d, d)
    w = knn.k2_width(d)
    dk, ik = knn.masked_argmin_split_plain(knn.pad_features(q, w), qm,
                                           knn.pad_features(r, w), rm, 4)
    dp, ip = knn.masked_argmin_plain(q, qm, r, rm)
    f = torch.cdist(q.double(), r.double()) ** 2
    f = torch.where(rm[None], f, torch.inf)
    two = torch.topk(f, 2, largest=False).values
    clear = qm & ((two[:, 1] - two[:, 0]) > 1e-3)
    assert int(clear.sum()) > NQ // 2
    assert torch.equal(ik[clear], ip[clear])
    np.testing.assert_allclose(dk[qm].numpy(), dp[qm].numpy(), rtol=1e-4,
                               atol=1e-5)
    assert int(ik[0]) == 5                         # the tie: lowest first


@pytest.mark.parametrize("d", WIDTHS)
def test_gram_split_at_padded_widths_matches_plain(d):
    q, qm, r, rm, pxyz, cxyz = features(100 + d, d)
    w = knn.knn_width(d)
    tiles = knn.knn2_tiles(w)[1]
    qp, rp = knn.pad_features(q, w), knn.pad_features(r, w)
    dk, ik = knn.masked_knn2_gram_split_plain(qp, qm, rp, rm, 3, tiles)
    dp, ip = knn.masked_knn2_plain(q, qm, r, rm)
    n = check(dk.numpy(), ik.numpy(), q.numpy(), qm.numpy(), r.numpy(),
              rm.numpy(), dp.numpy(), ip.numpy())
    assert n > NQ // 2
    assert tuple(ik[0].tolist()) == (5, 9)         # the tie: lowest first
    # K9: the index where the plain version's exclusion tests are clear
    r2 = 1.0
    d2k, idx, exk = knn.masked_argmin_excl_gram_split_plain(
        qp, rp, pxyz, cxyz, r2, 2, tiles)
    idp, exp = knn.masked_argmin_excl_plain(q, r, pxyz, cxyz, r2)
    near = ((pxyz[:, None].double() - cxyz[None].double()) ** 2).sum(-1)
    clear = ((near - r2).abs() > 1e-5).all(1)
    f = torch.cdist(q.double(), r.double()) ** 2
    f = torch.where(near < r2, torch.inf, f)
    two = torch.topk(f, 2, largest=False).values
    clear &= (two[:, 1] - two[:, 0]) > 1e-3
    assert int(clear.sum()) > NQ // 2
    assert torch.equal(idx[clear], idp[clear])
    assert torch.equal(exk[clear], exp[clear])


def conv_case(seed, co):
    g = torch.Generator().manual_seed(seed)
    m_in, m_out, taps, ci = 200, 150, 27, 16
    x = torch.randn(m_in, ci, generator=g)
    W = torch.randn(taps, ci, co, generator=g) * 0.2
    # each (input, tap) read by at most one output row, as a conv's map
    nmap = torch.stack([torch.randperm(m_in, generator=g)[:m_out]
                        for _ in range(taps)], 1).to(torch.int32)
    nmap[torch.rand(m_out, taps, generator=g) < 0.2] = m_in
    bias = torch.randn(co, generator=g)
    mask = torch.rand(m_out, generator=g) < 0.8
    res = torch.randn(m_out, co, generator=g)
    return x, W, nmap, bias, mask, res


def test_k1_pads_an_output_width_of_20():
    x, W, nmap, bias, mask, res = conv_case(0, 20)
    for kw in (dict(), dict(bias=bias, mask=mask, residual=res, relu=True)):
        got = tbc.sparse_conv(x, W, nmap, **kw)
        want = tbc.sparse_conv_plain(x, W, nmap, **kw)
        assert got.shape == (150, 20) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert tbc.pad_out(W).shape == (27, 16, 24)
    assert tbc.pad_out(None) is None and tbc.pad_out(res[:, :16]) is not None
    # the pad inside autograd: the same output and gradients
    inv = tbc.invert_map(nmap, x.shape[0])
    wts = torch.randn(150, 20, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (tbc.sparse_conv_diff, tbc.SparseConvFunction.apply):
        xg, Wg = x.clone().requires_grad_(), W.clone().requires_grad_()
        out = fn(xg, None, Wg, nmap, inv)
        (out * wts).sum().backward()
        grads.append((out.detach(), xg.grad, Wg.grad))
    (o1, dx1, dW1), (o2, dx2, dW2) = grads
    assert o1.shape == (150, 20) and dW1.shape == W.shape
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx1.numpy(), dx2.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(dW1, dW2)


NARROW = dict(channels=(8, 16, 16, 16), tr_channels=(8, 8, 8, 16))
CAPS = (2048, 768, 256, 96)
BITS = (7, 7, 6)


@pytest.fixture
def f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def test_resunet_with_20_outputs_matches_jax(f32_convs):
    n_out = 20
    js = JSpec(name="narrow", norm_type="BN", block_norm_type="BN", **NARROW)
    params, bn = jax.jit(lambda key: jinit(js, key, 1, n_out, 5))(
        jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), params)
    bn = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), bn)
    xyz = rng.normal(0, 4, (1, 3000, 3)).astype(np.float32)
    counts = np.full(1, 3000, np.int32)
    _, jpyr = jpreprocess(jnp.asarray(xyz), jnp.asarray(counts), caps=CAPS,
                          voxel_size=0.3, window_bits=BITS)
    _, tpyr = tpreprocess(torch.from_numpy(xyz), torch.from_numpy(counts),
                          caps=CAPS, voxel_size=0.3, window_bits=BITS)
    want = jax.jit(lambda p, s, y: apply_unet(
        js, p, s, y, training=False, conv1_kernel_size=5,
        n_clouds=1)[0])(params, bn, jpyr)
    model = ResUNet(UNetSpec("narrow", "BN", "BN", **NARROW), 1, n_out, 5,
                    dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    assert model.final.weight.shape[-1] == n_out
    got = model(tpyr).numpy()
    assert got.shape[1] == n_out
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
