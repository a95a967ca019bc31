"""The loss path against the JAX package, on the CPU:

(d) take_rows (plain version of kernel K6) forward and backward against
    jnp.take / jax.grad, with duplicate indices and the sentinel (exact
    forward; backward rtol 1e-6, atol 1e-6: duplicate rows add in another
    order);
(e) hardest_contrastive_loss: sampled, mined and membership outputs
    bit-equal to the JAX package's own functions on the same draws (the
    three jax.random.uniform calls of loss.py:81-90), the loss values
    (rtol 1e-5, atol 1e-6) and the grads with respect to F0 and F1 against
    jax.grad (rtol 1e-4, atol 1e-6; the mined distance is recomputed
    directly instead of through the Gram form), with and without
    safe_radius; with safe_radius a tensor that is not on the CPU goes to
    kernel K9, never to the plain mining;
(f) gt_positive_pairs and flatten_pairs, bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry.metrics import pdist as jpdist
from eyoc_tpu.geometry.metrics import pdist2 as jpdist2
from eyoc_tpu.sparse.brick_conv import _take_pad0
from eyoc_tpu.training import loss as jloss
from eyoc_tpu.training.pipeline import flatten_pairs as jflatten
from eyoc_tpu.training.pipeline import gt_positive_pairs as jgt_pairs
from eyoc_tpu.training.pipeline import preprocess_clouds as jpreprocess
from eyoc_tpu_torch.ops.rows import take_rows
from eyoc_tpu_torch.training import loss as tloss
from eyoc_tpu_torch.training.pipeline import flatten_pairs, gt_positive_pairs
from eyoc_tpu_torch.training.pipeline import preprocess_clouds as tpreprocess
from eyoc_tpu_torch.utils import kernels

# ------------------------------------------------------------- take_rows


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_take_rows_forward_and_backward(dtype):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 6)).astype(np.float32)
    idx = rng.integers(0, 51, 300).astype(np.int32)       # 50: the sentinel
    idx[:20] = 7                                           # duplicates
    assert (idx == 50).any()
    w = rng.normal(size=(300, 6)).astype(np.float32)
    jsrc = jnp.asarray(src).astype(dtype)
    want = _take_pad0(jsrc, jnp.asarray(idx))
    gwant = jax.grad(lambda s: jnp.sum(_take_pad0(s, jnp.asarray(idx))
                                       .astype(jnp.float32) * w))(
        jnp.asarray(src))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tsrc = torch.from_numpy(src).to(tdt).requires_grad_()
    got = take_rows(tsrc, torch.from_numpy(idx))
    assert got.dtype == tdt
    assert np.array_equal(got.detach().float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    assert not got.detach().float().numpy()[idx == 50].any()
    (got.float() * torch.from_numpy(w)).sum().backward()
    if tdt == torch.float32:
        np.testing.assert_allclose(tsrc.grad.numpy(), np.asarray(gwant),
                                   rtol=1e-6, atol=1e-6)
    else:   # bf16 grads round once, at the end
        np.testing.assert_allclose(tsrc.grad.float().numpy(),
                                   np.asarray(gwant), rtol=1e-2, atol=1e-2)


# --------------------------------------------------------------- the loss

N, C = 600, 16
NUM_POS, NUM_HN = 256, 96


def loss_inputs(seed):
    """Unit features with F1[pos_j] close to F0[pos_i], so that the mined
    negative is often the positive partner (membership is exercised)."""
    rng = np.random.default_rng(seed)
    m0 = rng.random(N) < 0.85
    m1 = rng.random(N) < 0.85
    F0 = rng.normal(size=(N, C)).astype(np.float32)
    F0 /= np.linalg.norm(F0, axis=1, keepdims=True)
    perm = rng.permutation(N)
    F1 = F0[perm] + 0.3 * rng.normal(size=(N, C)).astype(np.float32)
    F1 /= np.linalg.norm(F1, axis=1, keepdims=True)
    F0[~m0] = 0.0
    F1[~m1] = 0.0
    inv = np.argsort(perm)
    pos_i = np.arange(N, dtype=np.int32)
    pos_j = inv.astype(np.int32)                 # F1[pos_j[i]] ~ F0[i]
    pos_valid = m0 & m1[pos_j] & (rng.random(N) < 0.9)
    xyz0 = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    xyz1 = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    return F0, m0, F1, m1, pos_i, pos_j, pos_valid, xyz0, xyz1


def jax_reference(args, key, safe_radius):
    """The JAX loss, its grads, and its internal indices re-derived with
    the package's own functions on the same keys."""
    F0, m0, F1, m1, pos_i, pos_j, pos_valid, xyz0, xyz1 = map(jnp.asarray,
                                                             args)

    def f(F0, F1):
        p, n = jloss.hardest_contrastive_loss(
            F0, m0, F1, m1, pos_i, pos_j, pos_valid, key, num_pos=NUM_POS,
            num_hn_samples=NUM_HN, xyz0=xyz0, xyz1=xyz1,
            safe_radius=safe_radius)
        return p + n, (p, n)

    (_, (p, n)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(F0, F1)
    k_sel0, k_sel1, k_pos = jax.random.split(key, 3)
    sel0 = jloss._sample_valid(k_sel0, m0, NUM_HN)
    sel1 = jloss._sample_valid(k_sel1, m1, NUM_HN)
    psel = jloss._sample_valid(k_pos, pos_valid, NUM_POS)
    pi, pj = pos_i[psel], pos_j[psel]
    D01 = jpdist(F0[pi], F1[sel1])
    D10 = jpdist(F1[pj], F0[sel0])
    if safe_radius > 0:
        r2 = safe_radius * safe_radius
        D01 = jnp.where(jpdist2(xyz1[pj], xyz1[sel1]) < r2, 1e9, D01)
        D10 = jnp.where(jpdist2(xyz0[pi], xyz0[sel0]) < r2, 1e9, D10)
    ind01, ind10 = jnp.argmin(D01, 1), jnp.argmin(D10, 1)
    table = jloss._sorted_pair_table(pos_i, pos_j, pos_valid)
    pv = pos_valid[psel]
    mask0 = ~jloss._pair_member(table, pi, sel1[ind01]) & pv
    mask1 = ~jloss._pair_member(table, sel0[ind10], pj) & pv
    draws = [np.array(jax.random.uniform(k, (n,)))
             for k, n in ((k_sel0, NUM_HN), (k_sel1, NUM_HN),
                          (k_pos, NUM_POS))]
    idx = dict(sel0=sel0, sel1=sel1, psel=psel, ind01=ind01, ind10=ind10,
               mask0_neg=mask0, mask1_neg=mask1)
    return (float(p), float(n), [np.asarray(g) for g in grads],
            {k: np.asarray(v) for k, v in idx.items()}, draws)


@pytest.mark.parametrize("seed,safe_radius", [(0, 0.0), (1, 0.0), (2, 1.5)])
def test_hardest_contrastive_loss_matches_jax(seed, safe_radius):
    args = loss_inputs(seed)
    p, n, (g0, g1), jidx, draws = jax_reference(
        args, jax.random.PRNGKey(seed), safe_radius)
    F0, m0, F1, m1, pos_i, pos_j, pos_valid, xyz0, xyz1 = map(
        torch.from_numpy, args)
    F0.requires_grad_()
    F1.requires_grad_()
    tp, tn, aux = tloss.hardest_contrastive_loss(
        F0, m0, F1, m1, pos_i, pos_j, pos_valid,
        tloss.LossDraws(*map(torch.from_numpy, draws)), xyz0=xyz0, xyz1=xyz1,
        safe_radius=safe_radius)
    for k, v in jidx.items():
        assert np.array_equal(aux[k].numpy(), v), k
    if safe_radius == 0.0:
        # membership really fires: some mined negatives are positive pairs
        pv = pos_valid[aux["psel"]]
        assert (pv & ~aux["mask0_neg"]).any()
    np.testing.assert_allclose(tp.item(), p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.item(), n, rtol=1e-5, atol=1e-6)
    (tp + tn).backward()
    np.testing.assert_allclose(F0.grad.numpy(), g0, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(F1.grad.numpy(), g1, rtol=1e-4, atol=1e-6)


def test_safe_radius_excludes_everything_like_jax():
    """A radius wider than the scene excludes every candidate: the mined
    distance is the JAX sentinel 1e9 and the negative term is 0."""
    args = loss_inputs(3)
    p, n, _, jidx, draws = jax_reference(args, jax.random.PRNGKey(3), 100.0)
    F0, m0, F1, m1, pos_i, pos_j, pos_valid, xyz0, xyz1 = map(
        torch.from_numpy, args)
    tp, tn, aux = tloss.hardest_contrastive_loss(
        F0, m0, F1, m1, pos_i, pos_j, pos_valid,
        tloss.LossDraws(*map(torch.from_numpy, draws)), xyz0=xyz0, xyz1=xyz1,
        safe_radius=100.0)
    assert n == 0.0 and float(tn) == 0.0
    np.testing.assert_allclose(float(tp), p, rtol=1e-5, atol=1e-6)
    assert np.array_equal(aux["ind01"].numpy(), jidx["ind01"])


def test_safe_radius_mining_refuses_non_cpu_tensors(monkeypatch):
    """A tensor that is not on the CPU never takes the plain mining: it
    goes to kernel K9 (here its loader, which fails)."""
    def fail(name, argtypes, symbol=None):
        raise RuntimeError(f"loader: {symbol or name}")

    monkeypatch.setattr(kernels, "load", fail)
    a = torch.empty((8, 32), device="meta")
    excl = (torch.empty((8, 3), device="meta"),
            torch.empty((4, 3), device="meta"), 2.25)
    with pytest.raises(RuntimeError, match="loader: masked_argmin_excl"):
        tloss._mine(a, torch.empty((4, 32), device="meta"), excl)


def test_pair_member_equals_lexicographic_search():
    rng = np.random.default_rng(7)
    pi = rng.integers(0, 40, 200).astype(np.int32)
    pj = rng.integers(0, 40, 200).astype(np.int32)
    pv = rng.random(200) < 0.7
    qi = rng.integers(0, 41, 500).astype(np.int32)
    qj = rng.integers(0, 41, 500).astype(np.int32)
    table = jloss._sorted_pair_table(jnp.asarray(pi), jnp.asarray(pj),
                                     jnp.asarray(pv))
    want = np.asarray(jloss._pair_member(table, jnp.asarray(qi),
                                         jnp.asarray(qj)))
    keys = tloss.pair_keys(*map(torch.from_numpy, (pi, pj, pv)))
    got = tloss.pair_member(keys, torch.from_numpy(qi), torch.from_numpy(qj))
    assert want.any() and (~want).any()
    assert np.array_equal(got.numpy(), want)


# -------------------------------------------------------------- GT pairs


def test_gt_positive_pairs_and_flatten_bit_equal():
    rng = np.random.default_rng(11)
    B, P = 2, 3000
    xyz0 = rng.normal(0, 4, (B, P, 3)).astype(np.float32)
    yaw = 0.1
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw),
                                                   0], [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = [0.4, -0.2, 0.05]
    # cloud 1 is cloud 0 in the frame T maps it to, with noise
    xyz1 = (xyz0 @ R.T + T[:, None, :3, 3]
            + rng.normal(0, 0.05, xyz0.shape)).astype(np.float32)
    counts = np.array([P, P - 500], np.int32)
    radius = np.array([0.45, 0.3], np.float32)
    caps, bits = (2048, 768), (7, 7, 6)
    jv0, _ = jpreprocess(jnp.asarray(xyz0), jnp.asarray(counts), caps=caps,
                         voxel_size=0.3, window_bits=bits)
    jv1, _ = jpreprocess(jnp.asarray(xyz1), jnp.asarray(counts), caps=caps,
                         voxel_size=0.3, window_bits=bits)
    tv0, _ = tpreprocess(torch.from_numpy(xyz0), torch.from_numpy(counts),
                         caps=caps, voxel_size=0.3, window_bits=bits)
    tv1, _ = tpreprocess(torch.from_numpy(xyz1), torch.from_numpy(counts),
                         caps=caps, voxel_size=0.3, window_bits=bits)
    want = jgt_pairs(jv0, jv1, jnp.asarray(T), jnp.asarray(radius))
    got = gt_positive_pairs(tv0, tv1, torch.from_numpy(T),
                            torch.from_numpy(radius))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 100 < int(got[2].sum()) < int(tv0.mask.sum())
    fw = jflatten(*want, caps[0], caps[0])
    fg = flatten_pairs(*got, caps[0], caps[0])
    for g, w in zip(fg, fw):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
