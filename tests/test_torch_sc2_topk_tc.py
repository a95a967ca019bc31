"""Kernel K4's selection (`sc2_seed_topk`: each seed row's k1 columns of
largest key = valid[j] ? SC2[s, j] : -1, by key descending, then column
ascending) against the JAX package, on numpy inputs made from a seed
(N of a few hundred, S = 64, k = 30):

- the JAX side is sc2_pcr's composition (eyoc_tpu/registration/sc2pcr.py
  :296-300: bf16 hard and tight masks, the seed-row product, the seed rows
  of hard), then `where(valid, SC2, -1)`, then `jax.lax.top_k` and the
  package's `_chunked_topk`, under `jax.jit`;
- the port's `sc2_seed_topk` on CPU tensors (its plain version) and
  `sc2_seed_topk_tiled_plain` (the kernel's reformulation: composites
  (key + 1) * 65536 + 65535 - j, each chunk's top k, then the merge) at
  chunk widths that do and do not divide N;
- indices bit-equal, in order, first column included, in every case: a
  ragged chunk, the last 10% of the points invalid, seeds that point at
  invalid rows (all their keys 0 or -1), rows with fewer than k valid
  columns, and a tie-heavy set in which most keys are 0;
and the launch planner `k4_plan` on the main path's shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.registration import sc2pcr as J
from eyoc_tpu_torch.registration import sc2pcr as T


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


D_THRE, K1, S = 0.1, 30, 64


def correspondences(seed, n, inlier, n_invalid=0, n_valid=None):
    """A rigid motion with `inlier` of the points true; the last
    `n_invalid` points invalid, or only the first `n_valid` valid."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = rng.uniform(-3, 3, 3).astype(np.float32)
    tgt = (src @ R.T + t + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    out = rng.random(n) >= inlier
    tgt[out] = rng.uniform(-5, 5, (int(out.sum()), 3))
    valid = np.ones(n, bool)
    if n_invalid:
        valid[-n_invalid:] = False
    if n_valid is not None:
        valid[n_valid:] = False
    seeds = rng.permutation(n)[:S].astype(np.int32)
    seeds[0] = np.flatnonzero(~valid)[0] if (~valid).any() else seeds[0]
    return src, tgt, valid, seeds


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def jax_topk(src, tgt, valid, seeds, k, chunk):
    """sc2_pcr's SC2 (sc2pcr.py:274-300), masked as _seed_transforms
    masks it (:165); then lax.top_k and _chunked_topk."""
    sd = jnp.linalg.norm(src[:, None] - src[None, :], axis=-1)
    td = jnp.linalg.norm(tgt[:, None] - tgt[None, :], axis=-1)
    cross = jnp.abs(sd - td)
    pair_ok = valid[:, None] & valid[None, :]
    hard = ((cross < D_THRE) & pair_ok).astype(jnp.bfloat16)
    tight = ((cross < D_THRE / 2.0) & pair_ok).astype(jnp.bfloat16)
    sc2 = jax.lax.dot(jnp.take(tight, seeds, axis=0), tight,
                      preferred_element_type=jnp.float32)
    sc2 = sc2 * jnp.take(hard, seeds, axis=0).astype(jnp.float32)
    keys = jnp.where(valid[None, :], sc2, -1.0)
    return (keys, jax.lax.top_k(keys, k)[1],
            J._chunked_topk(keys, k, chunk)[1])


CASES = {
    # 30% inliers, every point valid
    "all_valid": dict(seed=0, n=300, inlier=0.3),
    # the last 10% of the points invalid (the seed at row 0 is one of them)
    "tail_invalid": dict(seed=1, n=300, inlier=0.3, n_invalid=30),
    # 20 valid points: every row has fewer than k valid columns
    "few_valid": dict(seed=2, n=240, inlier=0.5, n_valid=20),
    # no inliers: most keys are 0
    "tie_heavy": dict(seed=3, n=320, inlier=0.0, n_invalid=32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_topk_matches_jax(case):
    spec = CASES[case]
    src, tgt, valid, seeds = correspondences(**spec)
    n = spec["n"]
    chunk = n // 3 if n % 3 == 0 else n // 4
    keys, want, chunked = (np.asarray(a) for a in jax_topk(
        *(jnp.asarray(a) for a in (src, tgt, valid, seeds)), k=K1,
        chunk=chunk))
    assert np.array_equal(chunked, want)        # JAX's two selections agree
    ts = [torch.from_numpy(a) for a in (src, tgt, valid, seeds)]
    got = T.sc2_seed_topk(*ts, D_THRE, K1)
    assert got.dtype == torch.int32 and got.shape == (S, K1)
    assert np.array_equal(got.numpy(), want)
    # the kernel's chunks, ragged (37, 64, 100 for n = 300) or not
    for tile in (37, 64, 100, chunk, n):
        tiled = T.sc2_seed_topk_tiled_plain(*ts, D_THRE, K1, tile)
        assert np.array_equal(tiled.numpy(), want), tile
    # what each case is there for
    zero = (keys == 0).mean()
    if not valid[seeds[0]]:                     # a seed at an invalid row
        assert set(np.unique(keys[0])) <= {0.0, -1.0}
        assert np.array_equal(want[0], np.sort(want[0]))  # column order
    if case == "few_valid":
        assert valid.sum() < K1 and (keys[np.arange(S)[:, None], want]
                                     == -1).any(1).all()
    if case == "tie_heavy":
        assert zero > 0.5
    else:
        assert keys.max() > 1


def test_seed_topk_k_past_n():
    """k beyond N gives every column, as `topk` does."""
    src, tgt, valid, seeds = correspondences(4, 20, 0.5, n_invalid=3)
    ts = [torch.from_numpy(a) for a in (src, tgt, valid, seeds[:8])]
    full = T.sc2_seed_topk(*ts, D_THRE, K1)
    assert full.shape == (8, 20)
    assert torch.equal(full, T.sc2_seed_topk_tiled_plain(*ts, D_THRE, K1, 7))


@pytest.mark.parametrize("ns,n,resident,want", [
    (1000, 5000, 264, (16, 16)),    # the eval path: one wave of 2 a SM
    (1000, 5000, 132, (16, 8)),
    (64, 300, 264, (1, 5)),         # no more splits than 64-column tiles
    (5000, 5000, 264, (79, 3)),
    (3000, 8000, 264, (47, 5)),
    (10, 5000, 4096, (1, 32)),      # at most 32 splits
])
def test_k4_plan_grid(ns, n, resident, want):
    assert T.k4_plan(ns, n, resident) == want
