"""K13's selection in plain torch (`sc2pcr.sc2_nms_rank_plain`: each
nonzero local score ranked by count among the others, the zero rows placed
by a scan) against JAX `eyoc_tpu.registration.sc2pcr._pick_seeds` under
`jax.jit` and against `sc2_nms_plain` (the stable sort it replaces on the
card), problem by problem, on tie-heavy inputs made with numpy: N = 256
points in a 40 m cube, B = 3 problems with 256, 40 and 3 valid rows.

- scores quantized to 5 or 20 levels (ties among the local maxima and
  across the radius), all zero, and a radius that leaves fewer local
  maxima than seeds;
- S = 64 (above two problems' valid rows) and S = N;
- seeds and seed_ok bit-equal to both.

-0.0 is the one known difference: lax.top_k orders -0.0 after +0.0,
torch.sort (and K13) ties them by index; and under jit XLA makes a
suppressed negative score's local score +0.0 where torch's product gives
-0.0. A local score is -0.0 only where a score is negative or -0.0, which
SC2-PCR's confidences (a power iteration of a nonnegative matrix, times
the valid mask) never are; the last test pins both orders.
"""

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


N = 256
VALID_ROWS = (N, 40, 3)


def problems(seed, levels):
    """src [3, N, 3] f32, valid [3, N], scores [3, N] (0 at invalid rows;
    `levels` quantization steps, 0: all zero)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (3, N, 3)).astype(np.float32)
    valid = np.zeros((3, N), bool)
    for b, nv in enumerate(VALID_ROWS):
        valid[b, rng.permutation(N)[:nv]] = True
    if levels:
        scores = (np.round(rng.random((3, N)) * levels) / levels)
    else:
        scores = np.zeros((3, N))
    return src, valid, (scores * valid).astype(np.float32)


def masked_dist(src, valid):
    """[N, N] f32 distances as sqrt((dx*dx + dy*dy) + dz*dz), unfused (the
    port's _norm3), inf where either row is invalid (sc2pcr.py:291)."""
    d = src[:, None, :] - src[None, :, :]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    dist = np.sqrt(x * x + y * y + z * z)
    return np.where(valid[:, None] & valid[None, :], dist,
                    np.float32(np.inf)).astype(np.float32)


_pick_seeds = jax.jit(J._pick_seeds, static_argnums=(2, 3))


def jax_seeds(src, valid, scores, radius, S):
    out = [_pick_seeds(jnp.asarray(masked_dist(src[b], valid[b])),
                       jnp.asarray(scores[b]), radius, S)
           for b in range(src.shape[0])]
    return (np.stack([np.asarray(s) for s, _ in out]),
            np.stack([np.asarray(ok) for _, ok in out]))


@pytest.mark.parametrize("levels,radius,S", [(5, 8.0, 64), (20, 8.0, N),
                                             (0, 8.0, 64), (20, 30.0, 64),
                                             (5, 0.5, 64)])
def test_rank_matches_jax_pick_seeds(levels, radius, S):
    src, valid, scores = problems(levels + int(radius), levels)
    args = tuple(map(torch.from_numpy, (src, valid, scores)))
    seeds, ok = T.sc2_nms_rank_plain(*args, radius, S)
    want = T.sc2_nms_plain(*args, radius, S)
    assert torch.equal(seeds, want[0]) and torch.equal(ok, want[1])
    sj, okj = jax_seeds(src, valid, scores, radius, S)
    assert np.array_equal(seeds.numpy(), sj)
    assert np.array_equal(ok.numpy(), okj)
    maxima = ok.sum(1)
    if levels == 0:                       # every row a zero row
        assert int(maxima.sum()) == 0
        assert torch.equal(seeds, torch.arange(S).int().expand(3, S))
    elif radius == 30.0:                  # fewer local maxima than seeds
        assert int(maxima[0]) < S
    # the problems with fewer valid rows than seeds: a zero tail
    assert bool((maxima[1:] <= torch.tensor(VALID_ROWS[1:])).all())


def test_rank_orders_signed_zeros_by_index():
    """-0.0 against +0.0 (negative scores, -0.0 scores): K13's order (and
    torch.sort's) ties them by index; lax.top_k puts +0.0 first. The
    positive seeds, seed_ok and the set of zero rows agree."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-20, 20, (1, N, 3)).astype(np.float32)
    valid = np.ones((1, N), bool)
    scores = (np.round(rng.random((1, N)) * 10) / 10 - 0.3).astype(np.float32)
    scores[0, ::7] = -0.0
    args = tuple(map(torch.from_numpy, (src, valid, scores)))
    S = N
    seeds, ok = T.sc2_nms_rank_plain(*args, 4.0, S)
    want = T.sc2_nms_plain(*args, 4.0, S)
    assert torch.equal(seeds, want[0]) and torch.equal(ok, want[1])
    sj, okj = jax_seeds(src, valid, scores, 4.0, S)
    assert np.array_equal(ok.numpy(), okj)
    P = int(ok.sum())
    assert np.array_equal(seeds[0, :P].numpy(), sj[0, :P])
    sc = scores[0]
    relation = (sc[:, None] >= sc[None, :]) | \
        (masked_dist(src[0], valid[0]) >= 4.0)
    z = int((sc * relation.all(1) == 0).sum())
    # the kernel's zero rows: index order, -0.0 and +0.0 mixed
    mine = seeds[0, P:P + z].numpy()
    assert set(mine) == set(sj[0, P:P + z]) and np.all(np.diff(mine) > 0)
    # lax.top_k's: the +0.0 rows first, then the -0.0 ones (the signs of
    # XLA's own local scores)
    local = jax.jit(lambda d, s: s * jnp.min(
        (s[:, None] >= s[None, :]) | (d >= 4.0), axis=-1).astype(s.dtype))(
        jnp.asarray(masked_dist(src[0], valid[0])), jnp.asarray(sc))
    neg = np.signbit(np.asarray(local)[sj[0, P:P + z]])
    assert neg.any() and not neg[:np.argmax(neg)].any() \
        and neg[np.argmax(neg):].all()
    assert not np.array_equal(mine, sj[0, P:P + z])
