"""K9 `masked_argmin_excl`'s reformulation on the CPU: the Gram form with
its cross term on the 3xTF32 split, the exclusion test in the direct form
unfused, in the kernel's windows, splits and merge order
(`masked_argmin_excl_gram_split_plain`), against the plain version
`masked_argmin_excl_plain` and the JAX package's composition of the
safe-radius mining (eyoc_tpu/training/loss.py:97-111: `pdist`, `pdist2`,
`jnp.where`, `argmin`) under jax.jit, on P = 700 anchors and M = 300
candidates of 32 unit features from a numpy seed, with duplicate candidate
rows, ~30% of the candidates excluded for a typical anchor and a few
anchors with every candidate excluded:

- the indices equal on every clear anchor (no exclusion test within 1e-4
  r^2 of the radius, and an f64 gap between the nearest and second nearest
  kept candidates above K2_GAP plus twice the Gram form's rounding, 1e-6
  (|a|^2 + max |c|^2)); the every-candidate-excluded flags equal on every
  anchor with no test in that band; (1e30, 0, True) where all are;
- a duplicate candidate resolved to the lowest index that is not excluded;
- every split and window size the same bits as one sweep;
- the exclusion bits (`excl_direct`) those of the unfused direct form,
  one f32 rounding an operation, and JAX's Gram-form test's outside the
  band.

The tensor-core kernel runs only on the card (`chip_smoke.py` holds it to
the plain version on the gated step's two minings)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry.metrics import pdist, pdist2
from eyoc_tpu_torch.ops import knn


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


P, M, D = 700, 300, 32
R = 1.05                   # the exclusion radius; candidates in a unit ball
K2_GAP = 1e-3              # chip_smoke.py's: indices equal past this gap
DUPS = ((2, 3, 9), (40, 250))
ALL_OUT = (0, 5, 17)       # anchors whose partner sits at the ball's centre


def inputs(seed):
    """(anchor [P, 32], cand [M, 32] unit features, pxyz [P, 3], cxyz
    [M, 3]): candidates uniform in the unit ball, partners 0.95-1.25 from
    its centre (about 30% of the candidates within R), those of ALL_OUT at
    the centre (every candidate within R); duplicate candidate features
    (DUPS) at different coordinates, and anchors on a duplicate."""
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.normal(size=shape)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
    a, c = unit(P, D), unit(M, D)
    for dup in DUPS:
        c[list(dup)] = c[dup[0]]
    a[20:26] = c[[2, 40, 2, 40, 9, 250]]
    cxyz = unit(M, 3) * rng.random((M, 1)).astype(np.float32) ** (1 / 3)
    pxyz = unit(P, 3) * rng.uniform(0.95, 1.25, (P, 1)).astype(np.float32)
    pxyz[list(ALL_OUT)] = 0.0
    return a, c, pxyz.astype(np.float32), cxyz.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("r",))
def jax_mining(anchor, cand, pxyz, cxyz, r):
    """loss.py:97-111's direction 0 -> 1: (argmin index, every candidate
    excluded)."""
    d = pdist(anchor, cand)
    near = pdist2(pxyz, cxyz) < jnp.float32(r * r)
    d = jnp.where(near, jnp.float32(1e9), d)
    ind = jnp.argmin(d, axis=1)
    return ind, jnp.take_along_axis(near, ind[:, None], 1)[:, 0]


def clear_anchors(a, c, pxyz, cxyz):
    """(sure: no exclusion test within 1e-4 r^2 of the radius, clear: sure
    and the nearest two kept candidates more than K2_GAP plus twice the
    Gram form's rounding apart), from f64 distances."""
    r2 = R * R
    d2x = ((pxyz[:, None].astype(np.float64) - cxyz[None]) ** 2).sum(-1)
    sure = ~(np.abs(d2x - r2) < 1e-4 * r2).any(1)
    d = ((a[:, None].astype(np.float64) - c[None]) ** 2).sum(-1)
    d[d2x < r2] = np.inf
    two = np.sort(d, 1)[:, :2]
    gram = 1e-6 * ((a * a).sum(1) + (c * c).sum(1).max())
    with np.errstate(invalid="ignore"):    # inf - inf: no kept candidate
        gap = two[:, 1] - two[:, 0]
    return sure, sure & (gap > K2_GAP + 2 * gram)


@pytest.mark.parametrize("splits,tile", [(1, 256), (3, 16), (5, 64),
                                         (2, 300)])
def test_excl_gram_split_matches_plain_and_jax(splits, tile):
    a, c, pxyz, cxyz = inputs(splits)
    args = [torch.from_numpy(x) for x in (a, c, pxyz, cxyz)]
    d, i, ex = knn.masked_argmin_excl_gram_split_plain(
        *args, R * R, splits=splits, tile=tile)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    d, i, ex = d.numpy(), i.numpy(), ex.numpy()
    i_p, ex_p = (x.numpy() for x in knn.masked_argmin_excl_plain(*args,
                                                                 R * R))
    i_j, ex_j = (np.asarray(x) for x in jax_mining(a, c, pxyz, cxyz, R))
    sure, clear = clear_anchors(a, c, pxyz, cxyz)
    assert clear.sum() > P // 2
    near = knn.excl_direct(*args[2:], R * R).numpy()
    assert 0.2 < near[~np.isin(np.arange(P), ALL_OUT)].mean() < 0.4
    for i_ref, ex_ref in ((i_p, ex_p), (i_j, ex_j)):
        np.testing.assert_array_equal(i[clear], i_ref[clear])
        np.testing.assert_array_equal(ex[sure], ex_ref[sure])
    # every candidate excluded: (1e30, 0, True)
    assert ex[list(ALL_OUT)].all() and (i[list(ALL_OUT)] == 0).all()
    np.testing.assert_array_equal(d[ex], np.float32(1e30))
    assert (d[~ex] < 1e29).all() and (d[~ex] >= 0).all()
    # an anchor on a duplicate: the lowest index not excluded
    on_dup = 0
    for row, dup in zip(range(20, 26), DUPS * 3):
        kept = [j for j in dup if not near[row, j]]
        if kept and sure[row]:
            assert i[row] == kept[0]
            on_dup += 1
    assert on_dup >= 3
    # the windows and splits give one sweep's bits
    d1, i1, ex1 = knn.masked_argmin_excl_gram_split_plain(
        *args, R * R, splits=1, tile=M)
    assert np.array_equal(d.view(np.int32), d1.numpy().view(np.int32))
    assert np.array_equal(i, i1.numpy()) and np.array_equal(ex, ex1.numpy())


def test_excl_direct_is_the_unfused_form():
    """The exclusion bits: each operation rounded to f32 in the kernel's
    order (numpy f32 scalars in the same order); JAX's Gram-form test the
    same outside 1e-4 r^2 of the radius."""
    _, _, pxyz, cxyz = inputs(7)
    # partners at every distance from the candidates, many near R
    pxyz = pxyz * np.float32(0.62)
    got = knn.excl_direct(torch.from_numpy(pxyz), torch.from_numpy(cxyz),
                          R * R).numpy()
    dx, dy, dz = (pxyz[:, None, k] - cxyz[None, :, k] for k in range(3))
    want = (dx * dx + dy * dy) + dz * dz < np.float32(R * R)
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95
    gram = np.asarray(jax.jit(pdist2)(pxyz, cxyz)) < np.float32(R * R)
    d2x = ((pxyz[:, None].astype(np.float64) - cxyz[None]) ** 2).sum(-1)
    band = np.abs(d2x - R * R) < 1e-4 * R * R
    np.testing.assert_array_equal(got[~band], gram[~band])


def test_excl_gram_split_no_candidates_kept():
    """A radius that excludes every candidate of every anchor."""
    a, c, pxyz, cxyz = (torch.from_numpy(x) for x in inputs(3))
    d, i, ex = knn.masked_argmin_excl_gram_split_plain(a, c, pxyz * 0.0,
                                                       cxyz, 4.0, splits=2,
                                                       tile=64)
    assert bool(ex.all()) and bool((i == 0).all()) and bool((d == 1e30).all())
