"""K8 `masked_knn2`'s reformulation on the CPU: the cross term of the Gram
form on the 3xTF32 split, in the kernel's windows, splits and merge order
(`masked_knn2_gram_split_plain`), against the plain version
`masked_knn2_plain` and the JAX package's masked_knn(k=2), on [2, 700, 32]
unit features with masks and duplicate rows, from a numpy seed:

- d2 within 1e-4 relative plus the Gram form's rounding, 1e-6 (|q|^2 +
  max |r|^2), where a valid ref fills the place; (1e30, 0) elsewhere;
- the first index equal where the f64 gap between the first and second
  nearest valid refs exceeds K2_GAP plus twice that rounding, the second
  where the gap to the third does too;
- duplicate refs resolved to the lowest index first;
- every split and window size the same bits as one sweep;

and `tf32_split` (hi keeps 10 explicit mantissa bits, rounded to nearest
with ties away from zero; |a - hi - lo| <= 2^-21 |a|). The tensor-core
kernel itself runs only on the card (`chip_smoke.py` holds it to the plain
version on the gated step's [16, 16384, 32])."""

import functools

import jax
import numpy as np
import pytest
import torch

from eyoc_tpu.ops.knn import masked_knn as jknn
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


B, NQ, NR, D = 2, 700, 700, 32
K2_GAP = 1e-3              # chip_smoke.py's: indices equal past this gap
DUPS = ((1, 3, 4), (7, 650))


def inputs(seed):
    """Unit features [B, N, 32] with duplicate ref rows (indices DUPS, all
    valid) and masks with invalid queries and refs."""
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    q, r = unit(B, NQ, D), unit(B, NR, D)
    qm, rm = rng.random((B, NQ)) < 0.8, rng.random((B, NR)) < 0.7
    for dup in DUPS:
        r[:, list(dup)] = r[:, dup[0], None]
        rm[:, list(dup)] = True
    # queries on a duplicate (a tie at the first place)
    q[:, :5] = r[:, [1, 7, 1, 7, 1]]
    qm[:, :5] = True
    return q, qm, r, rm


def f64_smallest(q, r, rm, k=3):
    d = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64))
         ** 2).sum(-1)
    d[:, ~rm] = np.inf
    return np.sort(d, 1)[:, :k]


def check(d, i, q, qm, r, rm, d_ref, i_ref):
    """d2 and indices held to a reference as the module docstring says."""
    gram = 1e-6 * ((q * q).sum(1) + (r * r).sum(1).max())
    found = qm[:, None] & (d_ref < 1e29)
    err = np.abs(d - d_ref)
    assert (err <= 1e-4 * np.abs(d_ref) + gram[:, None])[found].all()
    np.testing.assert_array_equal(d[~found], np.float32(1e30))
    np.testing.assert_array_equal(i[~found], 0)
    t = f64_smallest(q, r, rm)
    g = K2_GAP + 2 * gram
    clear0 = qm & (t[:, 1] - t[:, 0] > g)
    clear1 = clear0 & (t[:, 2] - t[:, 1] > g)
    np.testing.assert_array_equal(i[clear0, 0], i_ref[clear0, 0])
    np.testing.assert_array_equal(i[clear1, 1], i_ref[clear1, 1])
    return int(clear0.sum())


@pytest.mark.parametrize("splits,tile", [(1, 128), (3, 16), (5, 128),
                                         (2, 700)])
def test_gram_split_matches_plain_and_jax(splits, tile):
    q, qm, r, rm = inputs(splits)
    jfn = jax.jit(functools.partial(jknn, k=2, tile=128))
    for b in range(B):
        args = [torch.from_numpy(np.ascontiguousarray(a[b]))
                for a in (q, qm, r, rm)]
        d, i = knn.masked_knn2_gram_split_plain(*args, splits=splits,
                                                tile=tile)
        assert d.dtype == torch.float32 and i.dtype == torch.int32
        d, i = d.numpy(), i.numpy()
        d_p, i_p = (x.numpy() for x in knn.masked_knn2_plain(*args))
        d_j, i_j = (np.asarray(x) for x in jfn(q[b], qm[b], r[b], rm[b]))
        assert check(d, i, q[b], qm[b], r[b], rm[b], d_p, i_p) > NQ // 2
        check(d, i, q[b], qm[b], r[b], rm[b], d_j, i_j)
        # a query on a duplicate: the lowest index first, the next second
        for row, (first, second) in enumerate([(1, 3), (7, 650), (1, 3),
                                               (7, 650), (1, 3)]):
            assert (i[row, 0], i[row, 1]) == (first, second)
            assert d[row, 0] == d[row, 1]
        # the windows and splits give one sweep's bits
        d1, i1 = knn.masked_knn2_gram_split_plain(*args, splits=1, tile=NR)
        assert np.array_equal(d, d1.numpy()) and np.array_equal(i, i1.numpy())


def test_gram_split_without_valid_refs():
    """No valid ref: every place reads (1e30, 0); one: the second does."""
    q, qm, r, rm = (torch.from_numpy(np.ascontiguousarray(a[0]))
                    for a in inputs(9))
    none = torch.zeros_like(rm)
    d, i = knn.masked_knn2_gram_split_plain(q, qm, r, none, splits=3, tile=64)
    assert bool((d == 1e30).all()) and bool((i == 0).all())
    one = none.clone()
    one[57] = True
    d, i = knn.masked_knn2_gram_split_plain(q, qm, r, one, splits=3, tile=64)
    assert bool((i[qm, 0] == 57).all()) and bool((d[:, 1] == 1e30).all())
    assert bool((i[:, 1] == 0).all()) and bool((d[~qm] == 1e30).all())


def test_tf32_split():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=20000) * 10.0 ** rng.uniform(-20, 20, 20000))
    a = torch.from_numpy(a.astype(np.float32))
    hi, lo = knn.tf32_split(a)
    for x in (hi, lo):                     # 10 explicit mantissa bits
        assert bool(((x.view(torch.int32) & 0x1FFF) == 0).all())
    a64, hi64, lo64 = a.double(), hi.double(), lo.double()
    assert bool(((a64 - hi64).abs() <= 2.0 ** -11 * a64.abs()).all())
    assert bool(((a64 - hi64 - lo64).abs() <= 2.0 ** -21 * a64.abs()).all())
    assert torch.equal(knn.tf32_split(-a)[0], -hi)
    # a tie (the 13 dropped bits exactly half) goes away from zero
    tie = torch.tensor([0x3F801000, 0x3F803000], dtype=torch.int32)
    up = torch.tensor([0x3F802000, 0x3F804000], dtype=torch.int32)
    for sign in (1, -1):
        h, _ = knn.tf32_split(sign * tie.view(torch.float32))
        assert torch.equal(h, sign * up.view(torch.float32))
