"""K18 `ransac_polish` past one block's rows (csrc/ransac.cu: `polish<true>`,
one thread-block cluster of K18_CLUSTER CTAs, each holding the valid rows
of its share of the input in shared memory, the CTAs' sums added in rank
order through distributed shared memory), its own source built for the
host with g++ against tests/cuda_host/ (whose cluster launch runs the
CTAs as fibers of one grid, `map_shared_rank` onto each other's dynamic
shared memory) and run through the wrapper's launch code on CPU tensors:

- at K18_BLOCK_ROWS + 1 rows (one past the one-block route) and at a row
  count that is not a multiple of the CTA count with holes in `valid`: the
  pose within 1e-5 of `ransac_polish_plain`, the inlier counts equal; the
  same bits on a second call;
- the rounds end at their fixed point: 5 and 12 rounds against the plain
  version, and 12 rounds the bits of 5;
- fewer than 3 inliers keep the start pose; 3 solve.

What only the card can show (nvcc, a cluster placed on 8 SMs, the real
interleaving) is `chip_smoke.py`'s (its `ransac_polish_wide` row)."""

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.registration import ransac
from test_torch_ransac import correspondences
from test_torch_ransac_emulated import (THR, host_lib, on_host,  # noqa: F401
                                        start_pose)


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


POSE_TOL = 1e-5


def wide_problem(n, hole, seed, inlier=0.5):
    src, tgt, _, T = correspondences(seed, n, inlier, n)
    valid = np.random.default_rng(seed).random(n) >= hole
    src, tgt, valid = map(torch.from_numpy, (src, tgt, valid))
    return start_pose(T, seed), torch.zeros((), dtype=torch.int32), src, \
        tgt, valid


@pytest.mark.parametrize("n,hole,seed", [
    (ransac.K18_BLOCK_ROWS + 1, 0.0, 11),
    (20003, 0.3, 12),
])
def test_k18_wide_source_matches_plain(on_host, n, hole, seed):
    trans, best, src, tgt, valid = wide_problem(n, hole, seed)
    T_k, inl_k = ransac._launch_k18(trans, best, src, tgt, valid, THR, 5)
    T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                            THR, 5)
    assert float((T_k - T_p).abs().max()) < POSE_TOL
    assert int(inl_k) == int(inl_p) > int(valid.sum()) * 0.4
    if seed == 11:
        T_2, inl_2 = ransac._launch_k18(trans, best, src, tgt, valid, THR, 5)
        assert torch.equal(T_2, T_k) and int(inl_2) == int(inl_k)


def test_k18_wide_source_stops_at_its_fixed_point(on_host):
    trans, best, src, tgt, valid = wide_problem(ransac.K18_BLOCK_ROWS + 77,
                                                0.1, 14, inlier=0.3)
    got = {}
    for iters in (5, 12):
        got[iters] = ransac._launch_k18(trans, best, src, tgt, valid, THR,
                                        iters)
        T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                                THR, iters)
        assert float((got[iters][0] - T_p).abs().max()) < POSE_TOL
        assert int(got[iters][1]) == int(inl_p)
    assert torch.equal(got[5][0], got[12][0])
    assert int(got[5][1]) == int(got[12][1])


@pytest.mark.parametrize("nv", [2, 3])
def test_k18_wide_source_fewer_than_3_inliers(on_host, nv):
    """nv valid rows, in two CTAs' shares, among K18_BLOCK_ROWS + 9."""
    n = ransac.K18_BLOCK_ROWS + 9
    trans, best, src, tgt, _ = wide_problem(n, 0.0, 15, inlier=1.0)
    valid = torch.zeros(n, dtype=torch.bool)
    valid[torch.tensor([5, n - 3, n - 1][:nv])] = True
    T_k, inl_k = ransac._launch_k18(trans, best, src, tgt, valid, THR, 5)
    T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                            THR, 5)
    assert int(inl_k) == int(inl_p) == nv
    if nv < 3:
        assert torch.equal(T_k, trans[0])
    else:
        assert not torch.equal(T_k, trans[0])
        assert float((T_k - T_p).abs().max()) < POSE_TOL
