"""Sync-BN's two-launch form of K21 (csrc/norm_backward.cu: the sums pass
`eyoc_masked_norm_backward_sums`, backward_coop<true>, and the finish pass
`eyoc_masked_norm_backward_finish`) built with g++ against tests/cuda_host/
and run through the wrappers' launch code on CPU bf16 tensors, as
tests/test_torch_norm_backward_emulated.py runs the one-launch form.

(a) One rank: the sums pass, then the finish pass on its own sums, gives
    the one-launch form's bits (dx, dresidual, dscale, dbias) on its grid,
    every tail, over 2-8 blocks; the sums are the plain version's within
    K21_REL of the sums of absolute values.
(b) Two ranks emulated: each rank's sums pass on its half of a batch, the
    sums added as the all_reduce adds them, then each rank's finish pass:
    dx within BF16_ULPS of `masked_norm_backward_finish_plain` on the same
    added sums, and dx equal to the plain version's on the whole batch's
    rows (one segment over both halves) within BF16_ULPS; dscale and dbias
    from the rank's own sums, the plain version's within rtol 1e-5, atol
    1e-4 (f32 sums of ~1e3 terms in two orders)."""

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.sparse import norm as N
from eyoc_tpu_torch.utils import kernels
from test_torch_instance_norm import ulps_apart
from test_torch_norm_backward import TAILS, backward_case
from test_torch_norm_backward_emulated import (  # noqa: F401 (fixtures)
    BF16_ULPS, K21_REL, _one_torch_thread, abs_sums, host_libs, on_host)

# (rows, C, the blocks the card is said to hold): the batch norm's one
# segment spread over several blocks
CASES = [(3000, 32, 8), (2000, 256, 5), (600, 512, 3), (700, 64, 2)]


@pytest.mark.parametrize("M,C,blocks", CASES)
def test_two_launches_give_the_one_launch_bits(on_host, M, C, blocks):
    _, resident = on_host
    resident["blocks"] = blocks
    for tail in TAILS:
        args = backward_case(1, M, C, 70 + C, tail, torch.bfloat16)
        x, mask, S, scale, stats, dy, y, dpre, residual = args
        one = N._launch_k21(*args, "masked_norm_backward_bn")
        before = kernels.launches["masked_norm_backward_sync"]
        sums = N._launch_k21_sums(x, mask, S, stats, dy, y, dpre)
        want = N.masked_norm_backward_sums_plain(x, mask, S, stats, dy, y,
                                                 dpre)
        sdy_abs, sdyxh_abs = abs_sums(x, mask, S, stats, dy, y, dpre)
        assert sums[0, 0] == want[0, 0]
        for got_s, want_s, size in ((sums[:, 1:1 + C], want[:, 1:1 + C],
                                     sdy_abs),
                                    (sums[:, 1 + C:], want[:, 1 + C:],
                                     sdyxh_abs / stats[:, C:2 * C])):
            assert float(((got_s - want_s).abs() - K21_REL * size).max()) \
                <= 0, tail
        two = N._launch_k21_finish(x, mask, S, scale, stats, sums, sums,
                                   dy, y, dpre, residual)
        assert kernels.launches["masked_norm_backward_sync"] == before + 1
        for a, b in zip(one, two):
            if a is None:
                assert b is None
                continue
            assert torch.equal(a, b), tail


@pytest.mark.parametrize("M,C,blocks", CASES[:2])
def test_two_ranks_emulated(on_host, M, C, blocks):
    _, resident = on_host
    resident["blocks"] = blocks
    for tail in TAILS:
        args = backward_case(1, 2 * M, C, 90 + C, tail, torch.bfloat16)
        x, mask, S, scale, stats, dy, y, dpre, residual = args
        whole = N.masked_norm_backward_plain(*args)

        def half(t, r):
            return None if t is None else t[r * M:(r + 1) * M].contiguous()
        parts = [N._launch_k21_sums(half(x, r), half(mask, r), S, stats,
                                    half(dy, r), half(y, r), half(dpre, r))
                 for r in range(2)]
        added = parts[0] + parts[1]
        for r in range(2):
            got = N._launch_k21_finish(half(x, r), half(mask, r), S, scale,
                                       stats, added, parts[r], half(dy, r),
                                       half(y, r), half(dpre, r), residual)
            plain = N.masked_norm_backward_finish_plain(
                half(x, r), half(mask, r), S, scale, stats, added, parts[r],
                half(dy, r), half(y, r), half(dpre, r), residual)
            assert ulps_apart(got[0], plain[0]) <= BF16_ULPS
            assert ulps_apart(got[0], half(whole[0], r)) \
                <= BF16_ULPS, tail
            if residual:
                assert torch.equal(got[1], plain[1])
            # dscale and dbias: this rank's own sums, as the plain version
            for g, p in zip(got[2:], plain[2:]):
                np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                           atol=1e-4)
