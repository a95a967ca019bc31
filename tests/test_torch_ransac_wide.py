"""RANSAC past K18's one-block rows: the port's plain `ransac_registration`
at N = 9000 correspondences (`cli.test --use_ransac --eval_sample_points`
above 8192 reaches it; on the card its polish takes K18's wide route)
against the JAX package's `ransac_registration` on JAX's own uniforms, at
the tolerances of tests/test_torch_ransac.py::test_ransac_matches_jax:
the pose within 1e-4 m and 1e-3 deg, the inlier counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.registration import ransac as jransac
from eyoc_tpu_torch.registration import ransac
from test_torch_ransac import TWO_STAGE, correspondences, jax_stages, pose_gap


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


N = 9000


@pytest.mark.parametrize("inlier,nv", [(0.5, N), (0.2, N - 400)])
def test_ransac_past_one_block_matches_jax(inlier, nv):
    assert N > ransac.K18_BLOCK_ROWS
    src, tgt, valid, T_true = correspondences(90 + nv % 7, N, inlier, nv)
    key = jax.random.PRNGKey(nv)
    j = (jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid))
    u_tri, u_sub = (np.array(x) for x in jax_stages(*j, key, TWO_STAGE)[:2])
    T_j, inl_j = jax.jit(jransac.ransac_registration,
                         static_argnames=("cfg",))(*j, key, cfg=TWO_STAGE)
    tcfg = ransac.RansacConfig(**vars(TWO_STAGE))
    assert ransac.two_stage(tcfg, N)
    T_t, inl_t = ransac.ransac_registration(
        *map(torch.from_numpy, (src, tgt, valid)), tcfg,
        (torch.from_numpy(u_tri), torch.from_numpy(u_sub)))
    te, re = pose_gap(T_t.numpy(), np.array(T_j))
    assert te < 1e-4 and re < 1e-3, (te, re)
    assert int(inl_t) == int(inl_j)
    te, re = pose_gap(T_t.numpy(), T_true)
    assert te < 0.1 and re < 0.5
