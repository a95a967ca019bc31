"""The test protocol with RANSAC (`eval.test_pair(use_ransac=True)`)
against the JAX package's `make_test_step(use_ransac=True)` on the CPU, on
a narrow two-level net and small caps, `downsample_single` 1.0 and 0.5, on
the JAX step's own draws (the key splits of steps.py:619-638): the pose
within 1e-4 m and 1e-3 deg, RTE and RRE within 1e-4. (RANSAC's own stages
are held to the JAX package in test_torch_ransac.py.)"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.registration import ransac as jransac
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import RawBatch as JRawBatch
from eyoc_tpu.training.steps import StepBuilder, StepConfig
from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.registration import ransac
from eyoc_tpu_torch.training.pipeline import RawBatch
from test_torch_ransac import pose_gap, random_pose


CAPS = (1024, 512)
BITS = (7, 7, 6)
N_SUB = 256
PAIR_RANSAC = jransac.RansacConfig(num_hypotheses=2048, coarse_subset=64,
                                   full_verify_top=128, distance_threshold=0.3)


@pytest.fixture
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def pair_batch(seed=5, P=1500):
    """One pair: cloud 1 is cloud 0 under a pose (plus noise)."""
    rng = np.random.default_rng(seed)
    xyz0 = rng.normal(0, 4, (1, P, 3)).astype(np.float32)
    T = random_pose(rng, angle=0.2, trans=0.5)[None]
    xyz1 = (np.einsum("bij,bpj->bpi", T[:, :3, :3], xyz0) + T[:, None, :3, 3]
            + rng.normal(0, 0.03, xyz0.shape)).astype(np.float32)
    n = np.array([P], np.int32)
    fields = (xyz0, n, xyz1, n.copy(), T, np.ones(1, np.int32),
              np.full(1, 0.45, np.float32))
    return (JRawBatch(*map(jnp.asarray, fields)),
            RawBatch(*map(torch.from_numpy, fields)))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_test_draws(key, cap, ds, cfg):
    """The uniforms one jitted test step draws from `key` (steps.py:
    619-638): keep and noise of each cloud, RANSAC's u_tri and u_sub."""
    k0, k1, k2 = jax.random.split(key, 3)
    keep, noise = [], []
    for kk in (k0, k1):
        if ds < 1.0:
            kk, kd = jax.random.split(kk)
            keep.append(jax.random.uniform(kd, (cap,)))
        noise.append(jax.random.uniform(kk, (cap,)))
    k_tri, k_sub = jax.random.split(k2)
    return (keep, noise, jax.random.uniform(k_tri, (cfg.num_hypotheses, 3)),
            jax.random.uniform(k_sub, (cfg.coarse_subset,)))


@pytest.mark.parametrize("ds", [1.0, 0.5])
def test_test_pair_ransac_matches_jax(ds, _f32_convs):
    js = JSpec("narrow", "BN", "BN", (8, 16), (8, 16))
    params, bn = jax.jit(lambda k: jinit(js, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    step = StepBuilder(StepConfig(
        spec=js, caps=CAPS, voxel_size=0.3, conv1_kernel_size=5,
        window_bits=BITS, eval_sample_points=N_SUB, downsample_single=ds,
    )).make_test_step(use_ransac=True, ransac=PAIR_RANSAC)
    jbatch, tbatch = pair_batch()
    key = jax.random.PRNGKey(11)
    out_j = step(params, bn, jbatch, key)

    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, bn)))
    cfg = teval.EvalConfig(caps=CAPS, voxel_size=0.3, window_bits=BITS,
                           eval_sample_points=N_SUB, use_ransac=True,
                           ransac=ransac.RansacConfig(**vars(PAIR_RANSAC)),
                           downsample_single=ds)
    keep, noise, u_tri, u_sub = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)),
        jax_test_draws(key, CAPS[0], ds, PAIR_RANSAC))
    out_t = teval.test_pair(model, tbatch, cfg, noise=tuple(noise),
                            keep=tuple(keep) if keep else None,
                            draws=(u_tri, u_sub), device="cpu")
    te, re = pose_gap(out_t["T_est"].numpy(), np.asarray(out_j["T_est"]))
    assert te < 1e-4 and re < 1e-3, (te, re)
    for k in ("rte", "rre"):
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
