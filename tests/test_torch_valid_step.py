"""The valid step end to end: eval.valid_pair against the jitted JAX
StepBuilder.make_valid_step at tests/test_train_steps.py's tiny size
(SimpleNetBNE, conv1 kernel 3, 8 output channels, voxel capacity 2048, a
512-point subset, one synthetic pair at d = 1 m), both sides in f32, the
port on the JAX step's own uniforms (its key split in two, one uniform a
voxel row of each cloud).

The BN statistics and affines are perturbed so that the folding is not the
identity. Compared: loss (corr_dist of the IRLS pose) and RTE within 1e-4
m, RRE within 0.05 deg (f32 arccos quantization near 0, as
tests/test_torch_slice.py), hit_ratio equal (it depends on the matches and
T_gt only). Then a known answer for `valid_metrics`: cloud 1 the
voxelized cloud 0 under a known pose, row for row, with the same features
and subset uniforms: RTE < 0.05 m, RRE < 0.1 deg, hit_ratio >= 0.99, loss
< 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models import init_unet as jinit
from eyoc_tpu.models import load_model as jload
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import RawBatch as JRawBatch
from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training.pipeline import RawBatch
from test_train_steps import make_batch, tiny_builder, tiny_config
from test_torch_slice import centered_bn


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


KEYS = ("loss", "rte", "rre", "hit_ratio")


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, builder, params, BN state, the port's model and
    EvalConfig), one JAX valid-step program for the module."""
    jbc.set_compute_dtype(jnp.float32)
    cfg = tiny_config()
    spec = jload(cfg.model)
    params, bn = jax.jit(lambda key: jinit(
        spec, key, 1, cfg.model_n_out, cfg.conv1_kernel_size))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)
    bn = centered_bn(bn, rng)
    builder = tiny_builder(cfg, spec)
    model = ResUNet(UNetSpec(**vars(spec)), 1, cfg.model_n_out,
                    cfg.conv1_kernel_size, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, bn), strict=True)
    sc = builder.cfg
    ecfg = teval.EvalConfig(caps=sc.caps, voxel_size=sc.voxel_size,
                            window_bits=sc.window_bits,
                            eval_sample_points=sc.eval_sample_points,
                            hit_ratio_thresh=sc.hit_ratio_thresh)
    step = builder.make_valid_step()
    jbc.set_compute_dtype(jnp.bfloat16)
    return cfg, sc, step, params, bn, model, ecfg


def both_sides(setup, batch_np, seed):
    """The JAX step's metrics and the port's on the same uniforms."""
    cfg, sc, step, params, bn, model, ecfg = setup
    key = jax.random.PRNGKey(seed)
    want = step(params, bn, JRawBatch(*map(jnp.asarray, batch_np)), key)
    k0, k1 = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(
        jax.random.uniform(k, (sc.caps[0],)))) for k in (k0, k1))
    got = teval.valid_pair(model, RawBatch(*map(torch.from_numpy, batch_np)),
                           ecfg, noise=noise, device="cpu")
    return ({k: float(want[k]) for k in KEYS},
            {k: float(got[k]) for k in KEYS})


def check_close(want, got):
    for k in KEYS:
        assert np.isfinite(got[k]), k
    assert abs(got["loss"] - want["loss"]) < 1e-4
    assert abs(got["rte"] - want["rte"]) < 1e-4
    assert abs(got["rre"] - want["rre"]) < 0.05
    assert got["hit_ratio"] == want["hit_ratio"]


def test_valid_pair_matches_jax_valid_step(setup):
    batch = make_batch(setup[0], n_pairs=1, dist=1.0)
    want, got = both_sides(setup, tuple(np.asarray(a) for a in batch), 2)
    check_close(want, got)


def test_valid_metrics_known_answer(setup):
    """Cloud 1 is the voxelized cloud 0 under a known pose (0.15 rad about
    z, |t| < 1 m), row for row, both with the same random unit features,
    and the same uniforms order both subsets: the correspondences are
    exact, so the IRLS recovers the pose."""
    cfg, sc, step, params, bn, model, ecfg = setup
    batch = RawBatch(*map(torch.from_numpy, (np.asarray(a) for a in
                                             make_batch(cfg, 1, 1.0))))
    x0, _, m0, *_ = teval.embed_pair(model, batch, ecfg, device="cpu")
    a = 0.15
    T = torch.eye(4)
    T[:2, :2] = torch.tensor([[np.cos(a), -np.sin(a)],
                              [np.sin(a), np.cos(a)]])
    T[:3, 3] = torch.tensor([0.6, -0.4, 0.2])
    x1 = x0 @ T[:3, :3].T + T[:3, 3]
    gen = torch.Generator().manual_seed(4)
    f = torch.nn.functional.normalize(torch.randn(x0.shape[0], 8,
                                                  generator=gen), dim=1)
    u = torch.rand(x0.shape[0], generator=gen)
    out = teval.valid_metrics(x0, f, m0, x1, f, m0, T, ecfg, noise=(u, u))
    assert int(m0.sum()) > sc.eval_sample_points
    assert float(out["rte"]) < 0.05 and float(out["rre"]) < 0.1
    assert float(out["hit_ratio"]) >= 0.99 and float(out["loss"]) < 0.01
