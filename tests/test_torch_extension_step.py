"""The EYOC extension train step against the JAX package, on the CPU:
two whole `extension_train_step`s on a narrow two-level BN ResUNet against
`StepBuilder.make_extension_train_step()`, with the trainer's EMA labeler
sync between them (trainer.py:352-377, decay 0.2), at the published
recipe's feature filter ("None") on a small batch.

The batch is well posed for the labeling: random occupancy gives every
voxel a neighbourhood of its own, and cloud 1 is cloud 0 moved by a whole
number of bricks, so the labeler's features of a voxel in the two clouds
differ by the jitter alone and its mutual matches are the true ones (a
cloud with isolated voxels has many near-identical features, and which of
them is nearest is then decided by rounding, ROADMAP §3); num_corres is
the cloud capacity and max_points twice it, so every valid match goes to
SC2-PCR whatever order the two packages' rounding gives the weights.

The port gets the JAX step's own draws: the key splits of steps.py:342
and :475 ((k_label, k_loss, k_j0, k_j1), not the base step's order), the
jitter of :279-283, the rediscovery uniforms of :440 under
split(k_label, B), and the loss's of loss.py:81-90. Compared per step:
loss, pos_loss and neg_loss (rtol 1e-4), num_pos_found (exact) and
labeler_hit_ratio (exact, but for the queries whose nearest labeler
feature is within 1e-5 of the second: the packages' features differ by
their rounding, ~1e-6, and such a query may take the other one; each moves
its pair's ratio by at most one match, `hit_tolerance`); after both steps
every parameter and BN running statistic of the student and of the
labeler through params_from_jax (rtol 1e-4, atol 1e-5). The labeler's BN
buffers are bit-unchanged by each step's two labeler forwards."""

import copy
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_train_step import _f32_convs  # noqa: F401 (JAX convs in f32)
from test_torch_train_step import (BITS, NUM_HN, NUM_POS, assert_state_close,
                                   np_tree)

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.registration.sc2pcr import SC2PCRConfig as JSC2
from eyoc_tpu.training.optim import ema_update as jema
from eyoc_tpu.training.pipeline import RawBatch as JRawBatch
from eyoc_tpu.training.steps import StepBuilder, StepConfig, init_train_state
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
from eyoc_tpu_torch.training.loss import LossDraws
from eyoc_tpu_torch.training.optim import sgd, sync_labeler
from eyoc_tpu_torch.training import steps
from eyoc_tpu_torch.training.pipeline import RawBatch
from eyoc_tpu_torch.training.steps import (StepDraws, TrainConfig,
                                           extension_train_step)


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


CAPS = (1024, 512)
SPEC = JSpec("narrow", "BN", "BN", (8, 16), (8, 16))
LABELING = dict(num_corres=CAPS[0], rediscovery_samples=256,
                feature_filter="None", spatial_filter="Spherical",
                filter_radius=3.0, hit_ratio_thresh=0.3)
SC2 = dict(max_points=2 * CAPS[0], seed_cap=64)


def shifted_batch(seed, B=2, P=800):
    """Clouds of voxel centres (0.3 m voxels) filling 40% of a 12^3-voxel
    box at random, so that no two voxels share a neighbourhood and the
    labeler's features tell every voxel apart; cloud 1 = cloud 0 moved by
    (4, -4, 4) voxels ((8, -4, 4) for the second pair): a whole number of
    the two-level pyramid's bricks, so that cloud 1's bricks, taps and BN
    statistics are cloud 0's. Frame distance 1, search radius 0.45 m."""
    rng = np.random.default_rng(seed)
    xyz0 = np.zeros((B, P, 3), np.float32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        cells = np.argwhere(rng.random((12, 12, 12)) < 0.4)[:P]
        n[b] = len(cells)
        xyz0[b, :n[b]] = (cells + [12.5, -5.5, -5.5]) * 0.3
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, 3] = [[1.2, -1.2, 1.2], [2.4, -1.2, 1.2]]
    xyz1 = (xyz0 + T[:, None, :3, 3]).astype(np.float32)
    fields = (xyz0, n, xyz1, n.copy(), T, np.ones(B, np.int32),
              np.full(B, 0.45, np.float32))
    return (JRawBatch(*map(jax.numpy.asarray, fields)),
            RawBatch(*map(torch.from_numpy, fields)))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_extension_draws(key, B, cap0, n_rows):
    key, sub = jax.random.split(key)
    k_label, k_loss, k_j0, k_j1 = jax.random.split(sub, 4)

    def jitter(k):
        kk, kg = jax.random.split(k)
        return (jax.random.uniform(kk, (B,)),
                jax.random.normal(kg, (n_rows, 1))[:, 0])

    noise = jax.vmap(lambda k: jax.random.uniform(k, (cap0,)))(
        jax.random.split(k_label, B))
    k0, k1, kp = jax.random.split(k_loss, 3)
    u = jax.random.uniform
    return key, (*jitter(k_j0), *jitter(k_j1),
                 LossDraws(u(k0, (NUM_HN,)), u(k1, (NUM_HN,)),
                           u(kp, (NUM_POS,))), noise)


def jax_extension_draws(key, B, cap0):
    """(next key, StepDraws): the random numbers one jitted extension step
    draws from `key`."""
    key, arrs = _jax_extension_draws(key, B, cap0, B * cap0)
    t = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), arrs)
    return key, StepDraws(*t)


def hit_tolerance(labeler, batch, cfg, draws, gap=1e-5):
    """How far labeler_hit_ratio may move between the two packages: the
    labeler's features differ between them by ~1e-6 (the forward's
    rounding), so a query whose nearest labeler feature is within `gap`
    (d2, f64) of the second may take the other one, and each such query
    moves its pair's ratio by at most one match in its pair's count
    (ROADMAP §3). Returns the mean over the pairs of (near-tied queries) /
    (valid queries), from the port's labeler features of the step: 0 when
    no query is near-tied."""
    vox0, pyr0, vox1, pyr1 = steps._preprocess(batch, cfg)
    B = batch.xyz0.shape[0]
    in0, in1 = steps._inputs(cfg, draws, B * CAPS[0])
    with torch.no_grad():
        F0 = labeler.train()(pyr0, in0, bn_momentum=None).double()
        F1 = labeler(pyr1, in1, bn_momentum=None).double()
    m0, m1 = vox0.mask.reshape(-1), vox1.mask.reshape(-1)
    tol = 0.0
    for b in range(B):
        rows = slice(b * CAPS[0], (b + 1) * CAPS[0])
        tied = 0
        for q, qm, r, rm in ((F0[rows], m0[rows], F1[rows], m1[rows]),
                             (F1[rows], m1[rows], F0[rows], m0[rows])):
            two = torch.topk(torch.cdist(q[qm], r[rm]) ** 2, 2,
                             largest=False).values
            tied += int(((two[:, 1] - two[:, 0]) < gap).sum())
        tol += tied / float(m0[rows].sum() + m1[rows].sum()) / B
    return tol


def jax_sync(state):
    """The trainer's EMA sync of an initialized labeler (decay 0.2)."""
    return state._replace(
        labeler_params=jema(state.labeler_params, state.params, 0.2,
                            int(state.num_updates)),
        labeler_bn_state=state.bn_state, num_updates=state.num_updates + 1)


def test_two_extension_steps_match_jax():
    params, bn = jax.jit(lambda k: jinit(SPEC, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    state = state._replace(num_updates=np.int32(1))   # the first sync
    step = StepBuilder(StepConfig(
        spec=SPEC, caps=CAPS, voxel_size=0.3, conv1_kernel_size=5,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
        sc2=JSC2(**SC2), **LABELING,
    )).make_extension_train_step()
    jbatch, tbatch = shifted_batch(6)

    model = ResUNet(UNetSpec(**vars(SPEC)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    labeler = copy.deepcopy(model)
    n_updates = sync_labeler(labeler, model, 0)
    opt = sgd(model.parameters(), lr=0.1)
    cfg = TrainConfig(caps=CAPS, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS,
                      sc2=SC2PCRConfig(**SC2), **LABELING)
    key = state.key
    for i in range(2):
        if i:
            state = jax_sync(state)
            n_updates = sync_labeler(labeler, model, n_updates, "EMA", 0.2)
        key, draws = jax_extension_draws(key, 2, CAPS[0])
        hit_tol = hit_tolerance(labeler, tbatch, cfg, draws)
        state, jm = step(state, jbatch, 0.1)
        buffers = {k: v.clone() for k, v in labeler.named_buffers()}
        tm = extension_train_step(model, labeler, opt, tbatch, cfg,
                                  draws=draws, device="cpu")
        for k, v in labeler.named_buffers():
            assert torch.equal(v, buffers[k]), k
        assert float(tm["num_pos_found"]) == float(jm["num_pos_found"]) > 300
        assert float(jm["labeler_hit_ratio"]) > 0.9
        np.testing.assert_allclose(float(tm["labeler_hit_ratio"]),
                                   float(jm["labeler_hit_ratio"]), rtol=0,
                                   atol=hit_tol)
        for k in ("loss", "pos_loss", "neg_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    assert n_updates == int(state.num_updates) == 2
    assert np.array_equal(np.asarray(key), np.asarray(state.key))
    assert_state_close(model, state.params, state.bn_state, 1e-4, 1e-5)
    assert_state_close(labeler, state.labeler_params,
                       state.labeler_bn_state, 1e-4, 1e-5)
