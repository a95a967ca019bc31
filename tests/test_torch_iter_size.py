"""iter_size gradient accumulation in the port's train step against the JAX
package (eyoc_tpu/training/steps.py:_wrap_accumulating, :330-375; reference
lib/trainer.py:239-293: loss / iter_size, accumulate, one optimizer step),
on the CPU.

(a) base_train_step at iter_size 2 on two micro-batches against
    StepBuilder.make_base_train_step("gt") with iter_size=2 on the stacked
    batch, the port given the JAX step's own draws (its key splits,
    steps.py:342, 359, 386 and loss.py:81-90): after one step the averaged
    loss, pos/neg loss (rtol 1e-4) and num_pos_found (exact), every
    parameter and BN running statistic (rtol 1e-4, atol 1e-5; JAX convs in
    f32). The stacked form (fields with a leading [2] axis) gives the same
    bits as the list.
(b) the accumulation's semantics with a stub micro-step, as
    tests/test_iter_size.py::TestAccumulationSemantics: the gradients are
    averaged, the metrics averaged, one SGD step with momentum and weight
    decay (parameters against JAX's _wrap_accumulating on the same stub,
    rtol 1e-6, atol 1e-7), the BN state chained through the micro-batches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.pipeline import RawBatch as JRawBatch
from eyoc_tpu.training.steps import StepBuilder, StepConfig, init_train_state
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training import steps as tsteps
from eyoc_tpu_torch.training.loss import LossDraws
from eyoc_tpu_torch.training.optim import sgd
from eyoc_tpu_torch.training.pipeline import RawBatch
from eyoc_tpu_torch.training.steps import (StepDraws, TrainConfig,
                                           base_train_step, micro_batches)

BITS = (7, 7, 6)
CAPS = (1024, 512)
NUM_POS, NUM_HN = 256, 128
# a two-level BN spec without residual blocks: the JAX step compiles in
# about half the time of one with blocks
JS = JSpec("narrow", "BN", None, (8, 16), (8, 16))


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


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def raw_batch(seed, B=2, P=1500):
    """Cloud 1 is cloud 0 seen from a pose T (plus noise)."""
    rng = np.random.default_rng(seed)
    xyz0 = rng.normal(0, 4, (B, P, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        a = rng.uniform(-0.2, 0.2)
        T[b, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[b, :3, 3] = rng.uniform(-0.5, 0.5, 3)
    xyz1 = (np.einsum("bij,bpj->bpi", T[:, :3, :3], xyz0) + T[:, None, :3, 3]
            + rng.normal(0, 0.03, xyz0.shape)).astype(np.float32)
    n = np.array([P - 300 * b for b in range(B)], np.int32)
    return (xyz0, n, xyz1, n.copy(), T, np.ones(B, np.int32),
            np.full(B, 0.45, np.float32))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_accum_draws(key, B, n_rows, iter_size):
    """The draws of one jitted step at iter_size: key, sub = split(key);
    one key a micro-batch from sub; each split into the two jitters' keys
    and the loss's."""
    key, sub = jax.random.split(key)
    out = []
    for k in jax.random.split(sub, iter_size):
        k_j0, k_j1, k_loss = jax.random.split(k, 3)

        def jitter(k):
            kk, kg = jax.random.split(k)
            return (jax.random.uniform(kk, (B,)),
                    jax.random.normal(kg, (n_rows, 1))[:, 0])

        k0, k1, kp = jax.random.split(k_loss, 3)
        u = jax.random.uniform
        out.append((*jitter(k_j0), *jitter(k_j1),
                    (u(k0, (NUM_HN,)), u(k1, (NUM_HN,)), u(kp, (NUM_POS,)))))
    return key, out


def test_base_train_step_iter_size_2_matches_jax():
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, 3))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    step = StepBuilder(StepConfig(
        spec=JS, caps=CAPS, voxel_size=0.3, conv1_kernel_size=3,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
        iter_size=2)).make_base_train_step("gt")
    fields = [raw_batch(5), raw_batch(9)]
    stacked = JRawBatch(*(jnp.stack([jnp.asarray(a), jnp.asarray(b)])
                          for a, b in zip(*fields)))
    key, arrs = _jax_accum_draws(state.key, 2, 2 * CAPS[0], 2)
    state, jm = step(state, stacked, 0.1)
    assert np.array_equal(np.asarray(key), np.asarray(state.key))
    draws = [StepDraws(*(torch.from_numpy(np.array(a)) for a in d[:4]),
                       LossDraws(*(torch.from_numpy(np.array(a))
                                   for a in d[4])))
             for d in arrs]

    cfg = TrainConfig(caps=CAPS, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS, iter_size=2)
    micro = [RawBatch(*map(torch.from_numpy, f)) for f in fields]
    models = []
    for batch in (micro, RawBatch(*(torch.stack(x) for x in zip(*micro)))):
        model = ResUNet(UNetSpec(**vars(JS)), 1, 16, 3, dtype=torch.float32)
        model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
        opt = sgd(model.parameters(), lr=0.1)
        tm = base_train_step(model, opt, batch, cfg, draws=draws,
                             device="cpu")
        models.append(model)
    assert float(tm["num_pos_found"]) == float(jm["num_pos_found"]) > 300
    for k in ("loss", "pos_loss", "neg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax(np_tree(state.params), np_tree(state.bn_state))
    got = models[0].state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for name, v in models[1].state_dict().items():
        assert torch.equal(v, got[name]), name


def test_micro_batches_checks_the_count():
    b = RawBatch(*map(torch.from_numpy, raw_batch(1, P=20)))
    assert micro_batches(b, 1) == [b]
    with pytest.raises(ValueError, match="3 micro-batches"):
        micro_batches([b, b, b], 2)
    with pytest.raises(ValueError, match="stacked RawBatch"):
        micro_batches(b, 2)


# -------------------------------------------------------------------- (b)


def test_accumulation_averages_grads_and_metrics():
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, 3))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    builder = StepBuilder(StepConfig(
        spec=JS, caps=CAPS, voxel_size=0.3, conv1_kernel_size=3,
        window_bits=BITS, iter_size=2))
    rng = np.random.RandomState(0)
    xyz = rng.randn(2, 2, 16, 3).astype(np.float32)

    def jstub(params, bn_state, batch, key):
        s = jnp.mean(batch.xyz0)
        grads = jax.tree_util.tree_map(
            lambda p: jnp.full_like(p, s) + 0.001 * p.size, params)
        return grads, bn_state, {"loss": s, "pos_loss": s, "neg_loss": s}

    jbatch = JRawBatch(xyz, np.full((2, 2), 16, np.int32), xyz,
                       np.full((2, 2), 16, np.int32),
                       np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1)),
                       np.ones((2, 2), np.int32),
                       np.full((2, 2), 0.45, np.float32))
    new_state, jm = builder._wrap_accumulating(jstub)(state, jbatch, 0.05)

    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, 3, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    opt = sgd(model.parameters(), lr=0.05)          # momentum 0.8, wd 1e-4
    mean0 = model.norm1.running_mean.clone()

    def tstub(batch, draws):
        # grads s + 0.001 * numel for every element; the BN state moves by
        # s, so a chained state ends at mean0 + s1 + s2
        s = batch.xyz0.mean()
        loss = sum((s + 0.001 * p.numel()) * p.sum()
                   for p in model.parameters())
        with torch.no_grad():
            model.norm1.running_mean.add_(s)
        return loss, {"loss": s, "pos_loss": s, "neg_loss": s}

    batches = [RawBatch(torch.from_numpy(xyz[i]), None, None, None, None,
                        None, None) for i in range(2)]
    tm = tsteps._accumulate(opt, tstub, batches, [None, None],
                            lambda name: None)
    s = [float(xyz[i].mean()) for i in range(2)]
    np.testing.assert_allclose(float(tm["loss"]), np.mean(s), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(model.norm1.running_mean.numpy(),
                               (mean0 + s[0] + s[1]).numpy(), rtol=1e-6)
    want = params_from_jax(np_tree(new_state.params),
                           np_tree(new_state.bn_state))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
