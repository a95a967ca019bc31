"""The supervised train step against the JAX package, on the CPU:

(g) optim.sgd (torch.optim.SGD) against sgd_update over 3 steps (rtol 1e-6,
    atol 1e-7: the same f32 operations);
(h) base_train_step, 2 steps on a narrow two-level BN ResUNet and on its
    instance-norm variant (IN block norms), against
    StepBuilder.make_base_train_step("gt"): the port gets the JAX step's
    own draws (the key splits of steps.py:342, 386, 279-283 and
    loss.py:81-90). Compared per step: loss, pos/neg loss (rtol 1e-4) and
    num_pos_found (exact); after both steps every parameter and BN running
    statistic through params_from_jax (rtol 1e-4, atol 1e-5). JAX convs
    run in f32. After a step, the eval entry points still run the eval
    forward (features bit-equal to the model in eval mode, BN statistics
    untouched).

The training kernels' wrappers never fall back to their plain versions for a
tensor that is not on the CPU."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.sparse import brick_conv as jbc
from eyoc_tpu.training.optim import sgd_init, sgd_update
from eyoc_tpu.training.pipeline import RawBatch as JRawBatch
from eyoc_tpu.training.steps import StepBuilder, StepConfig, init_train_state
from eyoc_tpu_torch import api
from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.models import ResUNet, UNetSpec, init_unet
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.ops import rows
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
from eyoc_tpu_torch.sparse import brick_conv, norm
from eyoc_tpu_torch.training.loss import LossDraws
from eyoc_tpu_torch.training.optim import exp_lr, sgd
from eyoc_tpu_torch.training.pipeline import RawBatch
from eyoc_tpu_torch.training.steps import (StepDraws, TrainConfig,
                                           base_train_step)
from eyoc_tpu_torch.utils import kernels


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


BITS = (7, 7, 6)
NUM_POS, NUM_HN = 256, 128


@pytest.fixture(autouse=True)
def _f32_convs():
    jbc.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jbc.set_compute_dtype(jnp.bfloat16)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def assert_state_close(model, params, bn, rtol, atol):
    want = params_from_jax(np_tree(params), np_tree(bn))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


# -------------------------------------------------------------------- (g)


def test_sgd_matches_sgd_update():
    rng = np.random.default_rng(0)
    shapes = {"a": (27, 4, 6), "b": (6,), "c": {"w": (5, 3), "b": (3,)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves]
    opt = sgd(tparams, lr=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = sgd_init(jp)
    update = jax.jit(functools.partial(sgd_update, lr=0.1, momentum=0.8,
                                       weight_decay=1e-4))
    for step in range(3):
        grads = [rng.normal(size=x.shape).astype(np.float32) for x in leaves]
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        jp, state = update(jp, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g) for g in grads]), state)
        for p, w in zip(tparams, jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    assert exp_lr(0.1, 0.99, 3) == pytest.approx(0.1 * 0.99 ** 2)


# -------------------------------------------------------------------- (h)


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
    fields = (xyz0, n, xyz1, n.copy(), T, np.ones(B, np.int32),
              np.full(B, 0.45, np.float32))
    return (JRawBatch(*map(jnp.asarray, fields)),
            RawBatch(*map(torch.from_numpy, fields)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_step_draws(key, B, n_rows):
    key, sub = jax.random.split(key)
    k_j0, k_j1, k_loss = jax.random.split(sub, 3)

    def jitter(k):
        kk, kg = jax.random.split(k)
        return (jax.random.uniform(kk, (B,)),
                jax.random.normal(kg, (n_rows, 1))[:, 0])

    k0, k1, kp = jax.random.split(k_loss, 3)
    u = jax.random.uniform
    return key, (*jitter(k_j0), *jitter(k_j1),
                 LossDraws(u(k0, (NUM_HN,)), u(k1, (NUM_HN,)),
                           u(kp, (NUM_POS,))))


def jax_step_draws(key, B, n_rows):
    """(next key, StepDraws): the random numbers one jitted base step draws
    from `key`."""
    key, arrs = _jax_step_draws(key, B, n_rows)
    t = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), arrs)
    return key, StepDraws(*t)


def check_base_train_step(js):
    """Two base_train_steps of spec `js` against make_base_train_step("gt")
    on the JAX step's own draws."""
    caps = (1024, 512)
    params, bn = jax.jit(lambda k: jinit(js, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    step = StepBuilder(StepConfig(
        spec=js, caps=caps, voxel_size=0.3, conv1_kernel_size=5,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
    )).make_base_train_step("gt")
    jbatch, tbatch = raw_batch(5)

    model = ResUNet(UNetSpec(**vars(js)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    opt = sgd(model.parameters(), lr=0.1)
    cfg = TrainConfig(caps=caps, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS)
    key = state.key
    for _ in range(2):
        key, draws = jax_step_draws(key, 2, 2 * caps[0])
        state, jm = step(state, jbatch, 0.1)
        tm = base_train_step(model, opt, tbatch, cfg, draws=draws,
                             device="cpu")
        assert float(tm["num_pos_found"]) == float(jm["num_pos_found"]) > 300
        for k in ("loss", "pos_loss", "neg_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    assert np.array_equal(np.asarray(key), np.asarray(state.key))
    assert_state_close(model, state.params, state.bn_state, 1e-4, 1e-5)
    return model


def test_base_train_step_matches_jax():
    check_base_train_step(JSpec("narrow", "BN", "BN", (8, 16), (8, 16)))


def test_base_train_step_matches_jax_in():
    """The same two steps with an instance-norm model (ResUNetIN-shaped: BN
    top-level norms, per-cloud IN block norms, whose JAX state is None and
    stays so)."""
    model = check_base_train_step(JSpec("narrow", "BN", "IN", (8, 16),
                                        (8, 16)))
    assert not any(k.startswith("block1.norm1.running")
                   for k in model.state_dict())


def test_eval_after_a_train_step_runs_the_eval_forward():
    """base_train_step leaves the model in train mode; the eval entry points
    still run the eval forward (as JAX's test step passes training=False):
    the same features as the model in eval mode, and the BN running
    statistics untouched."""
    caps = (1024, 512)
    spec = UNetSpec("narrow", "BN", "BN", (8, 16), (8, 16))
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 16, 5,
                      dtype=torch.float32, device="cpu")
    opt = sgd(model.parameters(), lr=0.1)
    cfg = TrainConfig(caps=caps, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS)
    base_train_step(model, opt, raw_batch(5)[1], cfg,
                    generator=torch.Generator().manual_seed(1), device="cpu")
    assert model.training
    before = {k: v.clone() for k, v in model.state_dict().items()}
    reference = copy.deepcopy(model).eval()

    pair = raw_batch(6, B=1)[1]
    ecfg = teval.EvalConfig(caps=caps, voxel_size=0.3, window_bits=BITS,
                            eval_sample_points=128,
                            sc2=SC2PCRConfig(max_points=128, seed_cap=16))
    got = teval.embed_pair(model, pair, ecfg, device="cpu")
    want = teval.embed_pair(reference, pair, ecfg, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    gen = torch.Generator().manual_seed(2)
    noise = (teval.subset_noise(got[2], gen), teval.subset_noise(got[5], gen))
    out = teval.test_pair(model, pair, ecfg, noise=noise, device="cpu")
    assert bool(torch.isfinite(out["T_est"]).all())
    xyz = pair.xyz0[0, :int(pair.n0[0])].numpy()
    kw = dict(voxel_size=0.3, caps=caps, window_bits=BITS, device="cpu")
    _, f_got = api.extract_features(model, xyz, **kw)
    _, f_want = api.extract_features(reference, xyz, **kw)
    np.testing.assert_array_equal(f_got, f_want)
    assert model.training
    for name, v in model.state_dict().items():
        assert torch.equal(v, before[name]), name


# ------------------------------------------------- kernels never fall back


class _LoaderDown(RuntimeError):
    pass


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_training_kernel_wrappers_never_fall_back(monkeypatch):
    def fail(name, argtypes, symbol=None):
        raise _LoaderDown(symbol or name)

    monkeypatch.setattr(kernels, "load", fail)
    before = dict(kernels.launches)
    bf = torch.bfloat16
    i32 = torch.int32
    with pytest.raises(_LoaderDown, match="sparse_conv_wgrad"):
        brick_conv.sparse_conv_wgrad(meta(8, 4, dtype=bf), meta(6, 5, dtype=bf),
                                     meta(6, 27, dtype=i32))
    with pytest.raises(_LoaderDown, match="sparse_conv"):
        brick_conv.sparse_conv_dgrad(meta(6, 5, dtype=bf),
                                     meta(27, 5, 4, dtype=bf),
                                     meta(8, 27, dtype=i32))
    with pytest.raises(_LoaderDown, match="^take_rows$"):
        rows.take_rows(meta(8, 32), meta(4, dtype=i32))
    with pytest.raises(_LoaderDown, match="take_rows_backward"):
        rows.take_rows_backward(meta(4, 32), meta(4, dtype=i32), 8)
    with pytest.raises(_LoaderDown, match="masked_channel_sums"):
        norm.masked_channel_sums(meta(8, 4, dtype=bf),
                                 meta(8, dtype=torch.bool))
    with pytest.raises(_LoaderDown, match="masked_norm_apply"):
        norm.masked_norm_apply(meta(8, 8, dtype=bf),
                               meta(8, dtype=torch.bool), meta(1, 16),
                               relu=True)
    with pytest.raises(_LoaderDown, match="masked_norm_backward"):
        norm.masked_norm_backward(meta(8, 8, dtype=bf),
                                  meta(8, dtype=torch.bool), 2, meta(8),
                                  meta(2, 24), meta(8, 8, dtype=bf))
    with pytest.raises(_LoaderDown, match="masked_norm_backward"):
        norm.masked_norm_backward(meta(8, 8, dtype=bf),
                                  meta(8, dtype=torch.bool), 1, meta(8),
                                  meta(1, 24), meta(8, 8, dtype=bf),
                                  counter="masked_norm_backward_bn")
    with pytest.raises(_LoaderDown, match="masked_instance_norm"):
        norm.masked_instance_norm(meta(8, 8, dtype=bf),
                                  meta(8, dtype=torch.bool), 2, meta(8),
                                  meta(8), with_stats=True)
    assert kernels.launches == before
    assert set(kernels.COUNTERS) <= set(kernels.launches)
