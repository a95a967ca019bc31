"""The data-parallel train step (parallel/ddp.dp_train_step) at world size
2 over gloo on the CPU, against eyoc_tpu's make_dp_train_step on 2 of
conftest's virtual CPU devices (shard_map over `dp`: sync-BN, grads and
metrics pmean'd), JAX convs in f32.

A batch of B = 2 pairs, one a rank; a narrow block-free two-level BN spec
(its JAX step compiles in ~15 s). JAX's key is replicated over `dp`, so
each device draws the numbers a one-pair step draws from the same key:
both ranks get those draws (the port's replicated draws). Compared after
one SGD step: the averaged loss, pos / neg loss (rtol 1e-4) and
num_pos_found (exact), every parameter and BN running statistic (rtol
1e-4, atol 1e-5) on each rank, and the two ranks' states bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.parallel.mesh import make_dp_train_step, make_mesh
from eyoc_tpu.training.steps import StepBuilder, StepConfig, init_train_state
from eyoc_tpu_torch.models.convert import params_from_jax
from ddp_worker import run_ranks
from test_torch_train_step import (BITS, NUM_HN, NUM_POS, _f32_convs,  # noqa
                                   _one_torch_thread, jax_step_draws,
                                   np_tree, raw_batch)

JS = JSpec("narrow", "BN", None, (8, 16), (8, 16))
CAPS = (1024, 512)


def test_dp_train_step_matches_make_dp_train_step(tmp_path):
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    # a nonzero final bias: JAX's grad is NaN at a valid voxel whose
    # feature is exactly zero
    params["final"]["b"] = jnp.asarray(np.random.default_rng(4).normal(
        0, 0.1, 16).astype(np.float32))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    builder = StepBuilder(StepConfig(
        spec=JS, caps=CAPS, voxel_size=0.3, conv1_kernel_size=5,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
        axis_name="dp"))
    step = make_dp_train_step(builder, make_mesh(2), kind="base",
                              label_mode="gt")
    jbatch, tbatch = raw_batch(5)
    # each device's draws: a one-pair step's from the replicated key
    _, draws = jax_step_draws(state.key, 1, CAPS[0])
    init = params_from_jax(np_tree(params), np_tree(bn))
    new_state, jm = step(state, jbatch, 0.1)

    outs = run_ranks("train_step", dict(
        spec=dataclasses.asdict(JS), n_out=16, k1=5, state=init,
        batch=tuple(tbatch), draws=draws, lr=0.1,
        cfg=dict(caps=CAPS, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                 window_bits=BITS)), tmp_path)
    want = params_from_jax(np_tree(new_state.params),
                           np_tree(new_state.bn_state))
    for out in outs:
        m = out["metrics"]
        assert float(m["num_pos_found"]) == float(jm["num_pos_found"]) > 150
        for k in ("loss", "pos_loss", "neg_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert set(out["state"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(out["state"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in outs[0]["state"].items():
        assert torch.equal(v, outs[1]["state"][k]), k
    # the step moved the parameters
    assert not torch.equal(outs[0]["state"]["conv1.weight"],
                           init["conv1.weight"])
