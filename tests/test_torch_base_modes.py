"""The base step's other modes against the JAX package, on the CPU, on
test_torch_train_step's narrow two-level BN ResUNet and batch, on the JAX
step's own draws, compared as that file compares label mode "gt" (loss
terms rtol 1e-4, num_pos_found exact, the state after the steps rtol
1e-4, atol 1e-5):

(a) one step with round 5's hn_safe_radius 1.5 m: the mining runs through
    K9's plain version (`masked_argmin_excl_plain`);
(b) two steps of `base_train_step(label_mode="identity")` against
    `make_base_train_step("identity")` (GT pairs under the identity pose,
    the EYOC trainer's base mode, trainer.py:389-391)."""

import jax
import numpy as np
import torch
from test_torch_extension_step import CAPS, SPEC
from test_torch_train_step import _f32_convs  # noqa: F401 (JAX convs in f32)
from test_torch_train_step import (BITS, NUM_HN, NUM_POS, assert_state_close,
                                   jax_step_draws, np_tree, raw_batch)

from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.training.steps import StepBuilder, StepConfig, init_train_state
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training.optim import sgd
from eyoc_tpu_torch.training.steps import TrainConfig, base_train_step


def student(params, bn):
    model = ResUNet(UNetSpec(**vars(SPEC)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    return model


def test_safe_radius_step_matches_jax():
    """hardest_contrastive_loss with safe_radius 1.5 m inside a whole step:
    the mining goes through K9's plain version."""
    params, bn = jax.jit(lambda k: jinit(SPEC, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    step = StepBuilder(StepConfig(
        spec=SPEC, caps=CAPS, voxel_size=0.3, conv1_kernel_size=5,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
        hn_safe_radius=1.5)).make_base_train_step("gt")
    jbatch, tbatch = raw_batch(5)
    model = student(params, bn)
    cfg = TrainConfig(caps=CAPS, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS, hn_safe_radius=1.5)
    _, draws = jax_step_draws(state.key, 2, 2 * CAPS[0])
    state, jm = step(state, jbatch, 0.1)
    tm = base_train_step(model, sgd(model.parameters(), lr=0.1), tbatch,
                         cfg, draws=draws, device="cpu")
    assert float(tm["num_pos_found"]) == float(jm["num_pos_found"]) > 300
    for k in ("loss", "pos_loss", "neg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert_state_close(model, state.params, state.bn_state, 1e-4, 1e-5)


def test_identity_base_steps_match_jax():
    params, bn = jax.jit(lambda k: jinit(SPEC, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    step = StepBuilder(StepConfig(
        spec=SPEC, caps=CAPS, voxel_size=0.3, conv1_kernel_size=5,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
    )).make_base_train_step("identity")
    jbatch, tbatch = raw_batch(7)
    model = student(params, bn)
    opt = sgd(model.parameters(), lr=0.1)
    cfg = TrainConfig(caps=CAPS, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS)
    key = state.key
    for _ in range(2):
        key, draws = jax_step_draws(key, 2, 2 * CAPS[0])
        state, jm = step(state, jbatch, 0.1)
        tm = base_train_step(model, opt, tbatch, cfg, draws=draws,
                             device="cpu", label_mode="identity")
        assert float(tm["num_pos_found"]) == float(jm["num_pos_found"]) > 0
        for k in ("loss", "pos_loss", "neg_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    assert_state_close(model, state.params, state.bn_state, 1e-4, 1e-5)
