"""`normalize_feature=False` (eyoc_tpu/models/unet.py:378, StepConfig
.normalize_feature, steps.py:128) through the port's train step and the
trainer's step configuration, against the JAX package on the CPU.

- One base_train_step of a narrow block-free two-level BN spec with
  TrainConfig(normalize_feature=False) against make_base_train_step("gt")
  with StepConfig(normalize_feature=False), on the JAX step's own draws:
  loss, pos / neg loss (rtol 1e-4), num_pos_found (exact), every parameter
  and BN running statistic after the step (rtol 1e-4, atol 1e-5); the
  student's features are not unit-norm.
- build_step_config carries --normalize_feature false into the steps'
  TrainConfig, and the trainer's models take it.
(The eval forward's raw features are held in tests/test_torch_expbn2c.py.)
"""

import jax
import numpy as np
import torch

from eyoc_tpu.models.unet import UNetSpec as JSpec
from eyoc_tpu.models.unet import init_unet as jinit
from eyoc_tpu.training.steps import StepBuilder, StepConfig, init_train_state
from eyoc_tpu_torch import config as tconfig
from eyoc_tpu_torch.models import ResUNet, UNetSpec
from eyoc_tpu_torch.models.convert import params_from_jax
from eyoc_tpu_torch.training import trainer as ttrainer
from eyoc_tpu_torch.training.optim import sgd
from eyoc_tpu_torch.training.pipeline import preprocess_clouds
from eyoc_tpu_torch.training.steps import TrainConfig, base_train_step
from test_torch_train_step import (BITS, NUM_HN, NUM_POS, _f32_convs,  # noqa
                                   _one_torch_thread, assert_state_close,
                                   jax_step_draws, np_tree, raw_batch)
from test_torch_trainer import base_config

JS = JSpec("narrow", "BN", None, (8, 16), (8, 16))
CAPS = (1024, 512)


def test_base_train_step_unnormalized_matches_jax():
    params, bn = jax.jit(lambda k: jinit(JS, k, 1, 16, 5))(
        jax.random.PRNGKey(0))
    state = init_train_state(params, bn, jax.random.PRNGKey(1))
    step = StepBuilder(StepConfig(
        spec=JS, caps=CAPS, voxel_size=0.3, conv1_kernel_size=5,
        num_pos=NUM_POS, num_hn_samples=NUM_HN, window_bits=BITS,
        normalize_feature=False)).make_base_train_step("gt")
    jbatch, tbatch = raw_batch(5)
    model = ResUNet(UNetSpec(**vars(JS)), 1, 16, 5, dtype=torch.float32)
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(bn)))
    opt = sgd(model.parameters(), lr=0.1)
    cfg = TrainConfig(caps=CAPS, num_pos=NUM_POS, num_hn_samples=NUM_HN,
                      window_bits=BITS, normalize_feature=False)
    key, draws = jax_step_draws(state.key, 2, 2 * CAPS[0])
    state, jm = step(state, jbatch, 0.1)
    tm = base_train_step(model, opt, tbatch, cfg, draws=draws, device="cpu")
    assert float(tm["num_pos_found"]) == float(jm["num_pos_found"]) > 300
    for k in ("loss", "pos_loss", "neg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert_state_close(model, state.params, state.bn_state, 1e-4, 1e-5)
    _, pyr = preprocess_clouds(tbatch.xyz0, tbatch.n0, caps=CAPS,
                               voxel_size=0.3, window_bits=BITS)
    with torch.no_grad():
        f = model(pyr, normalize_feature=False)
    norms = f[pyr.vox_masks[0]].norm(dim=1)
    assert float((norms - 1).abs().max()) > 0.1


def test_step_config_and_models_take_the_flag(tmp_path):
    cfg = base_config(tconfig, str(tmp_path), normalize_feature=False)
    t = ttrainer.HardestContrastiveLossTrainer(cfg, None, None, device="cpu")
    assert t.step_cfg.normalize_feature is False
    assert t.model.normalize_feature is False
    cfg = base_config(tconfig, str(tmp_path))
    t = ttrainer.HardestContrastiveLossTrainer(cfg, None, None, device="cpu")
    assert t.step_cfg.normalize_feature and t.model.normalize_feature
