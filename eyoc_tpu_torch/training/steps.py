"""The supervised train step (counterpart of eyoc_tpu/training/steps.py:
make_base_train_step, _jitter, _grads, _apply, :272-404).

One call of `base_train_step` is one step of `make_base_train_step("gt")`
with iter_size 1: preprocess both sides of the batch, GT positive pairs,
jittered input features, a train-mode forward of
each side (masked BN with batch statistics; the running statistics update
twice, as JAX chains the first forward's state into the second,
steps.py:291-294), the hardest-contrastive loss, the backward, and the
optimizer's update (SGD with momentum and weight decay, `optim.sgd`).

Random draws: JAX splits one key per step; the port takes the same draws
as explicit tensors (`StepDraws`) so that a test can feed it the JAX
step's own numbers, or draws them from a torch.Generator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.training.loss import LossDraws, hardest_contrastive_loss
from eyoc_tpu_torch.training.pipeline import (RawBatch, flatten_pairs,
                                              gt_positive_pairs,
                                              preprocess_clouds)
from eyoc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The StepConfig fields (steps.py:98-170) that the base step reads."""

    caps: tuple
    voxel_size: float = 0.3
    bn_momentum: float = 0.05
    num_pos: int = 8192
    num_hn_samples: int = 2048
    pos_thresh: float = 0.1
    neg_thresh: float = 1.4
    neg_weight: float = 1.0
    hn_safe_radius: float = 0.0
    use_jitter: bool = True
    jitter_sigma: float = 0.01
    window_bits: tuple = morton.BITS


class StepDraws(NamedTuple):
    """Every random number of one step: per side, the jitter's per-item
    uniforms [B] and per-row standard normals [B * cap0] (steps.py:279-283),
    and the loss's uniforms (loss.py:81-90). jitter fields are None when
    jitter is off."""

    jitter_item0: Optional[torch.Tensor]
    jitter_noise0: Optional[torch.Tensor]
    jitter_item1: Optional[torch.Tensor]
    jitter_noise1: Optional[torch.Tensor]
    loss: LossDraws


def draw(cfg: TrainConfig, B: int, generator: torch.Generator | None = None,
         device=None) -> StepDraws:
    """Fresh draws from `generator` (made on its device, moved to
    `device`)."""
    def u(n):
        return torch.rand(n, generator=generator).to(device)

    def g(n):
        return torch.randn(n, generator=generator).to(device)

    n_rows = B * cfg.caps[0]
    jit = ((u(B), g(n_rows), u(B), g(n_rows)) if cfg.use_jitter
           else (None,) * 4)
    return StepDraws(*jit, LossDraws(u(cfg.num_hn_samples),
                                     u(cfg.num_hn_samples), u(cfg.num_pos)))


def jitter(cfg: TrainConfig, item_u, noise, n_rows: int):
    """[n_rows, 1] input features 1 + sigma * noise on items whose uniform
    is < 0.95 (the reference's Jitter, p = 0.95 per item), or None."""
    if not cfg.use_jitter:
        return None
    apply_item = item_u < 0.95
    per_row = torch.repeat_interleave(apply_item, n_rows // item_u.shape[0])
    return 1.0 + (cfg.jitter_sigma * noise)[:, None] * per_row[:, None]


class _Stages:
    """Host-clock ms per stage, each ending in a device synchronize; a
    no-op without a `timings` dict."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter() if timings is not None else 0.0

    def __call__(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + (t - self.t) * 1e3
        self.t = t


def base_train_step(model, opt: torch.optim.Optimizer, batch: RawBatch,
                    cfg: TrainConfig, draws: StepDraws | None = None,
                    generator: torch.Generator | None = None, device=None,
                    timings: dict | None = None) -> dict:
    """One supervised step on `batch` (a RawBatch, moved to `device`).

    `model` is a ResUNet on `device` (put in train mode here), `opt` its
    optimizer. Returns the metrics `loss`, `pos_loss`, `neg_loss`,
    `num_pos_found` as 0-d tensors on the device (no host sync). With a
    `timings` dict, adds host-clock ms per stage (preprocess, gt_pairs,
    forward, loss, backward, optimizer), synchronizing after each."""
    device = resolve_device(device)
    stage = _Stages(timings, device)
    batch = batch.to(device)
    B = batch.xyz0.shape[0]
    cap0 = cfg.caps[0]
    if draws is None:
        draws = draw(cfg, B, generator, device)

    vox0, pyr0 = preprocess_clouds(batch.xyz0, batch.n0, caps=cfg.caps,
                                   voxel_size=cfg.voxel_size,
                                   window_bits=cfg.window_bits)
    vox1, pyr1 = preprocess_clouds(batch.xyz1, batch.n1, caps=cfg.caps,
                                   voxel_size=cfg.voxel_size,
                                   window_bits=cfg.window_bits)
    stage("preprocess")
    i0, i1, ok = gt_positive_pairs(vox0, vox1, batch.T_gt,
                                   batch.search_radius)
    pos_i, pos_j, pos_valid = flatten_pairs(i0, i1, ok, cap0, cap0)
    stage("gt_pairs")

    n_rows = B * cap0
    in0 = jitter(cfg, draws.jitter_item0, draws.jitter_noise0, n_rows)
    in1 = jitter(cfg, draws.jitter_item1, draws.jitter_noise1, n_rows)
    model.train()
    opt.zero_grad(set_to_none=True)
    f0 = model(pyr0, in0, bn_momentum=cfg.bn_momentum)
    f1 = model(pyr1, in1, bn_momentum=cfg.bn_momentum)
    stage("forward")
    pos_loss, neg_loss, _ = hardest_contrastive_loss(
        f0, pyr0.vox_masks[0], f1, pyr1.vox_masks[0], pos_i, pos_j,
        pos_valid, draws.loss, pos_thresh=cfg.pos_thresh,
        neg_thresh=cfg.neg_thresh, xyz0=vox0.xyz.reshape(-1, 3),
        xyz1=vox1.xyz.reshape(-1, 3), safe_radius=cfg.hn_safe_radius)
    loss = pos_loss + cfg.neg_weight * neg_loss
    stage("loss")
    loss.backward()
    stage("backward")
    opt.step()
    stage("optimizer")
    return {"loss": loss.detach(), "pos_loss": pos_loss.detach(),
            "neg_loss": neg_loss.detach(),
            "num_pos_found": ok.sum().to(torch.float32)}
