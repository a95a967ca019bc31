"""The train steps (counterpart of eyoc_tpu/training/steps.py:
make_base_train_step, _label_one, make_extension_train_step, _jitter,
_grads, _apply, :272-513).

`base_train_step` is one step of `make_base_train_step(label_mode)` with
iter_size 1: preprocess both sides of the batch, GT positive pairs under
the ground-truth pose ("gt") or the identity ("identity", the EYOC
trainer's base mode), jittered input features, then the student half.

`extension_train_step` is one step of `make_extension_train_step`, the
EYOC step: preprocess, jitter, two forwards of the frozen labeler (a second
ResUNet: train-mode BN with batch statistics, no gradient, its running
statistics left as they are, as JAX discards that state, steps.py:484-496),
`label_pairs` (mutual matching, spatial filter, SC2-PCR, 2 m rediscovery),
then the student half on those labels.

The student half (`_student_update`, both steps): a train-mode forward of
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

from eyoc_tpu_torch.eval import random_subset
from eyoc_tpu_torch.geometry.metrics import hit_ratio
from eyoc_tpu_torch.geometry.se3 import transform_points
from eyoc_tpu_torch.ops.knn import masked_argmin_batched
from eyoc_tpu_torch.ops.matching import (SimilarityTables, compact_matches,
                                         mutual_topk_matches,
                                         spatial_filter_mask)
from eyoc_tpu_torch.registration.sc2pcr import (SC2PCRConfig,
                                                sc2_pcr_batched)
from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.training.loss import LossDraws, hardest_contrastive_loss
from eyoc_tpu_torch.training.pipeline import (RawBatch, flatten_pairs,
                                              gt_positive_pairs,
                                              preprocess_clouds)
from eyoc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The StepConfig fields (steps.py:98-170) that the two steps read,
    with JAX's defaults."""

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
    # labeling (the extension step)
    num_corres: int = 5000
    feature_filter: str = "Lowe"
    spatial_filter: str = "Spherical"
    filter_radius: float = 20.0
    similarity_thresh: float = 0.4
    use_sc2_filtering: bool = True
    sc2: SC2PCRConfig = SC2PCRConfig()
    rediscovery_samples: int = 5000
    rediscovery_radius: float = 2.0
    hit_ratio_thresh: float = 0.1
    label_min_translation_frac: float = 0.0


class StepDraws(NamedTuple):
    """Every random number of one step: per side, the jitter's per-item
    uniforms [B] and per-row standard normals [B * cap0] (steps.py:279-283),
    the loss's uniforms (loss.py:81-90) and, for the extension step, each
    pair's rediscovery uniforms [B, cap0] (steps.py:440). jitter fields are
    None when jitter is off."""

    jitter_item0: Optional[torch.Tensor]
    jitter_noise0: Optional[torch.Tensor]
    jitter_item1: Optional[torch.Tensor]
    jitter_noise1: Optional[torch.Tensor]
    loss: LossDraws
    rediscovery: Optional[torch.Tensor] = None


def draw(cfg: TrainConfig, B: int, generator: torch.Generator | None = None,
         device=None, labels: bool = False) -> StepDraws:
    """Fresh draws from `generator` (made on its device, moved to
    `device`); `labels` adds the extension step's rediscovery uniforms."""
    def u(*n):
        return torch.rand(n, generator=generator).to(device)

    def g(n):
        return torch.randn(n, generator=generator).to(device)

    n_rows = B * cfg.caps[0]
    jit = ((u(B), g(n_rows), u(B), g(n_rows)) if cfg.use_jitter
           else (None,) * 4)
    loss = LossDraws(u(cfg.num_hn_samples), u(cfg.num_hn_samples),
                     u(cfg.num_pos))
    return StepDraws(*jit, loss, u(B, cfg.caps[0]) if labels else None)


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


def _preprocess(batch: RawBatch, cfg: TrainConfig):
    """(vox0, pyr0, vox1, pyr1) of both sides of the batch."""
    kw = dict(caps=cfg.caps, voxel_size=cfg.voxel_size,
              window_bits=cfg.window_bits)
    return (*preprocess_clouds(batch.xyz0, batch.n0, **kw),
            *preprocess_clouds(batch.xyz1, batch.n1, **kw))


def _inputs(cfg: TrainConfig, draws: StepDraws, n_rows: int):
    """Both sides' jittered input features (or None, None)."""
    return (jitter(cfg, draws.jitter_item0, draws.jitter_noise0, n_rows),
            jitter(cfg, draws.jitter_item1, draws.jitter_noise1, n_rows))


def _student_update(model, opt, cfg: TrainConfig, vox0, pyr0, vox1, pyr1,
                    in0, in1, pos, loss_draws: LossDraws, stage) -> dict:
    """The student half of both steps (steps.py:_grads, _apply): train-mode
    forwards of both sides, the loss on the flat positive pairs `pos`
    (pos_i, pos_j, valid), the backward and the optimizer step. Returns
    loss, pos_loss and neg_loss as detached 0-d tensors."""
    model.train()
    opt.zero_grad(set_to_none=True)
    f0 = model(pyr0, in0, bn_momentum=cfg.bn_momentum)
    f1 = model(pyr1, in1, bn_momentum=cfg.bn_momentum)
    stage("forward")
    pos_loss, neg_loss, _ = hardest_contrastive_loss(
        f0, pyr0.vox_masks[0], f1, pyr1.vox_masks[0], *pos, loss_draws,
        pos_thresh=cfg.pos_thresh, neg_thresh=cfg.neg_thresh,
        xyz0=vox0.xyz.reshape(-1, 3), xyz1=vox1.xyz.reshape(-1, 3),
        safe_radius=cfg.hn_safe_radius)
    loss = pos_loss + cfg.neg_weight * neg_loss
    stage("loss")
    loss.backward()
    stage("backward")
    opt.step()
    stage("optimizer")
    return {"loss": loss.detach(), "pos_loss": pos_loss.detach(),
            "neg_loss": neg_loss.detach()}


def base_train_step(model, opt: torch.optim.Optimizer, batch: RawBatch,
                    cfg: TrainConfig, draws: StepDraws | None = None,
                    generator: torch.Generator | None = None, device=None,
                    timings: dict | None = None,
                    label_mode: str = "gt") -> dict:
    """One supervised step on `batch` (a RawBatch, moved to `device`), its
    positive pairs the GT pairs under the ground-truth pose (label_mode
    "gt") or the identity ("identity", the EYOC trainer's base mode,
    steps.py:388-390).

    `model` is a ResUNet on `device` (put in train mode here), `opt` its
    optimizer. Returns the metrics `loss`, `pos_loss`, `neg_loss`,
    `num_pos_found` as 0-d tensors on the device (no host sync). With a
    `timings` dict, adds host-clock ms per stage (preprocess, gt_pairs,
    forward, loss, backward, optimizer), synchronizing after each."""
    if label_mode not in ("gt", "identity"):
        raise ValueError(f"unknown label_mode {label_mode!r}")
    device = resolve_device(device)
    stage = _Stages(timings, device)
    batch = batch.to(device)
    B = batch.xyz0.shape[0]
    cap0 = cfg.caps[0]
    if draws is None:
        draws = draw(cfg, B, generator, device)

    vox0, pyr0, vox1, pyr1 = _preprocess(batch, cfg)
    stage("preprocess")
    trans = batch.T_gt if label_mode == "gt" else torch.eye(
        4, dtype=batch.T_gt.dtype, device=device).expand(B, 4, 4)
    i0, i1, ok = gt_positive_pairs(vox0, vox1, trans, batch.search_radius)
    pos = flatten_pairs(i0, i1, ok, cap0, cap0)
    stage("gt_pairs")
    metrics = _student_update(model, opt, cfg, vox0, pyr0, vox1, pyr1,
                              *_inputs(cfg, draws, B * cap0), pos,
                              draws.loss, stage)
    metrics["num_pos_found"] = ok.sum().to(torch.float32)
    return metrics


class Labels(NamedTuple):
    """The pseudo-labels of a batch of B pairs (steps.py:_label_one)."""

    pos_i: torch.Tensor        # [B, S] int32 rows of cloud 0
    pos_j: torch.Tensor        # [B, S] int32 rows of cloud 1
    ok: torch.Tensor           # [B, S] bool
    labeler_hit: torch.Tensor  # [B] f32 hit ratio of the filtered matches
    T_est: torch.Tensor        # [B, 4, 4] SC2-PCR pose (identity without)


def _rows(x, idx):
    """x [B, N, 3] rows idx [B, M] -> [B, M, 3]."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, 3))


def _no_stage(name: str) -> None:
    pass


def label_pairs(cfg: TrainConfig, F0, m0, x0, F1, m1, x1, frame_distance,
                T_gt, noise, similarity: SimilarityTables | None = None,
                stage=_no_stage) -> Labels:
    """`_label_one` (steps.py:408-468) for each of B pairs, from the frozen
    labeler's features F* [B, cap, C], voxel masks m* [B, cap] and
    coordinates x* [B, cap, 3], frame_distance [B], T_gt [B, 4, 4] (for
    the hit ratio only) and the rediscovery uniforms noise [B, cap].

    Mutual top-k matching (both directions of every pair in one K2 or K8
    launch), the spatial filter, the hit ratio of the kept matches under
    T_gt; without SC2 filtering, the unfiltered matches and the identity
    pose (:428-432). Otherwise the kept matches compacted to
    sc2.max_points, SC2-PCR on the B pairs in one batched call (no host
    sync), then the rediscovery: a random subset of cloud 0 warped by the
    estimated pose, its 1-NN in cloud 1
    (one batched K2 launch for the B pairs), kept within
    rediscovery_radius when the pair has >= 10 kept matches and a positive
    fitness (and, with label_min_translation_frac > 0, a translation of at
    least that fraction of the frame distance). `stage(name)` is called
    after matching, filter, sc2pcr and rediscovery."""
    B, cap = m0.shape
    idx0, idx1, _, valid = mutual_topk_matches(
        F0, m0, F1, m1, num_corres=cfg.num_corres,
        feature_filter=cfg.feature_filter)
    stage("matching")
    c0, c1 = _rows(x0, idx0), _rows(x1, idx1)
    if similarity is not None:
        similarity = similarity.to(x0.device)
    valid_f = valid & spatial_filter_mask(
        c0, c1, spatial_filter=cfg.spatial_filter, radius=cfg.filter_radius,
        similarity=similarity, similarity_thresh=cfg.similarity_thresh,
        frame_distance=frame_distance)
    hit = hit_ratio(c0, c1, T_gt, cfg.hit_ratio_thresh, mask=valid_f)
    if not cfg.use_sc2_filtering:
        stage("filter")
        eye = torch.eye(4, dtype=x0.dtype, device=x0.device)
        return Labels(idx0, idx1, valid, hit, eye.expand(B, 4, 4))
    ci0, ci1, cv = compact_matches(idx0, idx1, valid_f, cfg.sc2.max_points)
    src, tgt = _rows(x0, ci0), _rows(x1, ci1)
    stage("filter")
    T_est, fitness = sc2_pcr_batched(src, tgt, cv, cfg.sc2)
    fit_max = fitness.max(-1).values
    stage("sc2pcr")
    sel = random_subset(torch.where(m0, noise, torch.full_like(noise, 2.0)),
                        cfg.rediscovery_samples)
    sel_ok = torch.gather(m0, 1, sel)
    warped = transform_points(_rows(x0, sel), T_est).contiguous()
    d2, nn = masked_argmin_batched(warped, sel_ok, x1.contiguous(), m1)
    ok_item = (cv.sum(1) >= 10) & (fit_max > 0)
    if cfg.label_min_translation_frac > 0.0:
        t = T_est[:, :3, 3]
        t_norm = torch.sqrt(torch.sum(t * t, -1))
        ok_item &= t_norm >= (cfg.label_min_translation_frac
                              * frame_distance.to(torch.float32))
    ok = sel_ok & (d2 < cfg.rediscovery_radius ** 2) & ok_item[:, None]
    stage("rediscovery")
    return Labels(sel.to(torch.int32), nn, ok, hit, T_est)


def extension_train_step(model, labeler, opt: torch.optim.Optimizer,
                         batch: RawBatch, cfg: TrainConfig,
                         similarity: SimilarityTables | None = None,
                         draws: StepDraws | None = None,
                         generator: torch.Generator | None = None,
                         device=None, timings: dict | None = None) -> dict:
    """One EYOC extension step on `batch` (steps.py:470-513, iter_size 1).

    `model` is the student ResUNet and `opt` its optimizer; `labeler` a
    ResUNet of the same spec (synced by `optim.sync_labeler` between
    steps), put in train mode here and run without gradient and without
    touching its BN statistics. `similarity`: the tables that
    spatial_filter "Similarity" reads. Returns the base step's metrics
    plus `labeler_hit_ratio`, 0-d tensors on the device. With a `timings`
    dict, adds host-clock ms per stage (preprocess, labeler_forward,
    matching, filter, sc2pcr, rediscovery, forward, loss, backward,
    optimizer), synchronizing after each."""
    device = resolve_device(device)
    stage = _Stages(timings, device)
    batch = batch.to(device)
    B = batch.xyz0.shape[0]
    cap0 = cfg.caps[0]
    if draws is None:
        draws = draw(cfg, B, generator, device, labels=True)

    vox0, pyr0, vox1, pyr1 = _preprocess(batch, cfg)
    stage("preprocess")
    in0, in1 = _inputs(cfg, draws, B * cap0)
    labeler.train()
    with torch.no_grad():
        F0L = labeler(pyr0, in0, bn_momentum=None).reshape(B, cap0, -1)
        F1L = labeler(pyr1, in1, bn_momentum=None).reshape(B, cap0, -1)
    stage("labeler_forward")
    lab = label_pairs(cfg, F0L, vox0.mask, vox0.xyz, F1L, vox1.mask,
                      vox1.xyz, batch.frame_distance, batch.T_gt,
                      draws.rediscovery, similarity, stage)
    pos = flatten_pairs(lab.pos_i, lab.pos_j, lab.ok, cap0, cap0)
    metrics = _student_update(model, opt, cfg, vox0, pyr0, vox1, pyr1, in0,
                              in1, pos, draws.loss, stage)
    metrics["labeler_hit_ratio"] = lab.labeler_hit.mean()
    metrics["num_pos_found"] = lab.ok.sum().to(torch.float32)
    return metrics
