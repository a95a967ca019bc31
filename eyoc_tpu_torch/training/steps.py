"""The train steps (counterpart of eyoc_tpu/training/steps.py:
make_base_train_step, _label_one, make_extension_train_step, _jitter,
_metric_loss, _grads, _apply, _wrap_accumulating, :238-513).

`base_train_step` is one step of `make_base_train_step(label_mode)`:
preprocess both sides of the batch, GT positive pairs under the
ground-truth pose ("gt") or the identity ("identity", the EYOC trainer's
base mode), jittered input features, then the student half.

`extension_train_step` is one step of `make_extension_train_step`, the
EYOC step: preprocess, jitter, two forwards of the frozen labeler (a second
ResUNet: train-mode BN with batch statistics, no gradient, its running
statistics left as they are, as JAX discards that state, steps.py:484-496),
`label_pairs` (mutual matching, spatial filter, SC2-PCR, 2 m rediscovery),
then the student half on those labels.

The student half (both steps): a train-mode forward of each side (masked
BN with batch statistics, or the per-cloud instance norm of an IN spec;
the BN running statistics update twice, as JAX chains the first forward's
state into the second, steps.py:291-294), the metric loss of
`cfg.loss_kind` (`_metric_loss`, steps.py:238-270: hardest contrastive,
contrastive, triplet or hardest triplet), the backward, and the
optimizer's update (`optim.make_optimizer`: SGD, Adam or AdamW). Both
steps take every spec that `ResUNet` takes, BN or IN.

`cfg.iter_size > 1` is `_wrap_accumulating` (steps.py:330-375): the step
takes iter_size micro-batches (a list of RawBatches, or one whose fields
have a leading [iter_size] axis), evaluates each at the same parameters,
averages their gradients (loss / iter_size, accumulated), chains the BN
running statistics through them in order, averages their metrics, and
makes one optimizer step.

Random draws: JAX splits one key per step (and one a micro-batch); the
port takes the same draws as explicit tensors (`StepDraws`, a list of them
for micro-batches) so that a test can feed it the JAX step's own numbers,
or draws them from a torch.Generator.

Data parallelism (parallel/ddp.dp_train_step, steps.py's `axis_name`): with
a process group `group`, each rank runs the step on its own pairs, the
student's BatchNorms synchronized over the group (the labeler's only with
`labeler_sync_bn`, steps.py:180-199), and the gradients and the metrics are
averaged over the ranks before the optimizer's step.
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
from eyoc_tpu_torch.parallel.ddp import average_gradients, average_metrics
from eyoc_tpu_torch.ops.matching import (SimilarityTables, compact_matches,
                                         mutual_topk_matches,
                                         spatial_filter_mask)
from eyoc_tpu_torch.registration.sc2pcr import (SC2PCRConfig,
                                                sc2_pcr_batched)
from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.training.loss import (LossDraws, hardest_contrastive_loss,
                                          hardest_triplet_loss,
                                          random_negative_contrastive_loss,
                                          triplet_loss)
from eyoc_tpu_torch.training.pipeline import (RawBatch, flatten_pairs,
                                              gt_positive_pairs,
                                              preprocess_clouds)
from eyoc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The StepConfig fields (steps.py:98-170) that the two steps and the
    trainers read, with JAX's defaults.

    `labeler_sync_bn` synchronizes the labeler's BN statistics over the
    data-parallel ranks (parallel/ddp.py); by default the labeler's
    forwards take each rank's own statistics, as JAX's. `normalize_feature`
    (steps.py:128) reaches every forward of the steps."""

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
    labeler_sync_bn: bool = False
    normalize_feature: bool = True
    # the metric loss (the trainer registry, reference train.py:35-51)
    loss_kind: str = "hardest_contrastive"
    triplet_num_pos: int = 1024
    triplet_num_rand: int = 1024
    # the optimizer (optim.make_optimizer) and the accumulation
    optimizer: str = "SGD"
    adam_betas: tuple = (0.9, 0.999)
    momentum: float = 0.8
    weight_decay: float = 1e-4
    iter_size: int = 1


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


def loss_draws(cfg: TrainConfig, u) -> LossDraws:
    """The uniforms of one call of `cfg.loss_kind`'s loss, `u(n)` each
    (the sizes of _metric_loss, steps.py:238-270: the contrastive loss's
    2 * num_pos negatives, the triplet losses' triplet_num_pos positives
    and triplet_num_rand random triplets)."""
    hn, kind = cfg.num_hn_samples, cfg.loss_kind
    if kind == "hardest_contrastive":
        return LossDraws(u(hn), u(hn), u(cfg.num_pos))
    if kind == "contrastive":
        return LossDraws(u(2 * cfg.num_pos), u(2 * cfg.num_pos), None)
    tp, tr = cfg.triplet_num_pos, cfg.triplet_num_rand
    if kind == "triplet":
        return LossDraws(None, None, u(tp), u(tr), u(tr))
    if kind == "hardest_triplet":
        return LossDraws(u(hn), u(hn), u(tp), u(tr), u(tr))
    raise ValueError(f"unknown loss_kind {kind!r}")


def draw(cfg: TrainConfig, B: int, generator: torch.Generator | None = None,
         device=None, labels: bool = False) -> StepDraws:
    """Fresh draws of one (micro-)batch from `generator` (made on its
    device, moved to `device`); `labels` adds the extension step's
    rediscovery uniforms."""
    def u(*n):
        return torch.rand(n, generator=generator).to(device)

    def g(n):
        return torch.randn(n, generator=generator).to(device)

    n_rows = B * cfg.caps[0]
    jit = ((u(B), g(n_rows), u(B), g(n_rows)) if cfg.use_jitter
           else (None,) * 4)
    loss = loss_draws(cfg, u)
    return StepDraws(*jit, loss, u(B, cfg.caps[0]) if labels else None)


def micro_batches(batch, iter_size: int) -> list:
    """The step's micro-batches: [batch] at iter_size 1; above, a list of
    iter_size RawBatches as given, or a RawBatch whose fields have a
    leading [iter_size] axis (the stacked form JAX takes) split into one."""
    if isinstance(batch, RawBatch):
        if iter_size == 1:
            return [batch]
        if batch.xyz0.dim() != 4 or batch.xyz0.shape[0] != iter_size:
            raise ValueError(f"iter_size {iter_size}: a stacked RawBatch "
                             f"needs xyz0 [{iter_size}, B, P, 3]")
        fields = [torch.as_tensor(x) for x in batch]
        return [RawBatch(*(x[i] for x in fields)) for i in range(iter_size)]
    batch = list(batch)
    if len(batch) != iter_size:
        raise ValueError(f"iter_size {iter_size}: {len(batch)} micro-batches")
    return batch


def _step_draws(draws, cfg: TrainConfig, batches, generator, device,
                labels: bool) -> list:
    """One StepDraws a micro-batch: as given (one StepDraws at iter_size
    1, else a list), or drawn from `generator` in micro-batch order."""
    if draws is None:
        return [draw(cfg, b.xyz0.shape[0], generator, device, labels)
                for b in batches]
    if isinstance(draws, StepDraws):
        draws = [draws]
    if len(draws) != len(batches):
        raise ValueError(f"{len(draws)} draws for {len(batches)} "
                         "micro-batches")
    return list(draws)


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


def _metric_loss(cfg: TrainConfig, f0, m0, f1, m1, pos,
                 loss_draws: LossDraws, xyz0, xyz1):
    """`cfg.loss_kind`'s loss (steps.py:_metric_loss, :238-270) on the
    flat positive pairs `pos` (pos_i, pos_j, valid): (loss, pos term, neg
    term); the triplet kinds' terms are the mean positive and negative
    distances."""
    kind = cfg.loss_kind
    if kind == "hardest_contrastive":
        pos_loss, neg_loss, _ = hardest_contrastive_loss(
            f0, m0, f1, m1, *pos, loss_draws, pos_thresh=cfg.pos_thresh,
            neg_thresh=cfg.neg_thresh, xyz0=xyz0, xyz1=xyz1,
            safe_radius=cfg.hn_safe_radius)
        return pos_loss + cfg.neg_weight * neg_loss, pos_loss, neg_loss
    if kind == "contrastive":
        pos_loss, neg_loss, _ = random_negative_contrastive_loss(
            f0, m0, f1, m1, *pos, loss_draws, neg_thresh=cfg.neg_thresh)
        return pos_loss + cfg.neg_weight * neg_loss, pos_loss, neg_loss
    if kind == "triplet":
        return triplet_loss(f0, m0, f1, m1, *pos, loss_draws,
                            neg_thresh=cfg.neg_thresh)[:3]
    if kind == "hardest_triplet":
        return hardest_triplet_loss(f0, m0, f1, m1, *pos, loss_draws,
                                    neg_thresh=cfg.neg_thresh)[:3]
    raise ValueError(f"unknown loss_kind {kind!r}")


def _student_loss(model, cfg: TrainConfig, vox0, pyr0, vox1, pyr1, in0, in1,
                  pos, loss_draws: LossDraws, stage, group=None):
    """The student half's forward (steps.py:_grads): train-mode forwards of
    both sides (BN over the ranks of `group` when given) and the metric
    loss. Returns (loss, metrics: loss, pos_loss and neg_loss as detached
    0-d tensors)."""
    model.train()
    kw = dict(bn_momentum=cfg.bn_momentum,
              normalize_feature=cfg.normalize_feature, group=group)
    f0 = model(pyr0, in0, **kw)
    f1 = model(pyr1, in1, **kw)
    stage("forward")
    loss, pos_term, neg_term = _metric_loss(
        cfg, f0, pyr0.vox_masks[0], f1, pyr1.vox_masks[0], pos, loss_draws,
        vox0.xyz.reshape(-1, 3), vox1.xyz.reshape(-1, 3))
    stage("loss")
    return loss, {"loss": loss.detach(), "pos_loss": pos_term.detach(),
                  "neg_loss": neg_term.detach()}


def _accumulate(opt: torch.optim.Optimizer, micro, batches, draws,
                stage, group=None) -> dict:
    """`_wrap_accumulating` (steps.py:330-375): `micro(batch, draws)` ->
    (loss, metrics) on each micro-batch in order at the same parameters,
    (loss / n).backward() accumulating the averaged gradients (the BN
    running statistics chain through the forwards), the metrics averaged,
    then one optimizer step; with a process group, the gradients and the
    metrics averaged over its ranks first (steps.py:310-311, :349-351)."""
    n = len(batches)
    opt.zero_grad(set_to_none=True)
    total: dict = {}
    for batch, d in zip(batches, draws):
        loss, metrics = micro(batch, d)
        (loss / n if n > 1 else loss).backward()
        stage("backward")
        for k, v in metrics.items():
            total[k] = total[k] + v if k in total else v
    if n > 1:
        total = {k: v / n for k, v in total.items()}
    if group is not None:
        average_gradients((p for g in opt.param_groups for p in g["params"]),
                          group)
        total = average_metrics(total, group)
    opt.step()
    stage("optimizer")
    return total


def base_train_step(model, opt: torch.optim.Optimizer, batch,
                    cfg: TrainConfig, draws=None,
                    generator: torch.Generator | None = None, device=None,
                    timings: dict | None = None,
                    label_mode: str = "gt", group=None) -> dict:
    """One supervised step on `batch` (a RawBatch, or cfg.iter_size
    micro-batches: see `micro_batches`; moved to `device`), its positive
    pairs the GT pairs under the ground-truth pose (label_mode "gt") or the
    identity ("identity", the EYOC trainer's base mode, steps.py:388-390).

    `model` is a ResUNet on `device` (put in train mode here), `opt` its
    optimizer. `draws`: a StepDraws, or one a micro-batch; None draws them
    from `generator`. Returns the metrics `loss`, `pos_loss`, `neg_loss`,
    `num_pos_found` (averaged over micro-batches) as 0-d tensors on the
    device (no host sync). With a `timings` dict, adds host-clock ms per
    stage (preprocess, gt_pairs, forward, loss, backward, optimizer),
    synchronizing after each. `group`: a process group of data-parallel
    ranks (parallel/ddp.dp_train_step), `batch` this rank's pairs."""
    if label_mode not in ("gt", "identity"):
        raise ValueError(f"unknown label_mode {label_mode!r}")
    device = resolve_device(device)
    stage = _Stages(timings, device)
    batches = [b.to(device) for b in micro_batches(batch, cfg.iter_size)]
    draws = _step_draws(draws, cfg, batches, generator, device, False)
    cap0 = cfg.caps[0]

    def micro(batch, draws):
        B = batch.xyz0.shape[0]
        vox0, pyr0, vox1, pyr1 = _preprocess(batch, cfg)
        stage("preprocess")
        trans = batch.T_gt if label_mode == "gt" else torch.eye(
            4, dtype=batch.T_gt.dtype, device=device).expand(B, 4, 4)
        i0, i1, ok = gt_positive_pairs(vox0, vox1, trans,
                                       batch.search_radius)
        pos = flatten_pairs(i0, i1, ok, cap0, cap0)
        stage("gt_pairs")
        loss, metrics = _student_loss(model, cfg, vox0, pyr0, vox1, pyr1,
                                      *_inputs(cfg, draws, B * cap0), pos,
                                      draws.loss, stage, group)
        metrics["num_pos_found"] = ok.sum().to(torch.float32)
        return loss, metrics

    return _accumulate(opt, micro, batches, draws, stage, group)


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
                         batch, cfg: TrainConfig,
                         similarity: SimilarityTables | None = None,
                         draws=None,
                         generator: torch.Generator | None = None,
                         device=None, timings: dict | None = None,
                         group=None) -> dict:
    """One EYOC extension step on `batch` (steps.py:470-513; a RawBatch, or
    cfg.iter_size micro-batches as `base_train_step` takes them).

    `model` is the student ResUNet and `opt` its optimizer; `labeler` a
    ResUNet of the same spec (synced by `optim.sync_labeler` between
    epochs), put in train mode here and run without gradient and without
    touching its BN statistics. `similarity`: the tables that
    spatial_filter "Similarity" reads. Returns the base step's metrics
    plus `labeler_hit_ratio`, 0-d tensors on the device. With a `timings`
    dict, adds host-clock ms per stage (preprocess, labeler_forward,
    matching, filter, sc2pcr, rediscovery, forward, loss, backward,
    optimizer), synchronizing after each. `group`: as `base_train_step`'s;
    the labeler's BN takes it only with `cfg.labeler_sync_bn`."""
    device = resolve_device(device)
    stage = _Stages(timings, device)
    batches = [b.to(device) for b in micro_batches(batch, cfg.iter_size)]
    draws = _step_draws(draws, cfg, batches, generator, device, True)
    cap0 = cfg.caps[0]

    def micro(batch, draws):
        B = batch.xyz0.shape[0]
        vox0, pyr0, vox1, pyr1 = _preprocess(batch, cfg)
        stage("preprocess")
        in0, in1 = _inputs(cfg, draws, B * cap0)
        labeler.train()
        kw = dict(bn_momentum=None, normalize_feature=cfg.normalize_feature,
                  group=group if cfg.labeler_sync_bn else None)
        with torch.no_grad():
            F0L = labeler(pyr0, in0, **kw).reshape(B, cap0, -1)
            F1L = labeler(pyr1, in1, **kw).reshape(B, cap0, -1)
        stage("labeler_forward")
        lab = label_pairs(cfg, F0L, vox0.mask, vox0.xyz, F1L, vox1.mask,
                          vox1.xyz, batch.frame_distance, batch.T_gt,
                          draws.rediscovery, similarity, stage)
        pos = flatten_pairs(lab.pos_i, lab.pos_j, lab.ok, cap0, cap0)
        loss, metrics = _student_loss(model, cfg, vox0, pyr0, vox1, pyr1,
                                      in0, in1, pos, draws.loss, stage,
                                      group)
        metrics["labeler_hit_ratio"] = lab.labeler_hit.mean()
        metrics["num_pos_found"] = lab.ok.sum().to(torch.float32)
        return loss, metrics

    return _accumulate(opt, micro, batches, draws, stage, group)
