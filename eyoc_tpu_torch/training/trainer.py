"""Trainers: the seven-class registry (counterpart of
eyoc_tpu/training/trainer.py; reference train.py:35-51):
- ContrastiveLossTrainer          random-negative contrastive
- TripletLossTrainer              random triplets
- HardestTripletLossTrainer       hardest + random triplets
- HardestContrastiveLossTrainer   FCGF hardest-contrastive (base mode)
- CorrespondenceExtensionTrainer  discrete-stage EYOC (frozen labeler from disk)
- ContinuousCorrExtensionTrainer  EYOC (progressive extension, self-labeler)
- ContinuousHardestContrastiveTrainer  FCGF+C (supervised + extension)

The epoch loop, the checkpoint policy (best on feat_match_ratio), the ExpLR
schedule, the EMA / Sync labeler sync and the extension schedule are the
JAX trainers' (reference lib/trainer.py:127-164, 1475-1516); the device
work runs through `training.steps` (base_train_step, extension_train_step)
and the valid step `eval.valid_pair`.

The student and the labeler are two ResUNets on the trainer's device (the
CUDA device unless the caller passes one); the steps' random numbers come
from one torch.Generator seeded seed + 1 (JAX's TrainState key), which the
checkpoint saves. One device only: `--dp_devices` above 1 and
`--multihost` raise (data parallelism is ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import copy
import functools
import logging
import os

import numpy as np
import torch

from eyoc_tpu_torch.config import (Config, level_capacities, merge_sc2pcr,
                                   window_bits_of)
from eyoc_tpu_torch.data.loader import DataLoader
from eyoc_tpu_torch.eval import EvalConfig, valid_pair
from eyoc_tpu_torch.models import init_unet, load_model
from eyoc_tpu_torch.ops.matching import load_similarity_tables
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
from eyoc_tpu_torch.training import checkpoint as ckpt
from eyoc_tpu_torch.training.optim import (OPTIMIZERS, exp_lr, make_optimizer,
                                           set_lr, sync_labeler)
from eyoc_tpu_torch.training.steps import (TrainConfig, base_train_step,
                                           extension_train_step)
from eyoc_tpu_torch.utils.device import resolve_device
from eyoc_tpu_torch.utils.timer import AverageMeter, ScalarWriter, Timer


def build_step_config(config: Config, spec, *,
                      loss_kind: str = "hardest_contrastive"):
    """The static configuration of the steps from the flags
    (trainer.py:45-98): (TrainConfig of both train steps, EvalConfig of
    the valid step). Per-batch counts scale with the batch size, as the
    reference does (lib/trainer.py:1658-1663)."""
    caps = level_capacities(config, spec.num_levels)
    merged = merge_sc2pcr(config) if config.use_SC2_PCR else config
    sc2 = SC2PCRConfig(
        d_thre=merged.get("d_thre", 0.1),
        num_iterations=merged.get("num_iterations", 20),
        ratio=merged.get("ratio", 0.2),
        nms_radius=merged.get("nms_radius", 0.6),
        max_points=merged.get("max_points", 8000),
        k1=merged.get("k1", 30),
        k2=merged.get("k2", 20),
        inlier_threshold=merged.get("inlier_threshold", 0.6),
    )
    window_bits = window_bits_of(config)
    train = TrainConfig(
        caps=caps,
        voxel_size=config.voxel_size,
        bn_momentum=config.bn_momentum,
        num_pos=config.num_pos_per_batch * config.batch_size,
        num_hn_samples=config.num_hn_samples_per_batch * config.batch_size,
        pos_thresh=config.pos_thresh,
        neg_thresh=config.neg_thresh,
        neg_weight=config.neg_weight,
        hn_safe_radius=float(config.get("hn_safe_radius", 0.0)),
        use_jitter=bool(config.get("use_jitter", True)),
        window_bits=window_bits,
        num_corres=config.num_corres,
        feature_filter=config.feature_filter,
        spatial_filter=config.spatial_filter,
        filter_radius=config.filter_radius,
        similarity_thresh=config.similarity_thresh,
        use_sc2_filtering=config.use_sc2_filtering,
        sc2=sc2,
        hit_ratio_thresh=config.hit_ratio_thresh,
        label_min_translation_frac=float(
            config.get("label_min_translation_frac", 0.0)),
        labeler_sync_bn=bool(config.get("labeler_sync_bn", False)),
        loss_kind=loss_kind,
        triplet_num_pos=config.triplet_num_pos * config.batch_size,
        triplet_num_rand=config.triplet_num_rand * config.batch_size,
        optimizer=config.get("optimizer", "SGD"),
        adam_betas=(config.get("adam_beta1", 0.9),
                    config.get("adam_beta2", 0.999)),
        momentum=config.momentum,
        weight_decay=config.weight_decay,
        iter_size=config.iter_size,
    )
    evalc = EvalConfig(
        caps=caps,
        voxel_size=config.voxel_size,
        window_bits=window_bits,
        eval_sample_points=config.eval_sample_points,
        sc2=sc2,
        downsample_single=float(config.get("downsample_single", 1.0)),
        hit_ratio_thresh=config.hit_ratio_thresh,
    )
    return train, evalc


class AlignmentTrainer:
    """Base trainer (reference lib/trainer.py:35-197)."""

    LOSS_KIND = "hardest_contrastive"

    def __init__(self, config: Config, data_loader: DataLoader,
                 val_data_loader: DataLoader | None = None, device=None):
        self.config = config
        self.data_loader = data_loader
        self.val_data_loader = val_data_loader
        # fail fast on bad configs (before any model is built)
        if config.get("optimizer", "SGD") not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {config.get('optimizer')!r}; "
                "available: " + ", ".join(OPTIMIZERS))
        dp = int(config.get("dp_devices", -1))
        if dp > 1 or config.get("multihost", False):
            raise NotImplementedError(
                f"dp_devices {dp}, multihost {config.get('multihost')}: the "
                "port trains on one device (-1 or 1); data parallelism is "
                "ROADMAP.md queue 1 item 5")
        if not config.get("normalize_feature", True):
            raise NotImplementedError(
                "normalize_feature False: the port's ResUNet always "
                "L2-normalizes its features (ROADMAP.md queue 1 item 4)")
        self.device = resolve_device(device)
        self.max_epoch = config.max_epoch
        self.val_epoch_freq = config.val_epoch_freq
        self.best_val_metric = config.best_val_metric
        self.best_val = -np.inf
        self.best_val_epoch = -1
        self.start_epoch = 1
        self.checkpoint_dir = config.out_dir
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        config.save(os.path.join(self.checkpoint_dir, "config.json"))
        self.writer = ScalarWriter(config.out_dir)

        self.spec = load_model(config.model)
        seed = config.get("seed", 0)
        self.model = init_unet(
            self.spec, torch.Generator().manual_seed(seed), 1,
            config.model_n_out, config.conv1_kernel_size, device=self.device)
        # the labeler mirrors the student; inert until extension mode
        self.labeler = copy.deepcopy(self.model)
        self.num_updates = 0
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.step_cfg, self.eval_cfg = build_step_config(
            config, self.spec, loss_kind=self.LOSS_KIND)
        c = self.step_cfg
        self.opt = make_optimizer(self.model.parameters(), c.optimizer,
                                  config.lr, c.momentum, c.weight_decay,
                                  c.adam_betas)
        self.similarity = None
        if config.spatial_filter == "Similarity":
            self.similarity = load_similarity_tables(
                config.pretraining_dataset or "kitti").to(self.device)
        self._valid_step = None
        # one entry an epoch: its kind, steps and the timers' averages (s)
        self.epoch_log: list = []

        if config.weights:
            ckpt.load_weights_only(config.weights, self.model)
        if config.resume:
            self._resume(config.resume, config.finetune_restart)

    # ------------------------------------------------------------- helpers

    def _resume(self, path_base: str, finetune_restart: bool):
        if finetune_restart:
            ckpt.load_weights_only(path_base, self.model)
            logging.info("=> Finetuning, loaded model weights only")
            return
        self.num_updates, meta = ckpt.load_checkpoint(
            path_base, self.model, self.labeler, self.opt, self.generator)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.best_val = float(meta.get("best_val", -np.inf))
        self.best_val_epoch = int(meta.get("best_val_epoch", -1))
        self.best_val_metric = meta.get("best_val_metric", self.best_val_metric)
        logging.info(f"=> resumed from {path_base} at epoch {self.start_epoch}")

    def _base_step(self, label_mode: str):
        """step(batch, lr) -> metrics: one base_train_step."""
        def step(batch, lr):
            set_lr(self.opt, lr)
            return base_train_step(self.model, self.opt, batch,
                                   self.step_cfg, generator=self.generator,
                                   device=self.device, label_mode=label_mode)
        return step

    def _extension_step(self):
        """step(batch, lr) -> metrics: one extension_train_step."""
        def step(batch, lr):
            set_lr(self.opt, lr)
            return extension_train_step(
                self.model, self.labeler, self.opt, batch, self.step_cfg,
                similarity=self.similarity, generator=self.generator,
                device=self.device)
        return step

    def _save(self, epoch, name="checkpoint"):
        ckpt.save_checkpoint(
            self.checkpoint_dir, name, epoch=epoch, model=self.model,
            labeler=self.labeler, opt=self.opt, num_updates=self.num_updates,
            generator=self.generator, config=self.config,
            best_val=self.best_val, best_val_epoch=self.best_val_epoch,
            best_val_metric=self.best_val_metric)

    # ---------------------------------------------------------- train loop

    def train(self):
        for epoch in range(self.start_epoch, self.max_epoch + 1):
            lr = exp_lr(self.config.lr, self.config.exp_gamma, epoch)
            logging.info(f" Epoch: {epoch}, LR: {lr:.6g}")
            self._train_epoch(epoch, lr)
            self._save(epoch)
            if (self.val_data_loader is not None
                    and epoch % self.val_epoch_freq == 0):
                val = self._valid_epoch()
                for k, v in val.items():
                    self.writer.add_scalar(f"val/{k}", v, epoch)
                if self.best_val < val[self.best_val_metric]:
                    logging.info(
                        f"Saving best val model {self.best_val_metric}="
                        f"{val[self.best_val_metric]:.4f}")
                    self.best_val = val[self.best_val_metric]
                    self.best_val_epoch = epoch
                    self._save(epoch, "best_val_checkpoint")

    def _label_mode(self) -> str:
        mode = self.data_loader.dataset.label_mode()
        return "identity" if mode == "identity" else "gt"

    def _train_epoch(self, epoch, lr):
        self._run_epoch(self._base_step(self._label_mode()), epoch, lr)

    def _run_epoch(self, step, epoch, lr, extra_meters=()):
        data_timer, total_timer = Timer(), Timer()
        meters = {k: AverageMeter()
                  for k in ("loss", "pos_loss", "neg_loss", *extra_meters)}
        # Caffe-style gradient accumulation: each optimizer step takes
        # iter_size loader batches (reference lib/trainer.py:239-293), as
        # a list of micro-batches
        isz = max(1, int(self.config.iter_size))
        n_steps = len(self.data_loader) // isz
        start_iter = (epoch - 1) * n_steps
        it = iter(self.data_loader)
        for curr_iter in range(n_steps):
            total_timer.tic()
            data_timer.tic()
            batch = next(it) if isz == 1 else [next(it) for _ in range(isz)]
            data_timer.toc()
            metrics = step(batch, lr)
            for k, m in meters.items():
                if k in metrics:
                    m.update(float(metrics[k]))
            total_timer.toc()
            if curr_iter % self.config.stat_freq == 0:
                for k in ("loss", "pos_loss", "neg_loss", *extra_meters):
                    self.writer.add_scalar(f"train/{k}", meters[k].val,
                                           start_iter + curr_iter)
                msg = (
                    f"Train Epoch: {epoch} [{curr_iter}/{n_steps}], "
                    f"Loss: {meters['loss'].val:.3e} "
                    f"Pos: {meters['pos_loss'].val:.3f} "
                    f"Neg: {meters['neg_loss'].val:.3f}"
                    f"\tData: {data_timer.avg:.4f} Iter: {total_timer.avg:.4f}"
                )
                for k in extra_meters:
                    msg += f"\t{k}: {meters[k].avg:.3f}"
                logging.info(msg)
        self.epoch_log.append(dict(
            epoch=epoch, steps=n_steps,
            kind="extension" if "labeler_hit_ratio" in extra_meters
            else "base",
            data_s=data_timer.avg, iter_s=total_timer.avg,
            metrics={k: m.avg for k, m in meters.items()}))

    # ---------------------------------------------------------- validation

    def _valid_epoch(self):
        """reference lib/trainer.py:1736-1826: the valid step on the first
        pair of each validation batch (`eval.valid_pair`),
        feat_match_ratio = mean(hit_ratio > 0.05); pairs whose RRE is not
        finite are skipped."""
        if self._valid_step is None:
            self._valid_step = functools.partial(
                valid_pair, self.model, cfg=self.eval_cfg,
                device=self.device)
        self.val_data_loader.dataset.reset_seed(0)
        meters = {k: AverageMeter() for k in ("loss", "rte", "rre",
                                              "hit_ratio")}
        fmr = AverageMeter()
        # the subsets' uniforms: one generator a validation (JAX splits
        # PRNGKey(0) once a pair)
        gen = torch.Generator().manual_seed(0)
        max_iter = min(self.config.val_max_iter, len(self.val_data_loader))
        it = iter(self.val_data_loader)
        for _ in range(max_iter):
            batch = next(it)
            out = {k: float(v) for k, v in
                   self._valid_step(batch, generator=gen).items()}
            if not np.isfinite(out["rre"]):
                continue
            for k, m in meters.items():
                m.update(out[k])
            fmr.update(float(out["hit_ratio"] > 0.05))
        res = {k: m.avg for k, m in meters.items()}
        res["feat_match_ratio"] = fmr.avg
        logging.info(
            f"Validation: loss {res['loss']:.4f} rte {res['rte']:.4f} "
            f"rre {res['rre']:.4f} hit_ratio {res['hit_ratio']:.4f} "
            f"feat_match_ratio {res['feat_match_ratio']:.4f}")
        return res


class ContrastiveLossTrainer(AlignmentTrainer):
    LOSS_KIND = "contrastive"


class TripletLossTrainer(AlignmentTrainer):
    LOSS_KIND = "triplet"


class HardestTripletLossTrainer(AlignmentTrainer):
    LOSS_KIND = "hardest_triplet"


class HardestContrastiveLossTrainer(AlignmentTrainer):
    LOSS_KIND = "hardest_contrastive"


class ContinuousCorrExtensionTrainer(HardestContrastiveLossTrainer):
    """THE EYOC trainer (reference lib/trainer.py:1429-1826)."""

    def __init__(self, config, data_loader, val_data_loader=None,
                 device=None):
        super().__init__(config, data_loader, val_data_loader, device)
        self.labeler_initialized = False

    def _sync_labeler(self, base_mode: bool):
        """Labeler init / Sync / EMA (reference lib/trainer.py:1491-1516):
        none in base mode; the first sync copies the student (count 1),
        then "Sync" copies it and "EMA" moves the labeler's parameters by
        the debiased EMA at the current count (+1), its BN buffers
        copied."""
        cfg = self.config
        if base_mode and not cfg.skip_initialization:
            return
        if not self.labeler_initialized:
            self.num_updates = sync_labeler(self.labeler, self.model, 0)
            self.labeler_initialized = True
        elif cfg.sync_strategy in ("Sync", "EMA"):
            self.num_updates = sync_labeler(
                self.labeler, self.model, self.num_updates,
                cfg.sync_strategy, cfg.ema_decay)
        else:
            raise NotImplementedError(cfg.sync_strategy)

    def _train_epoch(self, epoch, lr):
        ds = self.data_loader.dataset
        if hasattr(ds, "update_extension_distance"):
            new_dist = ds.update_extension_distance(epoch)
            if new_dist:
                logging.info(f"Dataset extension: MAX_DIST={new_dist}, "
                             f"{len(ds)} pairs")
        base_mode = ds.is_base_dataset()
        self._sync_labeler(base_mode)

        if base_mode and not self.config.skip_initialization:
            self._run_epoch(self._base_step("identity"), epoch, lr)
        else:
            self._run_epoch(self._extension_step(), epoch, lr,
                            extra_meters=("labeler_hit_ratio",
                                          "num_pos_found"))


class CorrespondenceExtensionTrainer(ContinuousCorrExtensionTrainer):
    """Discrete-stage EYOC: a frozen labeler loaded from a previous run
    (reference lib/trainer.py:785-1426, --labeler_dir/--labeler_weight)."""

    def __init__(self, config, data_loader, val_data_loader=None,
                 device=None):
        super().__init__(config, data_loader, val_data_loader, device)
        labeler_path = None
        self.labeler_max_dist = None
        if config.labeler_dir:
            # the labeler run's OWN config supplies its architecture and
            # its pair_max_dist (reference lib/trainer.py:817-836)
            lcfg_path = os.path.join(config.labeler_dir, "config.json")
            if os.path.exists(lcfg_path):
                lcfg = Config.load(lcfg_path)
                self.labeler_max_dist = lcfg.get("pair_max_dist")
                if (lcfg.get("model", config.model) != config.model or
                        lcfg.get("model_n_out") != config.model_n_out):
                    raise ValueError(
                        "labeler architecture differs from the student "
                        f"({lcfg.get('model')}/{lcfg.get('model_n_out')} vs "
                        f"{config.model}/{config.model_n_out}); shared-"
                        "parameter-shape labelers only")
            labeler_path = os.path.join(config.labeler_dir, "checkpoint")
        if config.labeler_weight:
            labeler_path = config.labeler_weight
        if labeler_path:
            ckpt.load_weights_only(labeler_path, self.labeler)
            self.labeler_initialized = True
            logging.info(
                f"Loaded frozen labeler from {labeler_path}"
                + (f" (labeler pair_max_dist={self.labeler_max_dist})"
                   if self.labeler_max_dist is not None else ""))

    def _sync_labeler(self, base_mode: bool):
        if self.labeler_initialized:
            return  # the labeler stays frozen
        super()._sync_labeler(base_mode)


class ContinuousHardestContrastiveTrainer(HardestContrastiveLossTrainer):
    """FCGF+C: supervised hardest-contrastive with progressive extension
    (reference lib/trainer.py:1829-2006)."""

    def _train_epoch(self, epoch, lr):
        ds = self.data_loader.dataset
        if hasattr(ds, "update_extension_distance"):
            new_dist = ds.update_extension_distance(epoch)
            if new_dist:
                logging.info(f"Dataset extension: MAX_DIST={new_dist}, "
                             f"{len(ds)} pairs")
                # best-val resets on extension (reference :1920-1926)
                self.best_val = -np.inf
        mode = ("identity" if (ds.is_base_dataset()
                               and not self.config.supervised) else "gt")
        self._run_epoch(self._base_step(mode), epoch, lr)


TRAINERS = {
    "ContrastiveLossTrainer": ContrastiveLossTrainer,
    "TripletLossTrainer": TripletLossTrainer,
    "HardestTripletLossTrainer": HardestTripletLossTrainer,
    "HardestContrastiveLossTrainer": HardestContrastiveLossTrainer,
    "CorrespondenceExtensionTrainer": CorrespondenceExtensionTrainer,
    "ContinuousCorrExtensionTrainer": ContinuousCorrExtensionTrainer,
    "ContinuousHardestContrastiveTrainer": ContinuousHardestContrastiveTrainer,
}


def get_trainer(name: str):
    """reference train.py:35-51."""
    if name not in TRAINERS:
        raise ValueError(f"unknown trainer {name!r}; available: "
                         f"{sorted(TRAINERS)}")
    return TRAINERS[name]
