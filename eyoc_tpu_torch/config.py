"""Configuration: the flag registry of the JAX package (a copy of
eyoc_tpu/config.py, so the port never imports it).

Every flag keeps its name and default, so a command line of the JAX CLI
(e.g. scripts/train_kitti_EYOC.sh:57-87) runs the port unchanged. The
device group keeps the JAX package's capacity flags, which size the
port's static buffers the same way. Configs round-trip through JSON for
resume (`--resume_dir`).

Flags that have no counterpart on one CUDA device: `--dp_devices` above 1
and `--multihost` raise in the trainer (data parallelism is ROADMAP.md
queue 1 item 5); `--matmul_precision` is read by nothing (the port keeps
TF32 off everywhere, utils/device.py).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1")


class Config(dict):
    """dict with attribute access (the easydict the reference leans on)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def copy(self) -> "Config":
        return Config(dict(self))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self, f, indent=4, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(json.load(f))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eyoc_tpu_torch")

    g = p.add_argument_group("Logging")
    g.add_argument("--out_dir", type=str, default="outputs")
    g.add_argument("--labeler_dir", type=str, default="")
    g.add_argument("--labeler_weight", type=str, default="")
    g.add_argument("--pretraining_dataset", type=str, default="")

    g = p.add_argument_group("Trainer")
    g.add_argument("--trainer", type=str, default="HardestContrastiveLossTrainer")
    g.add_argument("--save_freq_epoch", type=int, default=1)
    g.add_argument("--batch_size", type=int, default=4)
    g.add_argument("--val_batch_size", type=int, default=1)
    g.add_argument("--extension_steps", type=int, default=10)
    g.add_argument("--sync_strategy", type=str, default="sync")
    g.add_argument("--ema_decay", type=float, default=0.99)
    g.add_argument("--use_sc2_filtering", type=str2bool, default=True)
    g.add_argument("--feature_filter", type=str, default="Lowe")
    g.add_argument("--spatial_filter", type=str, default="Spherical")
    g.add_argument("--use_hard_negative", type=str2bool, default=True)
    g.add_argument("--hard_negative_sample_ratio", type=float, default=0.05)
    g.add_argument("--hard_negative_max_num", type=int, default=3000)
    g.add_argument("--num_pos_per_batch", type=int, default=1024)
    g.add_argument("--num_hn_samples_per_batch", type=int, default=256)
    g.add_argument("--neg_thresh", type=float, default=1.4)
    g.add_argument("--pos_thresh", type=float, default=0.1)
    # 0.0 = exact reference mining semantics (hash mask of sampled
    # positive pairs only, lib/trainer.py:470-480); >0 also excludes
    # candidate negatives within this radius (m) of the anchor's positive
    # partner — prevents false-negative mining collapse on self-similar
    # geometry (loss.py hardest_contrastive_loss)
    g.add_argument("--hn_safe_radius", type=float, default=0.0)
    # labeling failure gate: mask a pair's pseudo-labels when SC2-PCR's
    # |translation| < frac * frame_distance (identity-attractor detection;
    # steps.py _label_one). 0.0 = reference exceptions-only failures
    g.add_argument("--label_min_translation_frac", type=float, default=0.0)
    # dp>1: synchronize the frozen labeler's BN stats over the dp axis
    # (exact single-process labeling semantics at ~75 extra psums/step)
    g.add_argument("--labeler_sync_bn", type=str2bool, default=False)
    g.add_argument("--neg_weight", type=float, default=1.0)
    g.add_argument("--use_SC2_PCR", type=str2bool, default=False)
    g.add_argument("--use_random_scale", type=str2bool, default=False)
    g.add_argument("--min_scale", type=float, default=0.8)
    g.add_argument("--max_scale", type=float, default=1.2)
    g.add_argument("--use_random_rotation", type=str2bool, default=True)
    g.add_argument("--rotation_range", type=float, default=360.0)
    g.add_argument("--train_phase", type=str, default="train")
    g.add_argument("--val_phase", type=str, default="val")
    g.add_argument("--test_phase", type=str, default="test")
    g.add_argument("--stat_freq", type=int, default=40)
    g.add_argument("--test_valid", type=str2bool, default=True)
    g.add_argument("--val_max_iter", type=int, default=400)
    g.add_argument("--val_epoch_freq", type=int, default=1)
    g.add_argument("--positive_pair_search_voxel_size_multiplier", type=float, default=1.5)
    g.add_argument("--hit_ratio_thresh", type=float, default=0.1)
    g.add_argument("--similarity_thresh", type=float, default=0.4)
    g.add_argument("--filter_radius", type=float, default=20.0)
    g.add_argument("--skip_initialization", type=str2bool, default=False)
    g.add_argument("--triplet_num_pos", type=int, default=256)
    g.add_argument("--triplet_num_hn", type=int, default=512)
    g.add_argument("--triplet_num_rand", type=int, default=1024)

    g = p.add_argument_group("Network")
    g.add_argument("--model", type=str, default="ResUNetBN2C")
    g.add_argument("--model_n_out", type=int, default=32)
    g.add_argument("--conv1_kernel_size", type=int, default=5)
    g.add_argument("--normalize_feature", type=str2bool, default=True)
    g.add_argument("--dist_type", type=str, default="L2")
    g.add_argument("--best_val_metric", type=str, default="feat_match_ratio")

    g = p.add_argument_group("Optimizer")
    # the reference resolves any torch.optim name (lib/trainer.py:80-84);
    # this build supports SGD (published recipes), Adam and AdamW
    # (torch-semantics parity-tested, tests/test_losses.py). NB the demo's
    # Adam default (experiments/extension_demo.py) is a measured deviation
    # from the published SGD recipe — see EXTENSION_DEMO.md §3.
    g.add_argument("--optimizer", type=str, default="SGD",
                   choices=["SGD", "Adam", "AdamW"])
    g.add_argument("--max_epoch", type=int, default=100)
    g.add_argument("--lr", type=float, default=1e-1)
    g.add_argument("--momentum", type=float, default=0.8)
    g.add_argument("--sgd_momentum", type=float, default=0.9)
    g.add_argument("--sgd_dampening", type=float, default=0.1)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--weight_decay", type=float, default=1e-4)
    g.add_argument("--iter_size", type=int, default=1)
    g.add_argument("--bn_momentum", type=float, default=0.05)
    g.add_argument("--exp_gamma", type=float, default=0.99)
    g.add_argument("--scheduler", type=str, default="ExpLR")
    g.add_argument("--finetune_restart", type=str2bool, default=False)

    g = p.add_argument_group("Misc")
    g.add_argument("--weights", type=str, default=None)
    g.add_argument("--resume", type=str, default=None)
    g.add_argument("--resume_dir", type=str, default=None)
    g.add_argument("--train_num_thread", type=int, default=8)
    g.add_argument("--val_num_thread", type=int, default=2)
    g.add_argument("--test_num_thread", type=int, default=2)
    g.add_argument("--nn_max_n", type=int, default=500)
    g.add_argument("--seed", type=int, default=0)

    g = p.add_argument_group("Data")
    g.add_argument("--dataset", type=str, default="KittiNFramePairDataset")
    g.add_argument("--voxel_size", type=float, default=0.3)
    g.add_argument("--kitti_root", type=str, default="/data/kitti")
    g.add_argument("--threed_match_dir", type=str,
                   default="/data/threedmatch",
                   help="3DMatch npz fragment root (reference config.py:127)")
    g.add_argument("--kitti_max_time_diff", type=int, default=3)
    g.add_argument("--kitti_date", type=str, default="2011_09_26")
    g.add_argument("--pair_min_dist", type=int, default=-1)
    g.add_argument("--pair_max_dist", type=int, default=-1)
    g.add_argument("--LoKITTI", type=str2bool, default=False)
    g.add_argument("--LoNUSCENES", type=str2bool, default=False)
    g.add_argument("--LoWAYMO", type=str2bool, default=False)
    g.add_argument("--supervised", type=str2bool, default=False)
    g.add_argument("--percentage", type=float, default=1.0)

    g = p.add_argument_group("Test")
    g.add_argument("--save_dir", type=str, default=None)
    g.add_argument("--use_RANSAC", type=str2bool, default=False)
    g.add_argument("--rte_thresh", type=float, default=2.0)
    g.add_argument("--rre_thresh", type=float, default=5.0)
    g.add_argument("--downsample_single", type=float, default=1.0)

    g = p.add_argument_group("Device")
    g.add_argument("--raw_point_capacity", type=int, default=131072,
                   help="padded raw points per cloud fed to the device")
    g.add_argument("--voxel_capacity", type=int, default=32768,
                   help="stride-1 voxel capacity per cloud")
    g.add_argument("--level_capacity_shrink", type=float, default=2.0,
                   help="capacity ratio between pyramid levels")
    g.add_argument("--corr_capacity", type=int, default=10000,
                   help="padded correspondence buffer (2 x num_corres)")
    g.add_argument("--num_corres", type=int, default=5000,
                   help="top matches per direction (reference hardcodes 5000)")
    g.add_argument("--conv_group", type=int, default=4,
                   help="kernel offsets fused per sparse-conv matmul")
    g.add_argument("--knn_tile", type=int, default=512)
    g.add_argument("--eval_sample_points", type=int, default=5000,
                   help="random sample size at test (test_kitti.py:156)")
    g.add_argument("--dp_devices", type=int, default=-1,
                   help="data-parallel devices (-1 and 1: the one device; "
                        "more raises, ROADMAP.md queue 1 item 5)")
    g.add_argument("--multihost", type=str2bool, default=False,
                   help="multi-host runs (raises: ROADMAP.md queue 1 "
                        "item 5)")
    g.add_argument("--use_jitter", type=str2bool, default=True,
                   help="sigma=0.01 input-feature noise in train phases "
                        "(reference lib/transforms.py:18-30)")
    g.add_argument("--window_bits", type=str, default="10,10,8",
                   help="Morton window bits per axis (x,y,z); the spatial "
                        "window is +-2^(b-1) voxels per axis. z=8 "
                        "(+-38.4 m at 0.3 m voxels) covers KITTI returns "
                        "under most +-45 deg rotation augmentations; the "
                        "few points a near-maximal rotation pushes past "
                        "the window are dropped from voxelization (minor "
                        "documented deviation from the reference, which "
                        "keeps them). z=9 keeps everything at 2x the "
                        "transient neighbor-grid cost; eval uses z=7 "
                        "(no rotation at test, cli/test.py)")
    g.add_argument("--matmul_precision", type=str, default="highest",
                   choices=["default", "bfloat16", "highest"],
                   help="kept for the JAX CLI's command lines; the port "
                        "reads it nowhere (f32 products stay f32, TF32 "
                        "off; the convs are bf16 by design)")
    return p


# SC2-PCR parameters merged at trainer/test init, mirroring
# scripts/SC2_PCR/config_json/config_KITTI.json (reference lib/trainer.py:847-851)
SC2PCR_KITTI = dict(
    num_iterations=20, ratio=0.2, k1=30, k2=20, inlier_threshold=0.6,
    d_thre=0.1, downsample=0.3, re_thre=5, te_thre=60, num_node=8000,
    use_mutual=False, max_points=8000, nms_radius=0.6,
)


def get_config(argv: Optional[List[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    cfg = Config(vars(args))
    if cfg.resume_dir:
        # reference semantics: reload the run's entire config, keep resume_dir
        # (train.py:85-90)
        resume_cfg = Config.load(os.path.join(cfg.resume_dir, "config.json"))
        resume_cfg["resume_dir"] = cfg.resume_dir
        resume_cfg["resume"] = os.path.join(cfg.resume_dir, "checkpoint")
        cfg = resume_cfg
    return cfg


def merge_sc2pcr(cfg: Config) -> Config:
    out = cfg.copy()
    out.update(SC2PCR_KITTI)
    return out


def window_bits_of(cfg: Config) -> tuple:
    v = cfg.get("window_bits", "10,10,8")
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return tuple(int(x) for x in str(v).split(","))


def level_capacities(cfg: Config, num_levels: int = 4) -> tuple:
    caps = [int(cfg.voxel_capacity)]
    for _ in range(num_levels - 1):
        caps.append(max(256, int(caps[-1] / cfg.level_capacity_shrink)))
    return tuple(caps)
