"""Test entry point: `python -m eyoc_tpu_torch.cli.test --save_dir ...
--flags` (counterpart of eyoc_tpu/cli/test.py; the reference
scripts/test_kitti.py:236-295 protocol, the same flags and defaults).

Each pair: voxelize + features of both clouds (`eval.embed_pair`), then a
5000-point random subset and the estimator (`eval.register_pair`): the
two-stage RANSAC by default (`--use_RANSAC true`, as the reference), or
SC2-PCR with `SC2PCR_KITTI` (`--use_RANSAC false`); RTE / RRE / RR against
the ground truth, with the Data / Feat / Reg timers of the reference's log.
Feat and Reg are timed on the host clock around calls that end with a
device synchronize, as the JAX version blocks on its results. The pairs'
random draws come from one torch.Generator on the device, seeded 0.

It runs on the card unless `main` is given `device="cpu"` (the plain
versions). Under torchrun, `--dp_devices` D (clamped to the ranks there
are, as eyoc_tpu/cli/test.py:140 clamps it to the devices) splits the pair
list over the ranks: each batch holds D pairs, each rank embeds and
registers its own (its draws from a generator seeded with its rank), the
poses are gathered, and rank 0 logs the summary one process would over
all the pairs. The JAX package's `utils/platform.py` has no
counterpart: it sets JAX's platform and matmul precision, and the port keeps
TF32 off everywhere (utils/device.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

from eyoc_tpu_torch.config import (Config, SC2PCR_KITTI, str2bool,
                                   window_bits_of)
from eyoc_tpu_torch.data.loader import make_data_loader
from eyoc_tpu_torch.eval import embed_pair, register_pair
from eyoc_tpu_torch.geometry.metrics import registration_success
from eyoc_tpu_torch.geometry.se3 import transform_points
from eyoc_tpu_torch.models import init_unet, load_model
from eyoc_tpu_torch.ops.knn import masked_argmin
from eyoc_tpu_torch.parallel import ddp
from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.training import checkpoint as ckpt
from eyoc_tpu_torch.training.trainer import build_step_config
from eyoc_tpu_torch.utils.device import resolve_device
from eyoc_tpu_torch.utils.timer import AverageMeter, Timer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--save_dir", default=None, type=str, required=True)
    p.add_argument("--test_phase", default="test", type=str)
    p.add_argument("--dataset", default=None, type=str)
    p.add_argument("--LoKITTI", default=False, type=str2bool)
    p.add_argument("--LoNUSCENES", default=False, type=str2bool)
    p.add_argument("--LoWAYMO", default=False, type=str2bool)
    p.add_argument("--pair_min_dist", default=None, type=int)
    p.add_argument("--pair_max_dist", default=None, type=int)
    p.add_argument("--downsample_single", default=1.0, type=float)
    p.add_argument("--kitti_root", type=str, default="/data/kitti")
    p.add_argument("--use_RANSAC", type=str2bool, default=True)
    p.add_argument("--rre_thresh", default=5.0, type=float)
    p.add_argument("--rte_thresh", default=2.0, type=float)
    p.add_argument("--num_pairs", default=-1, type=int,
                   help="limit evaluated pairs (debug)")
    p.add_argument("--trace_dir", default="", type=str,
                   help="write a torch.profiler trace of the eval loop "
                        "here (trace.json, Chrome trace format)")
    p.add_argument("--nn_dist_stats", default=False, type=str2bool,
                   help="collect the matched-correspondence NN-distance "
                        "distribution under the GT pose (reference "
                        "scripts/test_kitti.py:49-53,153-154 collects this "
                        "but never reports it; here it is summarized and "
                        "saved to <save_dir>/nn_dists.npy)")
    p.add_argument("--window_bits", default="9,9,7", type=str,
                   help="spatial window bits per axis of the voxel engine. "
                        "The test protocol applies no rotation augmentation "
                        "(reference lib/data_loaders.py:1824-1831), so 9,9,7 "
                        "bits (+-153 m xy, +-19 m z at 0.3 m voxels) cover "
                        "unrotated LiDAR returns; training configs use "
                        "10,10,8+. Out-of-window points are counted and "
                        "reported at the end of the run: widen if nonzero")
    p.add_argument("--dp_devices", default=1, type=int,
                   help="ranks to shard the pair list over (run under "
                        "torchrun; clamped to the ranks there are)")
    return p.parse_args(argv)


def load_test_config(args) -> Config:
    config = Config.load(os.path.join(args.save_dir, "config.json"))
    config.save_dir = args.save_dir
    config.test_phase = args.test_phase
    config.kitti_root = args.kitti_root
    config.LoKITTI = args.LoKITTI
    config.LoNUSCENES = args.LoNUSCENES
    config.LoWAYMO = args.LoWAYMO
    config.phase = "test"
    config.use_RANSAC = args.use_RANSAC
    config.supervised = False
    if args.dataset is not None:
        config.dataset = args.dataset
    if args.use_RANSAC:
        logging.info("--use_RANSAC true: the two-stage RANSAC (H = 1M "
                     "hypotheses, the reference's 4M-iteration budget "
                     "class); pass --use_RANSAC false for the SC2-PCR "
                     "estimator")
    else:
        config.update(SC2PCR_KITTI)
        config.use_SC2_PCR = True
    if args.pair_min_dist is not None and args.pair_max_dist is not None:
        config.pair_min_dist = args.pair_min_dist
        config.pair_max_dist = args.pair_max_dist
    config.rte_thresh = args.rte_thresh
    config.rre_thresh = args.rre_thresh
    config.downsample_single = args.downsample_single
    config.window_bits = args.window_bits
    config.nn_dist_stats = args.nn_dist_stats
    config.trace_dir = args.trace_dir
    return config


def _window_dropped(batch, bits, voxel_size: float):
    """(points outside the voxel window, points) of a batch's clouds: the
    voxel engine drops those (sparse/morton.py), so the run reports them."""
    shift = np.asarray(morton.shift(bits))
    gdims = np.asarray(morton.dims(bits))
    lost = tot = 0
    for xyz, n in ((batch.xyz0, batch.n0), (batch.xyz1, batch.n1)):
        for b in range(xyz.shape[0]):
            m = int(n[b])
            c = np.floor(xyz[b, :m].numpy() / voxel_size).astype(
                np.int64) + shift
            lost += int(np.sum(np.any((c < 0) | (c >= gdims), axis=-1)))
            tot += m
    return lost, tot


def main(config, num_pairs=-1, dp=1, device=None, record=None):
    """Runs the test protocol over the config's test split; returns {"rr",
    "rte", "rre", "pairs_per_sec", the Data / Feat / Reg times and
    "dropped", the mean share of raw points outside the voxel window}.
    `record`, a list, gets (batch, generator state before the pair's
    registration, T_est) for each pair, so that a caller can replay a
    pair's draws (under data parallelism, of this rank's pair)."""
    dp = max(1, min(dp, ddp.world_size()))
    if dp > 1 and dp != ddp.world_size():
        raise ValueError(f"--dp_devices {dp} of {ddp.world_size()} ranks: "
                         "launch as many ranks as devices")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rank0 = ddp.rank() == 0

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def info(msg):
        if rank0:
            logging.info(msg)

    if float(config.get("downsample_single", 1.0)) != 1.0:
        # the reference parses --downsample_single (scripts/test_kitti.py:
        # 251,289) but dead-codes it; the flag's evident intent is live
        # here: keep that share of each cloud's voxels before the sample
        info("--downsample_single=%.3f: keeping that fraction of each "
             "cloud's voxels before the %d-pt sample (NOTE: dead code in "
             "the reference; live here)" % (float(config.downsample_single),
                                            config.eval_sample_points))

    loader = make_data_loader(config, config.test_phase, dp, shuffle=False,
                              device=dev)
    spec = load_model(config.model)
    model = init_unet(spec, torch.Generator().manual_seed(0), 1,
                      config.model_n_out, config.conv1_kernel_size,
                      device=dev)
    best = os.path.join(config.save_dir, "best_val_checkpoint")
    if os.path.exists(best + ".pt"):
        ckpt.load_weights_only(best, model)
        info(f"loaded weights from {best}")
    elif rank0:
        logging.warning(f"no checkpoint at {best}; evaluating random init")
    _, cfg = build_step_config(config, spec)
    cfg = dataclasses.replace(cfg, use_ransac=bool(config.use_RANSAC))
    gen = torch.Generator(device=dev).manual_seed(ddp.rank())
    if dp > 1:
        info(f"eval sharded over {dp} ranks")

    wbits = window_bits_of(config)
    vs = float(config.voxel_size)
    drop_meter = AverageMeter()
    nn_dists = []
    rte_thresh, rre_thresh = config.rte_thresh, config.rre_thresh
    success_meter, rte_meter, rre_meter = (AverageMeter(), AverageMeter(),
                                           AverageMeter())
    data_timer, feat_timer, reg_timer = Timer(), Timer(), Timer()
    N = len(loader) if num_pairs < 0 else min(num_pairs, len(loader))

    trace_dir = config.get("trace_dir") or ""
    prof = None
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    it = iter(loader)
    for i in range(N):
        data_timer.tic()
        batch = next(it)
        data_timer.toc()

        lost, tot = _window_dropped(batch, wbits, vs)
        drop_meter.update(lost / max(tot, 1))
        if lost and drop_meter.count == 1 and rank0:
            logging.warning(
                "%.2f%% of raw points fall outside the voxel window "
                "(window_bits=%s) and are silently dropped: widen "
                "--window_bits if this data is rotated/augmented",
                100.0 * lost / tot, wbits)

        # the Feat time spans the host-to-device copy, as the JAX CLI's
        # (its embed takes the host batch)
        feat_timer.tic()
        batch = batch.to(dev)
        mine = ddp.shard_batch(batch, ddp.rank(), dp) if dp > 1 else batch
        embedded = embed_pair(model, mine, cfg, dev)
        sync()
        feat_timer.toc()

        state = gen.get_state() if record is not None else None
        reg_timer.tic()
        if dp > 1:
            T_all = ddp.dp_register_pair(embedded, cfg, generator=gen)
            T_est = T_all[ddp.rank()]
        else:
            T_est = register_pair(*embedded, cfg, generator=gen)
            T_all = T_est[None]
        sync()
        reg_timer.toc()
        if record is not None:
            record.append((mine, state, T_est))

        for d in range(dp):
            T_gt = batch.T_gt[d]
            ok, te, re = registration_success(T_all[d], T_gt, rte_thresh,
                                              rre_thresh)
            te, re = float(te), float(re)
            if te < rte_thresh:
                rte_meter.update(te)
            if np.isfinite(re) and re < rre_thresh:
                rre_meter.update(re)
            if bool(ok):
                success_meter.update(1)
            else:
                success_meter.update(0)
                info(f"Failed with RTE: {te}, RRE: {re}")
        if config.get("nn_dist_stats") and dp == 1:
            x0, f0, m0, x1, f1, m1 = embedded
            _, nn = masked_argmin(f0.float().contiguous(), m0,
                                  f1.float().contiguous(), m1)
            d = (transform_points(x0, batch.T_gt[0]) - x1[nn.long()]).norm(
                dim=-1)
            nn_dists.append(d[m0].cpu().numpy())

        if i % 10 == 0:
            info(
                f"{i} / {N}: Data time: {data_timer.avg:.4f}, "
                f"Feat time: {feat_timer.avg:.4f}, Reg time: "
                f"{reg_timer.avg:.4f}, RTE: {rte_meter.avg:.4f}, RRE: "
                f"{rre_meter.avg:.4f}, Success: {success_meter.sum} / "
                f"{success_meter.count} ({success_meter.avg * 100:.4f} %)")

    if prof is not None:
        prof.stop()
        if rank0:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            info(f"profiler trace written to {trace_dir}")
    if nn_dists:
        alld = np.concatenate(nn_dists)
        np.save(os.path.join(config.save_dir, "nn_dists.npy"), alld)
        info(
            f"NN-dist under GT: mean {alld.mean():.3f} m, "
            f"median {np.median(alld):.3f} m, "
            f"<0.3 m: {100.0 * (alld < 0.3).mean():.1f} %")
    if drop_meter.avg > 0 and rank0:
        logging.warning(
            f"out-of-window dropped points: {drop_meter.avg * 100:.2f}% "
            f"average over {drop_meter.count} batches (window_bits={wbits})")
    info(
        f"RTE: {rte_meter.avg:.4f}, var: {rte_meter.var:.6f}, "
        f"RRE: {rre_meter.avg:.4f}, var: {rre_meter.var:.6f}, "
        f"Success: {success_meter.sum} / {success_meter.count} "
        f"({success_meter.avg * 100:.4f} %)")
    return {
        "rr": success_meter.avg,
        "rte": rte_meter.avg,
        "rre": rre_meter.avg,
        "pairs_per_sec": 1.0 / max(feat_timer.avg + reg_timer.avg, 1e-9),
        "data_time": data_timer.avg,
        "feat_time": feat_timer.avg,
        "reg_time": reg_timer.avg,
        "dropped": drop_meter.avg,
    }


if __name__ == "__main__":
    from eyoc_tpu_torch.cli.train import log_to_stdout

    log_to_stdout()
    args = parse_args()
    ddp.maybe_distributed_init()
    main(load_test_config(args), num_pairs=args.num_pairs,
         dp=args.dp_devices)
