#!/usr/bin/env python3
"""Where the port's test protocol spends its time on one GPU.

    python3 profile_torch_stages.py [--pairs N]

Runs the configuration of chip_smoke.py's main path (ResUNetBN2C, random
weights, synthetic KITTI-scale pairs at d = 45 m, CAPS (16384, 5120, 1536,
512), SC2-PCR with 5000 points and 1000 seeds) and prints:

1. per-stage host-clock times, each stage bracketed by
   torch.cuda.synchronize(), averaged over the pairs;
2. a torch.profiler view of one whole `test_pair`: wall time, summed device
   time of all kernels, the device's busy share, the number of kernel
   launches and the ten kernels with the most device time.

Needs a CUDA device; prints the card's name and power limit beside the
numbers.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import chip_smoke as cs


def main() -> None:
    import torch
    from eyoc_tpu_torch import eval as teval
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.ops.knn import masked_argmin
    from eyoc_tpu_torch.registration import sc2pcr
    from eyoc_tpu_torch.sparse.brick_conv import conv_maps
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.utils import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=cs.N_PAIRS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_stages: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    cs.N_PAIRS = args.pairs
    pairs = [b.to("cuda") for b in cs.make_pairs()]
    model = init_unet(load_model("ResUNetBN2C"),
                      torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    cfg = teval.EvalConfig(
        caps=cs.CAPS, voxel_size=0.3, window_bits=cs.WINDOW_BITS,
        eval_sample_points=cs.N_CORR,
        sc2=sc2pcr.SC2PCRConfig(max_points=cs.N_CORR, seed_cap=cs.N_SEEDS))
    c = cfg.sc2
    gen = torch.Generator().manual_seed(1)
    ms = collections.defaultdict(float)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3
        return out

    def one_pair(batch):
        got = []
        for xyz, n in ((batch.xyz0, batch.n0), (batch.xyz1, batch.n1)):
            vox, pyr = timed("feat.preprocess (voxelize + pyramid)",
                             lambda: preprocess_clouds(
                                 xyz, n, caps=cfg.caps,
                                 voxel_size=cfg.voxel_size,
                                 window_bits=cfg.window_bits))
            timed("feat.conv_maps (inside the forward)",
                  lambda: conv_maps(pyr, 4, 5))
            f = timed("feat.forward (maps + 23 K1 convs + normalize)",
                      lambda: model(pyr))
            got.append((vox.xyz[0], f, vox.mask[0]))
        (x0, f0, m0), (x1, f1, m1) = got
        n = cfg.eval_sample_points
        sel0, sel1 = timed("reg.subset", lambda: (
            teval.random_subset(teval.subset_noise(m0, gen), n),
            teval.random_subset(teval.subset_noise(m1, gen), n)))
        src, sf, sm = x0[sel0], f0[sel0], m0[sel0]
        tx, tf, tm = x1[sel1], f1[sel1], m1[sel1]
        _, nn = timed("reg.knn (K2)", lambda: masked_argmin(sf, sm, tf, tm))
        tgt = tx[nn.long()]
        conf = timed("reg.sc2.power_iteration (K3)",
                     lambda: sc2pcr.sc2_power_iteration(
                         src, tgt, sm, c.d_thre, c.num_iterations)) * sm
        pair_ok = sm[:, None] & sm[None, :]
        dist = timed("reg.sc2.nms_dist ([N, N] masked distances)",
                     lambda: torch.where(
                         pair_ok, sc2pcr._pairwise_dist(src),
                         torch.full((), float("inf"), device=src.device)))
        seeds, seed_ok = timed("reg.sc2.nms (pick_seeds)",
                               lambda: sc2pcr._pick_seeds(
                                   dist, conf, c.nms_radius,
                                   min(c.num_seeds, src.shape[0])))
        knn_idx = timed("reg.sc2.seed_topk (K4: counts and k1 top-k)",
                        lambda: sc2pcr.sc2_seed_topk(src, tgt, sm, seeds,
                                                     c.d_thre, c.k1))
        T, _ = timed("reg.sc2.consensus (local SC2, k2 top-k, Kabsch, "
                     "fitness)",
                     lambda: sc2pcr._seed_transforms(c, seed_ok, knn_idx,
                                                     src, tgt, sm))
        timed("reg.sc2.irls (<= 20 host-synced iterations)",
              lambda: sc2pcr._post_refine(c, T, src, tgt, sm))

    one_pair(pairs[0])                                   # warm-up
    ms.clear()
    for batch in pairs:
        one_pair(batch)
    print(f"card: {smi}")
    print(f"stages, ms per pair (mean of {len(pairs)} pairs, host clock "
          "around synchronized calls):")
    for name, v in ms.items():
        print(f"  {name:55s} {v / len(pairs):9.3f}")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        teval.test_pair(model, pairs[0], cfg, generator=gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(dev_us(e) for e in events)
    launches = sum(e.count for e in events)
    print(f"profiler, one test_pair: wall {wall:.3f} ms (profiler on), "
          f"device time {total_us / 1e3:.3f} ms, busy share "
          f"{total_us / 1e3 / wall:.3f}, {launches} device ops")
    for e in sorted(events, key=lambda e: -dev_us(e))[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    print(f"on {smi}")


if __name__ == "__main__":
    main()
