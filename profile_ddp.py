#!/usr/bin/env python3
"""Data parallelism (eyoc_tpu_torch/parallel/ddp.py) across the cards of
one host, one rank a card:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        profile_ddp.py [--cpu]

1. Sync-BN on each rank's rows against the plain version on every rank's
   rows at once (rank 0 gathers them): SYNC_ROWS rows a rank of SYNC_C
   channels (bf16 on the card), about 70% of them in the mask, the ReLU
   tail, loss sum(y * w). y within Y_ULPS bf16 ulps of the plain apply of
   the whole batch's statistics; dX (K21's two-launch form around an
   all_reduce) within DX_ULPS of the plain backward of the whole batch;
   each rank's dscale / dbias within REL of the plain version's over its
   own rows (each rank's own, which the step then averages); the running
   statistics the same bits on every rank and within REL of the whole
   batch's.
2. The DP train step at chip_smoke.py's phase-5 recipe (TRAIN_B pairs,
   TRAIN_B / D a rank; ResUNetBN2C from a fixed generator; every rank's
   draws from one seed): first a forward of each rank's clouds with the
   statistics of all of them (sync-BN, bn_momentum None) against rank 0's
   forward of all TRAIN_B clouds at once (every live row's cosine at least
   COS_MIN, the dead rows zero in both); then
   one DP step, after which every parameter and BN statistic has the same
   bits on every rank; then the DP step's host ms (synchronized, after a
   first) beside one card's step over the whole batch (rank 0 alone, the
   others waiting), and the all_reduce's ms (CUDA events) of one BN's
   packed sums and of the flattened gradients.

--cpu rehearses the same logic over gloo with the plain versions at small
sizes. Rank 0 prints the card's name and power limit, then one JSON line,
also written to chiprun_out/profile_ddp.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time

import torch
import torch.distributed as dist

import chip_smoke as cs
from eyoc_tpu_torch.parallel import ddp

SYNC_ROWS, SYNC_C = 32768, 64
Y_ULPS = 1                 # y: the same f32 apply of statistics that
                           # differ in their sums' order
DX_ULPS = 2                # dX: chip_smoke's K21_ULPS
REL = 1e-4                 # f32 sums over the ranks in another order
# the sync-BN forward against the global one, through ~40 bf16 layers
# whose statistics differ in their sums' order: every live row's cosine
# (the importer's golden features are held the same way)
COS_MIN = 0.999


def ulps(a, b) -> float:
    """Largest distance in bf16 units in the last place, relative to the
    larger magnitude of each pair (chip_smoke._ulps)."""
    return cs._ulps(a, b)


def sync_bn_check(dev, dtype, rank, world):
    from eyoc_tpu_torch.sparse import norm
    g = torch.Generator().manual_seed(100 + rank)
    x = (torch.randn(SYNC_ROWS, SYNC_C, generator=g) * 2 + 0.3 * rank)
    mask = torch.rand(SYNC_ROWS, generator=g) < 0.7
    w = torch.randn(SYNC_ROWS, SYNC_C, generator=g)
    g0 = torch.Generator().manual_seed(7)
    scale = 0.5 + torch.rand(SYNC_C, generator=g0)
    bias = 0.2 * torch.randn(SYNC_C, generator=g0)
    x, mask, w = x.to(dev, dtype), mask.to(dev), w.to(dev)
    scale, bias = scale.to(dev), bias.to(dev)
    xs = x.clone().requires_grad_()
    sp, bp = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    rm = torch.zeros(SYNC_C, device=dev)
    rv = torch.ones(SYNC_C, device=dev)
    y = norm.masked_batch_norm(xs, mask, sp, bp, rm, rv, relu=True,
                               group=dist.group.WORLD)
    (y.float() * w).sum().backward()

    def every(t):
        return ddp.gather(t.contiguous())

    X, Mk, W = every(x), every(mask), every(w)
    Y, DX = every(y.detach()), every(xs.grad)
    RM, RV = every(rm), every(rv)
    out = {}
    if rank == 0:
        xa, ma, wa = X.reshape(-1, SYNC_C), Mk.reshape(-1), W.reshape(-1, SYNC_C)
        sums = norm.masked_channel_sums_plain(xa, ma)
        stats, var = norm._segment_stats(sums[:1], sums[None, 1:1 + SYNC_C],
                                         sums[None, 1 + SYNC_C:], 1e-5)
        gs = stats[:, SYNC_C:2 * SYNC_C] * scale
        gof = torch.cat([gs, bias - stats[:, :SYNC_C] * gs], dim=1)
        ya = norm.masked_norm_apply_plain(xa, ma, gof, relu=True)
        dy = wa.to(dtype)
        dxa, _, _, _ = norm.masked_norm_backward_plain(xa, ma, 1, scale,
                                                       stats, dy, ya)
        # momentum 0.05 from (0, 1), the unbiased variance
        n = torch.clamp(sums[0], min=1.0)
        mean_want = 0.05 * stats[0, :SYNC_C]
        var_want = 0.95 + 0.05 * var[0] * n / torch.clamp(n - 1, min=1.0)
        out = dict(
            y_ulps=ulps(Y.reshape(-1, SYNC_C), ya),
            dx_ulps=ulps(DX.reshape(-1, SYNC_C), dxa),
            running_same_bits=bool(all(torch.equal(RM[0], RM[r]) and
                                       torch.equal(RV[0], RV[r])
                                       for r in range(world))),
            running_err=float(max((RM[0] - mean_want).abs().max(),
                                  (RV[0] - var_want).abs().max())))
    # each rank's dscale / dbias: the plain version over its own rows, with
    # the whole batch's statistics
    stats_all = torch.empty(1, 3 * SYNC_C, device=dev)
    if rank == 0:
        stats_all.copy_(stats)
    dist.broadcast(stats_all, 0)
    dy = w.to(dtype)
    own = norm.masked_norm_backward_sums_plain(x, mask, 1, stats_all, dy,
                                               y.detach())
    _, _, ds, db = norm.masked_norm_backward_finish_plain(
        x, mask, 1, scale, stats_all, own, own, dy, y.detach())
    rel = max(float(((sp.grad - ds).abs() / (ds.abs() + 1)).max()),
              float(((bp.grad - db).abs() / (db.abs() + 1)).max()))
    rel_all = ddp.gather(torch.tensor(rel, device=dev))
    if rank == 0:
        out["param_grad_rel"] = float(rel_all.max())
        ok = (out["y_ulps"] <= Y_ULPS and out["dx_ulps"] <= DX_ULPS
              and out["running_same_bits"] and out["running_err"] <= REL
              and out["param_grad_rel"] <= REL)
        out["ok"] = bool(ok)
    return out


def _digest(model) -> str:
    h = hashlib.sha1()
    for v in model.state_dict().values():
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dp_step_check(dev, rank, world, small):
    from eyoc_tpu_torch.data.synthetic import SyntheticPairs, collate_items
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import TrainConfig, base_train_step
    raw, caps = (4096, (1024, 512, 256, 128)) if small else (cs.RAW, cs.CAPS)
    B = cs.TRAIN_B
    ds = SyntheticPairs(n_pairs=B, n_points=raw, dist=cs.TRAIN_DIST,
                        phase="train", voxel_size=0.3)
    batch = collate_items([ds[i] for i in range(B)], raw)
    cfg = TrainConfig(caps=caps, voxel_size=0.3, num_pos=1024 * B,
                      num_hn_samples=256 * B, window_bits=cs.WINDOW_BITS)
    dtype = torch.float32 if small else torch.bfloat16
    spec = load_model("ResUNetBN2C")

    def fresh():
        model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                          dtype=dtype, device=dev)
        return model, sgd(model.parameters(), lr=0.1, momentum=0.8,
                          weight_decay=1e-4)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    # the forward with every rank's statistics against the global forward
    model, _ = fresh()
    model.train()
    local = ddp.shard_batch(batch, rank, world).to(dev)
    _, pyr = preprocess_clouds(local.xyz0, local.n0, caps=caps,
                               voxel_size=0.3, window_bits=cs.WINDOW_BITS)
    with torch.no_grad():
        f = model(pyr, bn_momentum=None, group=dist.group.WORLD)
    F = ddp.gather(f)
    if rank == 0:
        full = batch.to(dev)
        _, gpyr = preprocess_clouds(full.xyz0, full.n0, caps=caps,
                                    voxel_size=0.3,
                                    window_bits=cs.WINDOW_BITS)
        with torch.no_grad():
            want = model(gpyr, bn_momentum=None)
        got = F.reshape(want.shape)
        live = want.norm(dim=1) > 1e-6
        cos = (got[live] * want[live]).sum(1) / (
            got[live].norm(dim=1) * want[live].norm(dim=1))
        out["forward_min_cos"] = float(cos.min())
        out["forward_max_err"] = float((got - want).abs().max())
        out["forward_ok"] = bool(out["forward_min_cos"] >= COS_MIN and
                                 not got[~live].any())
    # one DP step: the same bits on every rank
    model, opt = fresh()
    ddp.dp_train_step("base", model, opt, batch, cfg,
                      generator=torch.Generator().manual_seed(5), device=dev)
    digests = [None] * world
    dist.all_gather_object(digests, _digest(model))
    out["same_bits"] = len(set(digests)) == 1
    # times: DP steps after the first, then one card over the whole batch
    ms = []
    for i in range(3):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        ddp.dp_train_step("base", model, opt, batch, cfg,
                          generator=torch.Generator().manual_seed(6 + i),
                          device=dev)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["dp_step_ms"] = ms
    dist.barrier()
    if rank == 0:
        one, one_opt = fresh()
        one_ms = []
        for i in range(4):
            sync()
            t0 = time.perf_counter()
            base_train_step(one, one_opt, batch, cfg,
                            generator=torch.Generator().manual_seed(9 + i),
                            device=dev)
            sync()
            if i:
                one_ms.append((time.perf_counter() - t0) * 1e3)
        out["one_card_step_ms"] = one_ms
    dist.barrier()
    # the collectives' own time
    n_grad = sum(p.numel() for p in model.parameters())
    for name, n in (("bn_sums", 1 + 2 * 64), ("grads", n_grad)):
        t = torch.ones(n, device=dev)
        dist.all_reduce(t)
        sync()
        if dev.type == "cuda":
            out[f"all_reduce_{name}_ms"] = cs.time_ms(
                lambda: dist.all_reduce(t), reps=20)
    out["grad_floats"] = n_grad
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="gloo and the plain versions at small sizes")
    args = p.parse_args()
    dev = torch.device("cpu") if args.cpu else None
    ddp.maybe_distributed_init(device=dev)
    dev = dev or torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if args.cpu:
        torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    smi = "cpu"
    if not args.cpu:
        from eyoc_tpu_torch.utils import kernels
        if rank == 0:
            kernels.build_all()
        dist.barrier()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    dtype = torch.float32 if args.cpu else torch.bfloat16
    res = {"world": world, "card": smi,
           "sync_bn": sync_bn_check(dev, dtype, rank, world),
           "dp_step": dp_step_check(dev, rank, world, args.cpu)}
    dist.barrier()
    if rank == 0:
        ok = res["sync_bn"]["ok"] and res["dp_step"]["same_bits"] and \
            res["dp_step"]["forward_ok"]
        res["ok"] = bool(ok)
        print(smi)
        line = json.dumps(res)
        print(line, flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open("chiprun_out/profile_ddp.json", "a") as f:
            f.write(line + "\n")
    dist.destroy_process_group()
    return 0 if rank != 0 or res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
