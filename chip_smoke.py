#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`eyoc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. card and build: the card's name and power limit from nvidia-smi; every
   CUDA kernel built from the sources in `eyoc_tpu_torch/csrc/`.
2. every kernel against its plain PyTorch version on the same CUDA tensors
   at the main path's shapes: error, kernel time and plain time (CUDA
   events), and the least time the card could take (bound).
3. the main path at full width: ResUNetBN2C (random weights from a fixed
   generator) through the test protocol (`eval.test_pair`) on synthetic
   KITTI-scale pairs at d = 45 m; finite poses, unit-norm features, and
   every kernel launched (launch counts reset just before, read just after).
4. registration sanity: `sc2_pcr` recovers a known pose from N = 5000
   correspondences with 30% inliers.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi line; before that, a {"kernels": [...]} line with each kernel's
numbers. It needs one CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

RAW = 131072
CAPS = (16384, 5120, 1536, 512)
WINDOW_BITS = (9, 9, 7)
N_PAIRS = 4
PAIR_DIST = 45.0
N_CORR = 5000
N_SEEDS = 1000

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}

# tolerances of kernel against plain version
K1_RTOL, K1_ATOL_FRAC = 2e-2, 1e-2   # bf16 output, f32 sums in two orders
K2_D2_RTOL = 1e-4                    # direct vs Gram-form squared distance
K2_GAP = 1e-3                        # indices equal where 2nd - 1st > gap
K3_RTOL, K3_ATOL = 1e-4, 1e-7        # f32 power iteration, summation order


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, kind: str):
    tb, to = nbytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def make_pairs():
    from eyoc_tpu_torch.data.synthetic import SyntheticPairs, collate_items
    ds = SyntheticPairs(n_pairs=N_PAIRS, n_points=RAW, dist=PAIR_DIST,
                        phase="test", voxel_size=0.3)
    return [collate_items([ds[i]], RAW) for i in range(N_PAIRS)]


# ------------------------------------------------------------------ phase 2


def check_sparse_conv(model, pyr):
    """Every sparse_conv call of one ResUNetBN2C forward, kernel vs plain."""
    import torch
    from eyoc_tpu_torch.models import unet
    from eyoc_tpu_torch.sparse.brick_conv import sparse_conv_plain

    calls = []
    real = unet.sparse_conv

    def record(x, W, nmap, **kw):
        calls.append((x, W, nmap, kw))
        return real(x, W, nmap, **kw)

    unet.sparse_conv = record
    try:
        model(pyr)
    finally:
        unet.sparse_conv = real
    torch.cuda.synchronize()

    worst, ms, plain_ms, bound, tb, to = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    for x, W, nmap, kw in calls:
        got = real(x, W, nmap, **kw).float()
        want = sparse_conv_plain(x, W, nmap, **kw).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        scale = float(want.abs().max())
        tol = K1_RTOL * want.abs() + K1_ATOL_FRAC * max(scale, 1e-6)
        if not bool(torch.all(err <= tol)):
            raise AssertionError(
                f"sparse_conv {tuple(x.shape)}x{tuple(W.shape)} disagrees: "
                f"max err {float(err.max())} at scale {scale}")
        worst = max(worst, float(err.max()))
        ms += time_ms(lambda: real(x, W, nmap, **kw), reps=5)
        plain_ms += time_ms(lambda: sparse_conv_plain(x, W, nmap, **kw),
                            reps=2, warmup=1)
        T, Ci, Co = W.shape
        M_in, M_out = x.shape[0], nmap.shape[0]
        taps = int(((nmap >= 0) & (nmap < M_in)).sum())
        nbytes = (M_in * Ci * 2 + T * Ci * Co * 2 + M_out * T * 4
                  + M_out * Co * 2 + M_out + Co * 4
                  + (M_out * Co * 2 if kw.get("residual") is not None else 0))
        tb += nbytes / HBM_BPS * 1e3
        to += 2.0 * taps * Ci * Co / PEAK["bf16"] * 1e3
        bound += bound_ms(nbytes, 2.0 * taps * Ci * Co, "bf16")[0]
    log(f"K1 sparse_conv: {len(calls)} calls of one forward, max abs err "
        f"{worst:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if tb >= to else "operations")


def check_masked_argmin(gen):
    """D = 32 (feature matching, timed) and D = 3 (coordinates, f32)."""
    import torch
    from eyoc_tpu_torch.ops.knn import masked_argmin, masked_argmin_plain

    worst = 0.0
    for D in (3, 32):
        q = torch.randn(N_CORR, D, generator=gen)
        r = torch.randn(N_CORR, D, generator=gen)
        if D == 32:
            q = torch.nn.functional.normalize(q, dim=1)
            r = torch.nn.functional.normalize(r, dim=1)
        q, r = q.cuda(), r.cuda()
        qm = (torch.rand(N_CORR, generator=gen) < 0.95).cuda()
        rm = (torch.rand(N_CORR, generator=gen) < 0.95).cuda()
        d_k, i_k = masked_argmin(q, qm, r, rm)
        d_p, i_p = masked_argmin_plain(q, qm, r, rm)
        # the gap between the first and second nearest valid ref, per query
        full = torch.cdist(q, r) ** 2 + torch.where(rm, 0.0, 1e30)[None]
        two = torch.topk(full, 2, largest=False).values
        clear = qm & ((two[:, 1] - two[:, 0]) > K2_GAP)
        if not bool(torch.equal(i_k[clear], i_p[clear])):
            raise AssertionError(f"masked_argmin D={D}: indices disagree "
                                 "on clear gaps")
        err = float((d_k - d_p).abs().max())
        if not bool(torch.allclose(d_k, d_p, rtol=K2_D2_RTOL,
                                   atol=K2_D2_RTOL)):
            raise AssertionError(f"masked_argmin D={D}: distances "
                                 f"disagree: {err}")
        worst = max(worst, err)
        log(f"K2 masked_argmin: {N_CORR}x{N_CORR}x{D}, {int(clear.sum())} "
            f"clear queries equal, max d2 err {err:.3e}")
    ms = time_ms(lambda: masked_argmin(q, qm, r, rm))
    plain = time_ms(lambda: masked_argmin_plain(q, qm, r, rm), reps=3)
    nq, nr = int(qm.sum()), int(rm.sum())
    b, by = bound_ms(2 * N_CORR * D * 4 + 2 * N_CORR + N_CORR * 8,
                     2.0 * nq * nr * D, "f32")
    log(f"K2 masked_argmin at D={D}: kernel {ms:.3f} ms, plain {plain:.3f} "
        f"ms, bound {b:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by)


def correspondences(gen, n=N_CORR, inlier=0.3, noise=0.01):
    """Known pose + n correspondences, `inlier` of them true."""
    import torch
    from eyoc_tpu_torch.geometry.se3 import integrate_trans, transform_points
    src = torch.rand(n, 3, generator=gen) * torch.tensor([80.0, 80.0, 6.0]) \
        - torch.tensor([40.0, 40.0, 3.0])
    yaw = 0.25
    R = torch.tensor([[np.cos(yaw), -np.sin(yaw), 0.0],
                      [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    T = integrate_trans(R, torch.tensor([3.0, -1.5, 0.2]))
    tgt = transform_points(src, T) + noise * torch.randn(n, 3, generator=gen)
    out = torch.rand(n, generator=gen) >= inlier
    tgt[out] = torch.rand(int(out.sum()), 3, generator=gen) * 80.0 - 40.0
    valid = torch.ones(n, dtype=torch.bool)
    return src.cuda(), tgt.cuda(), valid.cuda(), T.cuda()


def check_power_iteration(gen):
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import (
        sc2_power_iteration, sc2_power_iteration_plain)
    src, tgt, valid, _ = correspondences(gen)
    valid[-50:] = False
    k = sc2_power_iteration(src, tgt, valid, 0.1, 20)
    p = sc2_power_iteration_plain(src, tgt, valid, 0.1, 20)
    err = float((k - p).abs().max())
    if not bool(torch.allclose(k, p, rtol=K3_RTOL, atol=K3_ATOL)):
        raise AssertionError(f"sc2_power_iteration disagrees: {err}")
    ms = time_ms(lambda: sc2_power_iteration(src, tgt, valid, 0.1, 20))
    plain = time_ms(lambda: sc2_power_iteration_plain(src, tgt, valid, 0.1,
                                                      20), reps=3)
    nv = int(valid.sum())
    b, by = bound_ms(2 * N_CORR * 12 + N_CORR + N_CORR * 4,
                     20.0 * nv * nv * 24, "f32")
    log(f"K3 sc2_power_iteration: N={N_CORR}, max err {err:.3e}, kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by)


def check_seed_counts(gen):
    import torch
    from eyoc_tpu_torch.registration.sc2pcr import (
        sc2_seed_counts, sc2_seed_counts_plain)
    src, tgt, valid, _ = correspondences(gen)
    valid[-50:] = False
    seeds = torch.randperm(N_CORR, generator=gen)[:N_SEEDS].to(
        torch.int32).cuda()
    k = sc2_seed_counts(src, tgt, valid, seeds, 0.1)
    p = sc2_seed_counts_plain(src, tgt, valid, seeds, 0.1)
    err = float((k - p).abs().max())
    if not bool(torch.equal(k, p)):
        raise AssertionError(f"sc2_seed_counts not exact: {err}")
    ms = time_ms(lambda: sc2_seed_counts(src, tgt, valid, seeds, 0.1))
    plain = time_ms(lambda: sc2_seed_counts_plain(src, tgt, valid, seeds,
                                                  0.1), reps=3)
    nv = int(valid.sum())
    b, by = bound_ms(2 * N_CORR * 12 + N_CORR + N_SEEDS * 4
                     + N_SEEDS * N_CORR * 4,
                     2.0 * N_SEEDS * nv * nv, "int8")
    log(f"K4 sc2_seed_counts: S={N_SEEDS} N={N_CORR}, exact, kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by)


# ------------------------------------------------------------------- main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from eyoc_tpu_torch.eval import EvalConfig, embed_pair, register_pair
    from eyoc_tpu_torch.geometry.metrics import registration_success
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig, sc2_pcr
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.utils import kernels

    # ---- phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"build: {kernels.build_all():.1f} s for {len(kernels.KERNELS)} "
        "kernels")

    t0 = time.perf_counter()
    pairs = make_pairs()
    log(f"data: {N_PAIRS} synthetic pairs at d={PAIR_DIST} m, {RAW} raw "
        f"points, {time.perf_counter() - t0:.1f} s on the host")

    spec = load_model("ResUNetBN2C")
    gen = torch.Generator().manual_seed(0)
    model = init_unet(spec, gen, 1, 32, 5, device="cuda")
    cfg = EvalConfig(caps=CAPS, voxel_size=0.3, window_bits=WINDOW_BITS,
                     eval_sample_points=N_CORR,
                     sc2=SC2PCRConfig(max_points=N_CORR, seed_cap=N_SEEDS))

    # ---- phase 2: kernels against their plain versions
    b0 = pairs[0].to("cuda")
    _, pyr = preprocess_clouds(b0.xyz0, b0.n0, caps=CAPS, voxel_size=0.3,
                               window_bits=WINDOW_BITS)
    results = {
        "sparse_conv": check_sparse_conv(model, pyr),
        "masked_argmin": check_masked_argmin(gen),
        "sc2_power_iteration": check_power_iteration(gen),
        "sc2_seed_counts": check_seed_counts(gen),
    }

    # ---- phase 3: the main path at full width
    noise_gen = torch.Generator().manual_seed(1)
    x = embed_pair(model, b0, cfg)               # warm-up, not timed
    register_pair(*x, cfg, generator=noise_gen)
    torch.cuda.synchronize()
    kernels.reset_counts()
    feat_ms, reg_ms, n_ok = [], [], 0
    for batch in pairs:
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0, f0, m0, x1, f1, m1 = embed_pair(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T_est = register_pair(x0, f0, m0, x1, f1, m1, cfg,
                              generator=noise_gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        feat_ms.append((t1 - t0) * 1e3)
        reg_ms.append((t2 - t1) * 1e3)
        if not bool(torch.isfinite(T_est).all()):
            raise AssertionError(f"non-finite T_est {T_est}")
        for f, m in ((f0, m0), (f1, m1)):
            norms = f[m].norm(dim=1)
            if norms.numel() == 0 or float((norms - 1).abs().max()) > 1e-3:
                raise AssertionError("features are not unit-norm")
            if bool((f[~m] != 0).any()):
                raise AssertionError("features at invalid voxels are not 0")
        ok, te, re = registration_success(T_est, batch.T_gt[0])
        n_ok += int(ok)
        log(f"pair: voxels {int(m0.sum())}/{int(m1.sum())}, feat "
            f"{feat_ms[-1]:.2f} ms, reg {reg_ms[-1]:.2f} ms, RTE "
            f"{float(te):.3f} m, RRE {float(re):.3f} deg")
    counts = dict(kernels.launches)
    log(json.dumps({"launch_counts": counts}))
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    log(f"main path: ResUNetBN2C, {N_PAIRS} pairs, feat "
        f"{np.mean(feat_ms):.2f} ms/pair, reg {np.mean(reg_ms):.2f} ms/pair "
        f"(host clock around synchronized calls), RR of the untrained net "
        f"{n_ok}/{N_PAIRS}, on {smi}")

    # ---- phase 4: registration sanity
    src, tgt, valid, T_true = correspondences(torch.Generator().manual_seed(3))
    T_est, _ = sc2_pcr(src, tgt, valid, cfg.sc2)
    _, te, re = registration_success(T_est, T_true)
    if not (float(te) < 0.1 and float(re) < 1.0):
        raise AssertionError(f"sc2_pcr missed a known pose: RTE {float(te)} "
                             f"m, RRE {float(re)} deg")
    log(f"sc2_pcr sanity: RTE {float(te):.4f} m, RRE {float(re):.4f} deg")

    replaces = {
        "sparse_conv": "eyoc_tpu/sparse/brick_conv.py:310",
        "masked_argmin": "eyoc_tpu/ops/knn.py:79",
        "sc2_power_iteration": "eyoc_tpu/registration/sc2pcr.py:276",
        "sc2_seed_counts": "eyoc_tpu/registration/sc2pcr.py:296",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"eyoc_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, r in results.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
