#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`eyoc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. card and build: the card's name and power limit from nvidia-smi; every
   CUDA kernel built from the sources in `eyoc_tpu_torch/csrc/`.
2. every kernel against its plain PyTorch version on the same CUDA tensors
   at the main paths' shapes: error, kernel time and plain time (CUDA
   events over back-to-back calls), the kernel's device time over the same
   calls (torch.profiler), the least time the card could take (bound) and,
   where one PyTorch call computes the same function, that call's time
   (timed in turns with the kernel). K1 (the eval forward, on the calls of
   one ResUNetBN2C forward) and the training kernels (the train forward,
   the conv backward, the row gather, the masked-BN sums, on the calls
   recorded during one full-width train step); K1's time is also split by
   shape class, and the host cost of one K1 and one K6 launch is measured
   on its own (host clock over calls that are not waited for).
3. the eval path at full width: ResUNetBN2C (random weights from a fixed
   generator) through the test protocol (`eval.test_pair`) on synthetic
   KITTI-scale pairs at d = 45 m; finite poses, unit-norm features, and
   every kernel of the path launched (launch counts reset just before, read
   just after).
4. registration sanity: `sc2_pcr` recovers a known pose from N = 5000
   correspondences with 30% inliers.
5. the training path at full width: `training.steps.base_train_step`
   (ResUNetBN2C, hardest-contrastive loss, SGD) on the published recipe's
   batch of 8 synthetic train-phase pairs at d = 8 m; one warm-up step,
   then 3 timed steps, each split by stage; a finite loss, positives found,
   finite and non-zero grads, parameters and BN statistics that moved, and
   every kernel of the step launched (counts reset just before, read just
   after). Then where a step's time goes: the conv maps' share and a
   torch.profiler view of one more step.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi line; before that, a {"kernels": [...]} line with the numbers of
each kernel on each path (K1 and K2 run on both: their training rows are
`sparse_conv_train` and `masked_argmin_train`); `ms` is CUDA-event time,
`device_ms` the profiler's device time of the same calls, so a row whose
`ms` is well above its `device_ms` is bound by the host's launch path. It
needs one CUDA device and imports nothing of JAX.
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
# the published training recipe (scripts/train_kitti_EYOC.sh): batch 8,
# num_pos 1024 * B, num_hn_samples 256 * B, SGD lr 0.1, momentum 0.8
TRAIN_B = 8
TRAIN_DIST = 8.0
TRAIN_STEPS = 3
PROBE_ROWS, PROBE_COLS = 20480, 256   # proto/proto_pallas_gather.py:24

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}

# tolerances of kernel against plain version
K1_RTOL, K1_ATOL_FRAC = 2e-2, 1e-2   # bf16 output, f32 sums in two orders
K2_D2_RTOL = 1e-4                    # direct vs Gram-form squared distance
K2_GAP = 1e-3                        # indices equal where 2nd - 1st > gap
K3_RTOL, K3_ATOL = 1e-4, 1e-7        # f32 power iteration, summation order
K5_RTOL, K5_ATOL_FRAC = 1e-3, 1e-3   # f32 dW, f32 sums of bf16 products
K6B_RTOL, K6B_ATOL = 1e-5, 1e-6      # f32 atomics vs index_add_ order
K7_REL = 1e-4                        # of the sums of absolute values
SMALL_REPS = 200                     # repetitions of the us-sized kernels
LIBRARY_ROUNDS = 6                   # kernel / library timing rounds


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


def _dev_ms(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0)) / 1e3


def device_ms(thunks, reps: int):
    """Device time (torch.profiler) of one pass over `thunks`, the mean of
    `reps` passes: the kernels' own time, without the host's share. A
    profile that recorded no device activity at all (now and then, for a
    short window after long ones) is taken again, up to three times; None
    if it never records any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for f in thunks:
        f()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for f in thunks:
                    f()
            torch.cuda.synchronize()
        total = sum(_dev_ms(e) for e in prof.key_averages()
                    if e.device_type.name == "CUDA")
        if total > 0:
            return total / reps
    return None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.3f} ms"


def host_us(thunks, reps: int) -> float:
    """Host microseconds per call of `thunks`: the host clock over `reps`
    passes that are not waited for (the launch path alone, while the
    device runs behind)."""
    import torch
    for f in thunks:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for f in thunks:
            f()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / (reps * len(thunks)) * 1e6


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
    """Every sparse_conv call of one ResUNetBN2C eval forward, kernel vs
    plain; then the host cost of a K1 call over those calls."""
    import torch
    from eyoc_tpu_torch.models import unet
    from eyoc_tpu_torch.sparse.brick_conv import sparse_conv_plain

    calls = []
    real = unet.sparse_conv

    def record(x, W, nmap, **kw):
        calls.append(((x, W, nmap), kw))
        return real(x, W, nmap, **kw)

    unet.sparse_conv = record
    try:
        model.embed(pyr)
    finally:
        unet.sparse_conv = real
    torch.cuda.synchronize()
    out = check_calls("K1 sparse_conv, one eval forward", calls, real,
                      sparse_conv_plain, _conv_cost,
                      _bf16_close(K1_RTOL, K1_ATOL_FRAC),
                      classify=_conv_class)
    # the tap split adds its partials in a fixed order: the same bits twice
    for a, k in calls:
        if not torch.equal(real(*a, **k), real(*a, **k)):
            raise AssertionError(f"sparse_conv {tuple(a[1].shape)} gives "
                                 "other bits on a second call")
    log(f"K1 sparse_conv: each of the {len(calls)} calls gives the same bits "
        "twice")
    us = host_us([lambda a=a, k=k: real(*a, **k) for a, k in calls], 10)
    log(f"K1 sparse_conv launch path: {us:.2f} us of host time per call "
        f"(the {len(calls)} calls of one eval forward, 10 passes)")
    return out


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
    dev = device_ms([lambda: masked_argmin(q, qm, r, rm)], 10)
    log(f"K2 masked_argmin at D={D}: kernel {ms:.3f} ms (device "
        f"{fmt_ms(dev)}), plain {plain:.3f} ms, bound {b:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


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
    dev = device_ms([lambda: sc2_power_iteration(src, tgt, valid, 0.1, 20)],
                    10)
    log(f"K3 sc2_power_iteration: N={N_CORR}, max err {err:.3e}, kernel "
        f"{ms:.3f} ms (device {fmt_ms(dev)}), plain {plain:.3f} ms, bound "
        f"{b:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


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
    dev = device_ms([lambda: sc2_seed_counts(src, tgt, valid, seeds, 0.1)],
                    10)
    log(f"K4 sc2_seed_counts: S={N_SEEDS} N={N_CORR}, exact, kernel "
        f"{ms:.3f} ms (device {fmt_ms(dev)}), plain {plain:.3f} ms, bound "
        f"{b:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, device_ms=dev)


# ---------------------------------------------------- phase 2, training


TRAIN_KERNELS = ("sparse_conv", "sparse_conv_dgrad", "masked_argmin",
                 "sparse_conv_wgrad", "take_rows", "take_rows_backward",
                 "masked_channel_sums")
EVAL_KERNELS = ("sparse_conv", "masked_argmin", "sc2_power_iteration",
                "sc2_seed_counts")


def make_train_batch():
    from eyoc_tpu_torch.data.synthetic import SyntheticPairs, collate_items
    ds = SyntheticPairs(n_pairs=TRAIN_B, n_points=RAW, dist=TRAIN_DIST,
                        phase="train", voxel_size=0.3)
    return collate_items([ds[i] for i in range(TRAIN_B)], RAW)


def record_train_step(model, opt, batch, cfg, gen):
    """One train step with every call of the training kernels' wrappers
    recorded: {wrapper name: [(args, kwargs), ...]}."""
    import torch
    from eyoc_tpu_torch.ops import rows
    from eyoc_tpu_torch.sparse import brick_conv, norm
    from eyoc_tpu_torch.training import loss, pipeline
    from eyoc_tpu_torch.training.steps import base_train_step

    sites = [(brick_conv, "sparse_conv"), (brick_conv, "sparse_conv_dgrad"),
             (brick_conv, "sparse_conv_wgrad"), (rows, "take_rows_gather"),
             (rows, "take_rows_backward"), (norm, "masked_channel_sums"),
             (pipeline, "masked_argmin"), (loss, "masked_argmin")]
    calls = {name: [] for _, name in sites}
    real = {(mod, name): getattr(mod, name) for mod, name in sites}

    def recorder(mod, name):
        fn = real[(mod, name)]

        def rec(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return rec

    for mod, name in sites:
        setattr(mod, name, recorder(mod, name))
    try:
        metrics = base_train_step(model, opt, batch, cfg, generator=gen,
                                  device="cuda")
    finally:
        for mod, name in sites:
            setattr(mod, name, real[(mod, name)])
    torch.cuda.synchronize()
    return calls, metrics


def check_calls(label, calls, fn, plain, cost, close, library=None,
                reps=5, classify=None):
    """Kernel against plain version on each recorded call; the times and
    bounds are summed over the calls. With `library`, the kernel and the
    library call are timed in LIBRARY_ROUNDS rounds that alternate which
    goes first, and each side takes its median round. With `classify`, the
    kernel time and bound are also summed by class."""
    import torch
    with torch.no_grad():
        return _check_calls(label, calls, fn, plain, cost, close, library,
                            reps, classify)


def _check_calls(label, calls, fn, plain, cost, close, library, reps,
                 classify):
    import torch
    worst = ms = plain_ms = lib_ms = bound = tb = to = 0.0
    classes = {}
    for args, kw in calls:
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        ok, err = close(got, want, *args, **kw)
        if not ok:
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            raise AssertionError(f"{label} {shapes} disagrees with its plain "
                                 f"version: max err {err}")
        worst = max(worst, err)

        def run():
            return fn(*args, **kw)
        if library is None:
            t = time_ms(run, reps=reps)
        else:
            # rounds that alternate which goes first; the median of each
            # side, so that a burst on the shared host in one round does
            # not decide a comparison of us-sized calls
            lib = library(*args, **kw)
            ks, ls = [], []
            for r in range(LIBRARY_ROUNDS):
                order = ((ks, run), (ls, lib)) if r % 2 == 0 else \
                    ((ls, lib), (ks, run))
                for out, f in order:
                    out.append(time_ms(f, reps=reps))
            t = float(np.median(ks))
            lib_ms += float(np.median(ls))
        ms += t
        plain_ms += time_ms(lambda: plain(*args, **kw), reps=2, warmup=1)
        nbytes, ops, kind = cost(*args, **kw)
        tb += nbytes / HBM_BPS * 1e3
        to += ops / PEAK[kind] * 1e3
        b = bound_ms(nbytes, ops, kind)[0]
        bound += b
        if classify is not None:
            c = classes.setdefault(classify(*args, **kw), [0, 0.0, 0.0])
            c[0] += 1
            c[1] += t
            c[2] += b
    dev = device_ms([lambda a=a, k=k: fn(*a, **k) for a, k in calls],
                    min(reps, 50))
    log(f"{label}: {len(calls)} calls, max abs err "
        f"{worst:.3e}, kernel {ms:.3f} ms (device {fmt_ms(dev)}), plain "
        f"{plain_ms:.3f} ms, "
        + (f"library {lib_ms:.3f} ms, " if library is not None else "")
        + f"bound {bound:.4f} ms")
    for name, (n, t, b) in classes.items():
        log(f"  {name}: {n} calls, kernel {t:.3f} ms, bound {b:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if tb >= to else "operations",
                library_ms=lib_ms if library is not None else None,
                device_ms=dev)


def _bf16_close(rtol, atol_frac):
    """K1's tolerance style: rtol of each value plus a fraction of the
    largest."""
    def close(got, want, *args, **kw):
        got, want = got.float(), want.float()
        if want.numel() == 0:
            return True, 0.0
        err = (got - want).abs()
        scale = max(float(want.abs().max()), 1e-6)
        return bool((err <= rtol * want.abs() + atol_frac * scale).all()), \
            float(err.max())
    return close


def _conv_cost(x, W, nmap, x2=None, bias=None, mask=None, residual=None,
               **_):
    T, Ci, Co = W.shape
    M_in, M_out = x.shape[0], nmap.shape[0]
    taps = int(((nmap >= 0) & (nmap < M_in)).sum())
    nbytes = M_in * Ci * 2 + T * Ci * Co * 2 + M_out * T * 4 + M_out * Co * 2
    nbytes += sum(t.numel() * t.element_size()
                  for t in (bias, mask, residual) if t is not None)
    return nbytes, 2.0 * taps * Ci * Co, "bf16"


def _conv_class(x, W, nmap, **_):
    """K1's shape classes, from the shape alone: a narrow input (conv1: one
    channel, which the kernel packs into K), 1x1 (one tap), coarse (fewer
    64 x 64 output tiles than 264, two for each SM: where the kernel splits
    the taps) and fine."""
    T, Ci, Co = W.shape
    if Ci % 8:
        return "narrow input (conv1)"
    if T == 1:
        return "1x1"
    tiles = -(-nmap.shape[0] // 64) * -(-Co // 64)
    return "coarse" if tiles < 264 else "fine"


def _wgrad_cost(x, dy, nmap, x2=None):
    Ci = x.shape[1] + (0 if x2 is None else x2.shape[1])
    M_in, (M_out, T), Co = x.shape[0], nmap.shape, dy.shape[1]
    taps = int(((nmap >= 0) & (nmap < M_in)).sum())
    nbytes = M_in * Ci * 2 + M_out * Co * 2 + M_out * T * 4 + T * Ci * Co * 4
    return nbytes, 2.0 * taps * Ci * Co, "bf16"


def _gather_cost(src, idx):
    import torch
    ok = (idx >= 0) & (idx < src.shape[0])
    rows = int(torch.unique(idx[ok]).numel())
    row_bytes = src[0].numel() * src.element_size()
    return rows * row_bytes + idx.numel() * 4 + idx.numel() * row_bytes, \
        0.0, "f32"


def _scatter_cost(dout, idx, n_src):
    return (dout.numel() * dout.element_size() + idx.numel() * 4
            + n_src * dout.shape[1] * 4), float(dout.numel()), "f32"


def _sums_cost(x, mask, y=None, shift=None):
    e = x.element_size()
    nbytes = x.numel() * e + mask.numel() + (1 + 2 * x.shape[1]) * 4
    if y is not None:
        nbytes += y.numel() * e + x.shape[1] * 4
    return nbytes, 3.0 * x.numel(), "f32"


def _argmin_cost(q, qm, r, rm):
    nq, nr, D = q.shape[0], r.shape[0], q.shape[1]
    pairs = float(qm.sum()) * float(rm.sum())
    return (nq + nr) * D * 4 + nq + nr + nq * 8, 2.0 * pairs * D, "f32"


def _argmin_close(got, want, q, qm, r, rm):
    """K2 against the plain version's Gram form: d2 within K2_D2_RTOL plus
    the Gram form's rounding (1e-6 of |q|^2 + max |r|^2, about 8 f32 ulps of
    its terms: coordinates reach 76 m); indices equal where the gap between
    the first and second nearest valid ref (f64, direct form) is clear of
    K2_GAP and that rounding."""
    import torch
    (d_k, i_k), (d_p, i_p) = got, want
    if d_k.numel() == 0:
        return True, 0.0
    gram = 1e-6 * ((q * q).sum(1) + float((r * r).sum(1).max()))
    err = (d_k - d_p).abs()
    ok = bool((err <= K2_D2_RTOL * d_p.abs() + gram).all())
    full = torch.cdist(q.double(), r.double(),
                       compute_mode="donot_use_mm_for_euclid_dist") ** 2
    full += torch.where(rm, 0.0, 1e30).double()[None]
    two = torch.topk(full, 2, largest=False).values
    del full
    clear = qm & ((two[:, 1] - two[:, 0]) > K2_GAP + 2 * gram)
    ok = ok and bool(torch.equal(i_k[clear], i_p[clear]))
    return ok, float(err[qm].max()) if bool(qm.any()) else 0.0


def _sums_close(got, want, x, mask, y=None, shift=None):
    from eyoc_tpu_torch.sparse.norm import masked_channel_sums_plain
    yabs = None if y is None else (y.float() - (0 if shift is None
                                                else shift)).abs()
    scale = masked_channel_sums_plain(x.float().abs(), mask, yabs)
    err = (got - want).abs()
    return bool((err <= K7_REL * scale + 1e-6).all()), float(err.max())


def check_train_kernels(calls):
    """K1 (the train forward), K1 as dgrad, K2 (GT pairs and mining), K5,
    K6 and its backward, K7 on the recorded calls of one train step, plus
    K6 at the TPU probes' shape. K1 and K2 also run on the eval path: their
    rows here carry the suffix `_train`."""
    import torch
    from eyoc_tpu_torch.ops import knn, rows
    from eyoc_tpu_torch.sparse import brick_conv as bc
    from eyoc_tpu_torch.sparse import norm

    conv_close = _bf16_close(K1_RTOL, K1_ATOL_FRAC)
    out = {}
    out["sparse_conv_train"] = check_calls(
        "K1 sparse_conv, train forward of one step", calls["sparse_conv"],
        bc.sparse_conv, bc.sparse_conv_plain, _conv_cost, conv_close,
        classify=_conv_class)
    out["masked_argmin_train"] = check_calls(
        "K2 masked_argmin, one train step (GT pairs at D = 3, mining at "
        "D = 32)", calls["masked_argmin"], knn.masked_argmin,
        knn.masked_argmin_plain, _argmin_cost, _argmin_close)
    out["sparse_conv_dgrad"] = check_calls(
        "K1 sparse_conv_dgrad, one train step", calls["sparse_conv_dgrad"],
        bc.sparse_conv_dgrad,
        lambda dy, Wt, inv: bc.sparse_conv_plain(dy, Wt, inv), _conv_cost,
        conv_close, classify=_conv_class)
    out["sparse_conv_wgrad"] = check_calls(
        "K5 sparse_conv_wgrad, one train step", calls["sparse_conv_wgrad"],
        bc.sparse_conv_wgrad, bc.sparse_conv_wgrad_plain, _wgrad_cost,
        _bf16_close(K5_RTOL, K5_ATOL_FRAC))

    def gather_close(got, want, *a):
        return bool(torch.equal(got, want)), float(
            (got.float() - want.float()).abs().max()) if got.numel() else 0.0

    def index_select(src, idx):
        if bool(((idx < 0) | (idx >= src.shape[0])).any()):
            raise AssertionError("take_rows: a sentinel on the loss path")
        idx64 = idx.long()
        return lambda: torch.index_select(src, 0, idx64)

    out["take_rows"] = check_calls(
        "K6 take_rows, one train step", calls["take_rows_gather"],
        rows.take_rows_gather,
        rows.take_rows_plain, _gather_cost, gather_close, index_select,
        reps=SMALL_REPS)

    def scatter_close(got, want, *a):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        return bool(torch.allclose(got, want, rtol=K6B_RTOL,
                                   atol=K6B_ATOL)), err

    def index_add(dout, idx, n_src):
        idx64 = idx.long()
        d = dout.float()
        return lambda: torch.zeros((n_src, d.shape[1]), dtype=torch.float32,
                                   device=d.device).index_add_(0, idx64, d)

    out["take_rows_backward"] = check_calls(
        "K6 take_rows_backward, one train step", calls["take_rows_backward"],
        rows.take_rows_backward, rows.take_rows_backward_plain, _scatter_cost,
        scatter_close, index_add, reps=SMALL_REPS)
    out["masked_channel_sums"] = check_calls(
        "K7 masked_channel_sums, one train step",
        calls["masked_channel_sums"],
        norm.masked_channel_sums, norm.masked_channel_sums_plain, _sums_cost,
        _sums_close, reps=SMALL_REPS)

    gen = torch.Generator().manual_seed(4)
    src = torch.randn(PROBE_ROWS, PROBE_COLS, generator=gen).to(
        torch.bfloat16).cuda()
    idx = torch.randint(0, PROBE_ROWS, (PROBE_ROWS,), generator=gen).to(
        torch.int32).cuda()
    check_calls(f"K6 take_rows at the TPU probe shape [{PROBE_ROWS}, "
                f"{PROBE_COLS}] bf16", [((src, idx), {})],
                rows.take_rows_gather, rows.take_rows_plain, _gather_cost,
                gather_close, index_select, reps=SMALL_REPS)

    # the launch path alone: host time per call, not waited for
    (lsrc, lidx), _ = calls["take_rows_gather"][0]
    for what, table, at in (
            (f"a loss call {tuple(lsrc.shape)} -> {tuple(lidx.shape)}", lsrc,
             lidx), ("the probe shape", src, idx)):
        at64 = at.long()
        k = host_us([lambda: rows.take_rows_gather(table, at)], 200)
        lib = host_us([lambda: torch.index_select(table, 0, at64)], 200)
        log(f"K6 take_rows launch path at {what}: {k:.2f} us of host time "
            f"per call, torch.index_select {lib:.2f} us (200 calls)")
    return out


# ------------------------------------------------------------------ phase 5


def train_phase(model, opt, batch, cfg, gen, smi):
    """The training path at full width: one warm-up step, then the timed
    steps with launch counts reset just before them."""
    import torch
    from eyoc_tpu_torch.training.steps import base_train_step
    from eyoc_tpu_torch.utils import kernels

    torch.cuda.reset_peak_memory_stats()     # the peak of this phase alone
    base_train_step(model, opt, batch, cfg, generator=gen,      # warm-up
                    device="cuda")
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    stage_ms, step_ms = {}, []
    kernels.reset_counts()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = base_train_step(model, opt, batch, cfg, generator=gen,
                            device="cuda", timings=stage_ms)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {vals}")
        if vals["num_pos_found"] <= 0:
            raise AssertionError(f"train step {i}: no positive pairs")
        log(f"train step {i}: loss {vals['loss']:.6f} (pos "
            f"{vals['pos_loss']:.6f}, neg {vals['neg_loss']:.6f}), "
            f"{int(vals['num_pos_found'])} positives, {step_ms[-1]:.2f} ms")
    counts = dict(kernels.launches)
    log(json.dumps({"train_launch_counts": counts}))
    missing = [k for k in TRAIN_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"train step launched no {missing}")

    grads = [p.grad for p in model.parameters()]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("a parameter has no or a non-finite grad")
    if not any(bool((g != 0).any()) for g in grads):
        raise AssertionError("every grad is zero")
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    stats = {k for k in before if k.endswith(("running_mean", "running_var"))}
    params = set(before) - stats
    if not (moved & params) or not (moved & stats):
        raise AssertionError("the step moved no parameter or no BN statistic")
    log(f"train: {len(moved & params)}/{len(params)} parameters and "
        f"{len(moved & stats)}/{len(stats)} BN statistics moved")
    split = ", ".join(f"{k} {v / TRAIN_STEPS:.2f}"
                      for k, v in stage_ms.items())
    log(f"train path: ResUNetBN2C, B={TRAIN_B}, {TRAIN_STEPS} steps, "
        f"{np.mean(step_ms):.2f} ms/step ({split} ms; host clock around "
        f"synchronized stages), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, on {smi}")
    train_breakdown(model, opt, batch, cfg, gen)
    return counts


def train_breakdown(model, opt, batch, cfg, gen):
    """Where a train step's time goes, after the counted run: the conv maps
    of one side (with and without their inverses), then torch.profiler over
    one step (device time, busy share, the kernels with most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from eyoc_tpu_torch.sparse.brick_conv import conv_maps
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import base_train_step

    _, pyr = preprocess_clouds(batch.xyz0, batch.n0, caps=cfg.caps,
                               voxel_size=cfg.voxel_size,
                               window_bits=cfg.window_bits)
    maps_ms = []
    for inverse in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv_maps(pyr, 4, 5, inverse=inverse)
        torch.cuda.synchronize()
        maps_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"train: conv maps of one side {maps_ms[0]:.2f} ms, with their "
        f"inverses {maps_ms[1]:.2f} ms (host clock, synchronized)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        base_train_step(model, opt, batch, cfg, generator=gen, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(_dev_ms(e) for e in events)
    log(f"train profiler, one step: wall {wall:.3f} ms (profiler on), "
        f"device time {total:.3f} ms, busy share {total / wall:.3f}, "
        f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=lambda e: -_dev_ms(e))[:12]:
        log(f"  {_dev_ms(e):9.3f} ms  x{e.count:5d}  {e.key[:80]}")


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
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import TrainConfig
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
    t0 = time.perf_counter()
    train_batch = make_train_batch().to("cuda")
    log(f"data: a batch of {TRAIN_B} synthetic train-phase pairs at "
        f"d={TRAIN_DIST} m, {RAW} raw points, "
        f"{time.perf_counter() - t0:.1f} s on the host")

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
    # the training kernels, on the calls of one full-width train step
    train_model = init_unet(spec, torch.Generator().manual_seed(0), 1, 32, 5,
                            device="cuda")
    opt = sgd(train_model.parameters(), lr=0.1, momentum=0.8,
              weight_decay=1e-4)
    tcfg = TrainConfig(caps=CAPS, voxel_size=0.3, num_pos=1024 * TRAIN_B,
                       num_hn_samples=256 * TRAIN_B, window_bits=WINDOW_BITS)
    train_gen = torch.Generator().manual_seed(2)
    calls, m = record_train_step(train_model, opt, train_batch, tcfg,
                                 train_gen)
    log(f"recorded train step: loss {float(m['loss']):.6f}, "
        + ", ".join(f"{len(v)} {k}" for k, v in calls.items()))
    results.update(check_train_kernels(calls))
    del calls
    torch.cuda.empty_cache()

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
    log(json.dumps({"eval_launch_counts": counts}))
    missing = [k for k in EVAL_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"eval path launched no {missing}")
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

    # ---- phase 5: the training path at full width
    train_counts = train_phase(train_model, opt, train_batch, tcfg,
                               train_gen, smi)

    # one row per kernel and path: the eval rows take the eval run's
    # launches (phase 3), the training rows (K1 and K2 with the suffix
    # `_train`, and the training kernels) the training run's (phase 5);
    # each row's times are of the calls of that path
    def launches(name):
        if name in EVAL_KERNELS:
            return counts[name]
        return train_counts[name.removesuffix("_train")]

    source = {"sparse_conv_dgrad": "sparse_conv",
              "sparse_conv_train": "sparse_conv",
              "masked_argmin_train": "masked_argmin",
              "take_rows_backward": "take_rows"}
    replaces = {
        "sparse_conv": "eyoc_tpu/sparse/brick_conv.py:310",
        "sparse_conv_train": "eyoc_tpu/sparse/brick_conv.py:310",
        "sparse_conv_dgrad": "eyoc_tpu/sparse/brick_conv.py:259",
        "masked_argmin": "eyoc_tpu/ops/knn.py:79",
        "masked_argmin_train": "eyoc_tpu/ops/knn.py:79",
        "sc2_power_iteration": "eyoc_tpu/registration/sc2pcr.py:276",
        "sc2_seed_counts": "eyoc_tpu/registration/sc2pcr.py:296",
        "sparse_conv_wgrad": "eyoc_tpu/sparse/brick_conv.py:259",
        "take_rows": "proto/proto_pallas_gather.py:62",
        "take_rows_backward": "eyoc_tpu/training/loss.py:94",
        "masked_channel_sums": "eyoc_tpu/sparse/norm.py:95",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"eyoc_tpu_torch/csrc/{source.get(name, name)}.cu",
         "replaces": replaces[name],
         "launches": launches(name),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
         "device_ms": r["device_ms"]}
        for name, r in results.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
