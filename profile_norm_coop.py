#!/usr/bin/env python3
"""K20's and K21's device time on the paths that call them, for this tree of
the port or another one, so that two trees are compared in one chip call.

    python3 profile_norm_coop.py [--root DIR] [--tag NAME]

--root: the directory whose `eyoc_tpu_torch` is imported (default: this
script's); a parent commit unpacked with `git archive` into a git-ignored
directory (build/parent) is measured by the same code. Run the trees in
turn, parent, change, change, parent, in one call: a card's power limit
and clocks differ between machines.

At chip_smoke.py's phase-5 configuration (batch TRAIN_B of synthetic
train-phase pairs, CAPS, random weights from fixed generators) it records
the K21 calls of one ResUNetBN2C train step, the K20 and K21 calls of one
ResUNetIN2C train step (after a warm-up step each) and the K20 calls of
one ResUNetIN2C eval forward (pair 0 of chip_smoke's eval pairs), and
times each set of calls: the device time (torch.profiler, chip_smoke's
`device_ms`), the CUDA-event time of the calls back to back, the host's
microseconds a call, the device kernels a call, and each call's own
device time beside its shape and tail. Then the device time
of one whole BN and IN train step and of one IN eval forward. It also
prints sha1 digests of K2's (D = 3 and 32), K8's and K9's (D = 32)
outputs on seeded inputs and K2's and K8's plans at those shapes, which
two trees must share. Prints the card's name and power limit, then one
JSON line (also appended to build/profile_norm_coop_<tag>.json).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import chip_smoke as cs


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _shape(a, k):
    """(rows, channels, segments, tail) of a recorded K20 / K21 call."""
    x, S = a[0], a[2]
    if "counter" in k:                                  # K21
        tail = ("residual" if a[8] else "skip" if a[7] is not None
                else "relu" if a[6] is not None else "bare")
    else:
        tail = ("residual" if k.get("residual") is not None else "skip"
                if k.get("skip") else "relu" if k.get("relu") else "bare")
    return [x.shape[0], x.shape[1], S, tail]


def time_calls(fn, calls, reps=20):
    """{device_ms, event_ms, host_us, kernels, calls, per_call} of one pass
    over the recorded `calls` of `fn`; per_call: [rows, channels,
    segments, tail, device us] of each call (its own profiler window)."""
    import torch
    thunks = [lambda a=a, k=k: fn(*a, **k) for a, k in calls]
    with torch.no_grad():
        dev = cs.device_ms(thunks, reps)
        ev = sum(cs.time_ms(t, reps=reps) for t in thunks)
        host = cs.host_us(thunks, reps)
        per_call = cs.count_kernels(thunks[0], 5)[0]
        each = [_shape(a, k) + [round(1e3 * (cs.device_ms([t], 10) or 0.0),
                                      2)]
                for (a, k), t in zip(calls, thunks)]
    return dict(device_ms=dev, event_ms=ev, host_us=host, kernels=per_call,
                calls=len(calls), per_call=each)


def record_step(model, opt, batch, cfg, gen):
    """The norm kernels' wrapper calls of one base train step."""
    import torch
    from eyoc_tpu_torch.sparse import norm
    from eyoc_tpu_torch.training.steps import base_train_step
    sites = [(norm, "masked_instance_norm"), (norm, "masked_norm_backward")]
    with cs.recording(sites) as calls:
        base_train_step(model, opt, batch, cfg, generator=gen,
                        device="cuda")
    torch.cuda.synchronize()
    return calls


def bits_and_plans():
    """sha1 digests of K2, K8 and K9 outputs on seeded inputs at the
    models' widths, and their plans."""
    import torch
    from eyoc_tpu_torch.ops import knn
    gen = torch.Generator().manual_seed(5)
    out = {}
    for D, n in ((3, 8192), (32, 5000)):
        q = torch.randn(n, D, generator=gen).cuda() * (10 if D == 3 else 1)
        r = torch.randn(n, D, generator=gen).cuda() * (10 if D == 3 else 1)
        m = (torch.rand(n, generator=gen) < 0.9).cuda()
        out[f"masked_argmin@{D}"] = _digest(*knn.masked_argmin(q, m, r, m))
        out[f"k2_plan@{D}"] = list(knn.k2_plan(
            1, n, n, D, knn._k2_resident(0, D)))
    q = torch.nn.functional.normalize(torch.randn(2, 4096, 32,
                                                  generator=gen), dim=-1)
    r = torch.nn.functional.normalize(torch.randn(2, 4096, 32,
                                                  generator=gen), dim=-1)
    m = torch.rand(2, 4096, generator=gen) < 0.9
    q, r, m = q.cuda(), r.cuda(), m.cuda()
    out["masked_knn2@32"] = _digest(*knn.masked_knn_batched(q, m, r, m, 2))
    out["k8_plan@32"] = list(knn.k2_plan(2, 4096, 4096, 32,
                                         knn._knn2_resident(0, False),
                                         (512, 256)))
    pxyz = (torch.rand(4096, 3, generator=gen) * 20).cuda()
    cxyz = (torch.rand(4096, 3, generator=gen) * 20).cuda()
    out["masked_argmin_excl@32"] = _digest(*knn.masked_argmin_excl(
        q[0], r[1], pxyz, cxyz, 2.25))
    out["k9_plan@32"] = list(knn.k2_plan(1, 4096, 4096, 32,
                                         knn._knn2_resident(0, True),
                                         (512, 256)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import eyoc_tpu_torch
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.sparse import norm
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.pipeline import preprocess_clouds
    from eyoc_tpu_torch.training.steps import TrainConfig, base_train_step
    from eyoc_tpu_torch.utils import kernels
    if not torch.cuda.is_available():
        raise SystemExit("profile_norm_coop: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    batch = cs.make_train_batch().to("cuda")
    cfg = TrainConfig(caps=cs.CAPS, voxel_size=0.3,
                      num_pos=1024 * cs.TRAIN_B,
                      num_hn_samples=256 * cs.TRAIN_B,
                      window_bits=cs.WINDOW_BITS)
    rows, steps = {}, {}
    for name in ("ResUNetBN2C", "ResUNetIN2C"):
        model = init_unet(load_model(name), torch.Generator().manual_seed(0),
                          1, 32, 5, device="cuda")
        opt = sgd(model.parameters(), lr=0.1, momentum=0.8,
                  weight_decay=1e-4)
        gen = torch.Generator().manual_seed(2)
        base_train_step(model, opt, batch, cfg, generator=gen,
                        device="cuda")
        calls = record_step(model, opt, batch, cfg, gen)
        if name == "ResUNetBN2C":
            rows["K21 BN step"] = time_calls(norm.masked_norm_backward,
                                             calls["masked_norm_backward"])
        else:
            rows["K21 IN step"] = time_calls(
                norm.masked_norm_backward,
                [c for c in calls["masked_norm_backward"]
                 if c[1]["counter"] == "masked_norm_backward"])
            rows["K20 IN train forward"] = time_calls(
                norm.masked_instance_norm, calls["masked_instance_norm"])
        del calls
        steps[f"{name} train step"] = cs.device_ms(
            [lambda: base_train_step(model, opt, batch, cfg, generator=gen,
                                     device="cuda")], 3)
        del model, opt
        torch.cuda.empty_cache()
    cs.N_PAIRS = 1
    b0 = cs.make_pairs()[0].to("cuda")
    _, pyr = preprocess_clouds(b0.xyz0, b0.n0, caps=cs.CAPS, voxel_size=0.3,
                               window_bits=cs.WINDOW_BITS)
    model = init_unet(load_model("ResUNetIN2C"),
                      torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    calls = cs.record_in_forward(model, pyr)
    rows["K20 eval forward"] = time_calls(norm.masked_instance_norm, calls)
    with torch.no_grad():
        steps["ResUNetIN2C eval forward"] = cs.device_ms(
            [lambda: model.embed(pyr)], 5)
    out = dict(tag=args.tag, root=os.path.dirname(eyoc_tpu_torch.__file__),
               card=smi, rows=rows, steps=steps, bits=bits_and_plans())
    print(smi)
    line = json.dumps(out)
    os.makedirs("build", exist_ok=True)
    with open(f"build/profile_norm_coop_{args.tag}.json", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
