#!/usr/bin/env python3
"""K19's and K23's device time, for this tree of the port or another one,
so that two trees are compared in one chip call.

    python3 profile_k19_k23.py [--root DIR] [--tag NAME]

--root: the directory whose `eyoc_tpu_torch` is imported (default: this
script's); a parent commit unpacked with `git archive` into a git-ignored
directory (build/parent) is measured by the same code. Run the trees in
turn, parent, change, change, parent, in one call: a card's power limit
and clocks differ between machines.

On chip_smoke.py's inputs (generators of their own, as phase 2 draws them)
it times, each as the device time (torch.profiler, chip_smoke's
`device_ms`), the CUDA-event time, the host's microseconds a call and the
device kernels a call with each kernel's device time:
- K19 `est_quad_linear_robust` at the valid step's shape (B = 1, N = 5000)
  and at N = 9000 (one problem, every row valid; chip_smoke's batch of 3
  problems with 0, 3 and 9000 valid rows), at the tree's cluster size and,
  where the tree has clusters, at 2, 4, 8 and 16 CTAs a problem; there,
  with the stamped entry, the device clock's split of a round (`k19_split`);
- K23 `sc2_seed_transforms_jacobi` at the eval shape (B = 1, N = 5000, S
  = 1000) and the labeling shape (B = 8, N = 8000, S = 1600), and K14 (QCP)
  at both.
It prints sha1 digests of K14's and K23's outputs, which two trees must
share where the kernel keeps its bits, and the pose checks' largest ratios
(chip_smoke's `_seed_close`: the kernel's and the plain version's, to the
solve's reach and to the reach with the weights' rounding) for K14 at the
labeling shape and K23 at both. Prints the card's name and power limit,
then one JSON line (also appended to build/profile_k19_k23_<tag>.json).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import chip_smoke as cs


def time_call(fn, args, reps=20):
    """{device_ms, event_ms, host_us, kernels, per_kernel} of fn(*args)."""
    import torch
    thunk = [lambda: fn(*args)]
    with torch.no_grad():
        dev = cs.device_ms(thunk, reps)
        ev = cs.time_ms(thunk[0], reps=reps)
        host = cs.host_us(thunk, reps)
        k, events, _, _ = cs.count_kernels(thunk[0], 5)
    return dict(device_ms=dev, event_ms=ev, host_us=host, kernels=k,
                per_kernel={e.key[:48]: round(cs._dev_ms(e) / 5, 4)
                            for e in events})


def k19_rows(robust, has_cluster):
    """K19's rows: the valid shape and N = 9000, at the tree's cluster size
    and, with clusters, at 2, 4, 8 and 16."""
    import torch
    one, batch = cs.k19_problems(torch.Generator().manual_seed(12))
    nine = tuple(x[2:3].contiguous() for x in batch)
    fn = robust.est_quad_linear_robust
    rows = {}
    sizes = [None] + ([2, 4, 8, 16] if has_cluster else [])
    default = getattr(robust, "K19_CLUSTER", None)
    for C in sizes:
        if C is not None:
            robust.K19_CLUSTER = C
        tag = "" if C is None else f" cluster {C}"
        for name, args in (("valid shape", one), ("N 9000", nine),
                           ("batch 0/3/9000", batch)):
            got = fn(*args)
            ref = robust.est_quad_linear_robust_plain(args[0], args[1],
                                                      mask=args[2])
            row = time_call(fn, args)
            row["disp_vs_plain_m"] = max(cs._row_disp(got, ref, args[0],
                                                      args[2]))
            rows[f"K19 {name}{tag}"] = row
    if has_cluster:
        robust.K19_CLUSTER = default
    return rows, one


def k19_split(robust, one):
    """The device clock's split of K19's rounds (the stamped entry; cycles
    of thread 0 of the first CTA, the mean over the rounds but the last):
    the warps' sums and the block barrier, the CTA's sums and the cluster
    barrier, the cluster's sums (warp 0), the solve, the compose and the
    block barrier, the pass over the rows; a round's cycles, the rounds'
    to the last round's sums."""
    import torch
    from eyoc_tpu_torch.utils import kernels
    fn = kernels.load("robust_irls", robust._K19_ARGS[:-1] + (
        ctypes.c_void_p, ctypes.c_void_p),
        symbol="est_quad_linear_robust_stamped")
    src, tgt, valid = one
    iters = robust.NUM_ITERS
    out = torch.empty((1, 4, 4), device="cuda")
    stamps = torch.zeros((iters, 6), dtype=torch.int64, device="cuda")
    p = kernels.ptr
    for _ in range(3):
        err = fn(p(src), p(tgt), p(valid), 1, src.shape[1], iters,
                 robust.K19_CLUSTER, None, p(out), p(stamps),
                 kernels.stream_handle(0))
        if err != 0:
            raise RuntimeError(f"est_quad_linear_robust_stamped: CUDA "
                               f"error {err}")
        torch.cuda.synchronize()
    s = stamps.cpu().double()
    step = s[:, 1:] - s[:, :-1]
    names = ("warps", "cluster_barrier", "cluster_sums", "solve", "passes")
    # the rounds but the last (it ends after the cluster's sums)
    out = {n: float(step[:-1, k].mean()) for k, n in enumerate(names)}
    out["round"] = float((s[1:, 0] - s[:-1, 0]).mean())
    out["total"] = float(s[-1, 3] - s[0, 0])
    return out


def sc2_rows(sc2pcr, SC2PCRConfig):
    """K23 and K14 at the eval and labeling shapes: times, digests, and the
    pose checks' ratios (K14 at the labeling shape, K23 at both)."""
    e_cfg = SC2PCRConfig(max_points=cs.N_CORR, seed_cap=cs.N_SEEDS)
    l_cfg = cs.ext_config().sc2
    rows, digests, ratios = {}, {}, {}
    for shape, make, cfg in (("eval", cs.jacobi_eval_set, e_cfg),
                             ("label", cs.jacobi_label_set, l_cfg)):
        for qcp in (False, True):
            c = dataclasses.replace(cfg, qcp_kabsch=qcp)
            (args, _), = cs.sc2_calls(*make(), c)["sc2_seed_transforms"]
            name = ("K14" if qcp else "K23") + f" {shape}"
            got = sc2pcr.sc2_seed_transforms(*args)
            digests[name] = cs.sc2_digest(got)
            rows[name] = time_call(sc2pcr.sc2_seed_transforms, args)
            if not qcp or shape == "label":
                want = sc2pcr.seed_transforms_batched_plain(*args)
                ratios[name] = {}
                cs._seed_close(got, want, *args, out=ratios[name])
    return rows, digests, ratios


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import eyoc_tpu_torch
    from eyoc_tpu_torch.geometry import robust
    from eyoc_tpu_torch.registration import sc2pcr
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
    from eyoc_tpu_torch.utils import kernels
    if not torch.cuda.is_available():
        raise SystemExit("profile_k19_k23: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    has_cluster = hasattr(robust, "K19_CLUSTER")
    rows, one = k19_rows(robust, has_cluster)
    split = k19_split(robust, one) if has_cluster else None
    sc2, digests, ratios = sc2_rows(sc2pcr, SC2PCRConfig)
    rows.update(sc2)
    out = dict(tag=args.tag, root=os.path.dirname(eyoc_tpu_torch.__file__),
               card=smi, key=cs.k23_digest_key(), rows=rows,
               k19_round_cycles=split, digests=digests, ratios=ratios)
    print(smi)
    line = json.dumps(out)
    os.makedirs("build", exist_ok=True)
    with open(f"build/profile_k19_k23_{args.tag}.json", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
