#!/usr/bin/env python3
"""Device time of one EYOC extension step at the demo's gates on one GPU:
chip_smoke.py phase 6's gated step (Lowe ratio through kernel K8
`masked_knn2`, the Spherical filter, safe-radius mining through K9), at
the published batch of 8 synthetic KITTI-scale pairs.

    python3 profile_gated_step.py [--steps N]

Builds the kernels, makes chip_smoke.py's phase-5 batch, a fresh student
and its labeler, runs one gated step as a warm-up, then N more under
torch.profiler, one profile each (chip_smoke.py's `extension_breakdown`):
the step's wall time with the profiler on, its device time (the kernels'
own time), the device's busy share, and the kernels with the most device
time. It uses nothing of the port but `extension_train_step` and
chip_smoke.py's helpers, so a copy in a `git archive` of an older tree
measures that tree. Needs a CUDA device; prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import subprocess

import chip_smoke as cs


def main() -> None:
    import torch
    from eyoc_tpu_torch.models import load_model
    from eyoc_tpu_torch.ops.matching import load_similarity_tables
    from eyoc_tpu_torch.training.steps import extension_train_step
    from eyoc_tpu_torch.utils import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gated_step: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    batch = cs.make_train_batch().to("cuda")
    tables = load_similarity_tables("waymo").to("cuda")
    student, labeler, opt, _ = cs.ext_models(load_model("ResUNetBN2C"))
    cfg = cs.ext_config(**cs.GATED)
    gen = torch.Generator().manual_seed(8)
    extension_train_step(student, labeler, opt, batch, cfg, tables,
                         generator=gen, device="cuda")
    torch.cuda.synchronize()
    print(f"gated step ({cs.GATED}), {args.steps} profiled steps after a "
          "warm-up")
    for _ in range(args.steps):
        cs.extension_breakdown(student, labeler, opt, batch, cfg, tables,
                               gen)
    print(f"on {smi}")


if __name__ == "__main__":
    main()
