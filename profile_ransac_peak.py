#!/usr/bin/env python3
"""Peak device memory of one eval pair's RANSAC registration on one GPU:
`eval.register_pair` with `use_ransac` (the test CLI's default) on
`chip_smoke.py`'s four synthetic pairs at full width (ResUNetBN2C, random
weights from seed 0; draws from a CUDA generator), after a warm-up call
per pair, as `torch.cuda.max_memory_allocated()` above what was allocated
before the call.

    python3 profile_ransac_peak.py

It uses only `eval`'s and `chip_smoke`'s public names, so a copy of it in a
`git archive` of an older tree measures that tree. Prints the card's name
and power limit beside the numbers.
"""

from __future__ import annotations

import subprocess
import sys

sys.path.insert(0, ".")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_ransac_peak: no CUDA device")
    import chip_smoke as cs
    from eyoc_tpu_torch.eval import EvalConfig, embed_pair, register_pair
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    model = init_unet(load_model("ResUNetBN2C"),
                      torch.Generator().manual_seed(0), 1, 32, 5,
                      device="cuda")
    cfg = EvalConfig(caps=cs.CAPS, voxel_size=0.3,
                     window_bits=cs.WINDOW_BITS,
                     eval_sample_points=cs.N_CORR,
                     sc2=SC2PCRConfig(max_points=cs.N_CORR,
                                      seed_cap=cs.N_SEEDS),
                     use_ransac=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    peaks = []
    for batch in cs.make_pairs():
        x = embed_pair(model, batch.to("cuda"), cfg)
        register_pair(*x, cfg, generator=gen)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        register_pair(*x, cfg, generator=gen)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 20)
    print("register_pair(use_ransac) peak device memory above its inputs, "
          "MiB a pair: " + " ".join(f"{p:.1f}" for p in peaks)
          + f" on {smi}")


if __name__ == "__main__":
    main()
