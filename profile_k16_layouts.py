#!/usr/bin/env python3
"""K16's solve-and-count pass in two layouts on one GPU, at the eval
path's shape (H = 1048576 hypotheses, a 512-row subset, the top 2048, N =
5000 correspondences at 30% inliers, `chip_smoke.correspondences`):

    python3 profile_k16_layouts.py

- thread: `registration.ransac.ransac_hypotheses_topk`, the port's kernel
  (csrc/ransac.cu's `solve_count`: one thread a survivor, its subset rows
  in a loop);
- warp: the same pipeline with csrc/probes/ransac_layouts.cu's
  `solve_count_warp` (one warp a survivor, the rows split over the lanes,
  a fixed xor-shuffle tree), built through `kernels.build`;
- single-stage + sort: the route the eval path took before the two-stage
  entry (K16's `ransac_hypotheses`, every pose written, then `topk`, the
  stable sort of the H counts).

Checks that the two layouts give the same bits on every output, then
times each (CUDA events, rounds in the order thread, warp, warp, thread)
and reads each pass's device time from torch.profiler. Prints the card's
name and power limit beside the numbers.
"""

from __future__ import annotations

import ctypes
import subprocess

import chip_smoke as cs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_k16_layouts: no CUDA device")
    from eyoc_tpu_torch.registration import ransac
    from eyoc_tpu_torch.utils import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    warp_fn = kernels.load("probes/ransac_layouts", ransac._K16_TOPK_ARGS,
                           symbol="probe_topk_warp")
    cfg = ransac.RansacConfig()
    src, tgt, valid, _ = cs.correspondences(torch.Generator().manual_seed(0))
    u_tri, u_sub = ransac.ransac_draws(
        cfg, "cuda", torch.Generator(device="cuda").manual_seed(5))
    thr, lo, k = cfg.distance_threshold, cfg.edge_length_ratio, \
        cfg.full_verify_top
    args = (src, tgt, valid, u_tri, u_sub, thr, lo)

    def thread():
        return ransac.ransac_hypotheses_topk(*args, k)

    def warp():
        real = kernels.load
        kernels.load = lambda name, argtypes, symbol=None: (
            warp_fn if symbol == "ransac_hypotheses_topk"
            else real(name, argtypes, symbol))
        try:
            return ransac.ransac_hypotheses_topk(*args, k)
        finally:
            kernels.load = real

    def single_sort():
        trans, coarse = ransac.ransac_hypotheses(*args)
        keep = ransac.topk(coarse, k)[1]
        return trans[keep], coarse[keep], keep, coarse

    a, b = thread(), warp()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    ref = single_sort()
    same_ref = all(torch.equal(x, y) for x, y in zip(
        a, (ref[0], ref[1], ref[2].int(), ref[3])))
    survivors = int((a[3] >= 0).sum())
    print(f"card: {smi}")
    print(f"{survivors} of {u_tri.shape[0]} hypotheses survive the edge "
          f"check; warp layout the same bits as thread: {same}; thread the "
          f"same bits as single-stage + sort: {same_ref}")
    if not (same and same_ref):
        raise SystemExit("profile_k16_layouts: the layouts disagree")
    ms = {"thread": [], "warp": []}
    for name in ("thread", "warp", "warp", "thread"):
        ms[name].append(cs.time_ms(thread if name == "thread" else warp,
                                   reps=20))
    ms["single-stage + sort"] = [cs.time_ms(single_sort, reps=10)]
    for name, fn in (("thread", thread), ("warp", warp),
                     ("single-stage + sort", single_sort)):
        _, events, _, _ = cs.count_kernels(fn, reps=5)
        dev = sum(cs._dev_ms(e) for e in events) / 5
        split = ", ".join(f"{e.key[:40]} {cs._dev_ms(e) / 5:.4f}"
                          for e in sorted(events, key=lambda e: -cs._dev_ms(e)))
        print(f"{name}: {', '.join(f'{v:.4f}' for v in ms[name])} ms a call "
              f"(CUDA events), device {dev:.4f} ms ({split}) on {smi}")


if __name__ == "__main__":
    main()
