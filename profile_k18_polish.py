#!/usr/bin/env python3
"""Where K18 `ransac_polish`'s time goes, on one GPU, at the eval path's
shape (N = 5000 correspondences at 30% inliers, `chip_smoke.
correspondences`; RANSAC's defaults: 5 rounds, threshold 0.3 m):

    python3 profile_k18_polish.py

Builds csrc/probes/polish_split.cu through `kernels.build` and reads, each
as the difference of two launches (1 and 1 + R units of work in one
dependent chain, CUDA events, the median of 20 launches) over R:

- solve: one `jacobi_pose` (csrc/jacobi_pose.cuh, the Jacobi Kabsch of
  K16-K18, K23 and K24) on one thread;
- solve, warp: one `jacobi_pose_warp` (the probe's: each rotation's
  element updates spread over the lanes of one warp, the same bits);
- chain, divisions / chain, reciprocals: the division and root chain of
  the 48 Givens rotations alone, the part of a solve that no spreading of
  the updates shortens: as `rotation()` runs it (three IEEE divisions a
  rotation) and with the quotients of 1 as IEEE reciprocals (the probe's
  `rotation_rcp`, the same bits);
- pass, global: a round's first pass as the parent's polish ran it (each
  thread's rows read from global memory, the 9-level shared-memory tree);
- pass, shared: the same pass as the port's polish runs it (the valid
  rows in shared memory, the xor-shuffle tree).

Checks that the two solves give the same bits, and the two chains, then
times `registration.ransac.ransac_polish` itself (CUDA events and the
profiler's device time) and sets it beside the model k x (2 passes + a
solve) + a pass (the polish solves on one thread; k the rounds before its
inliers stop changing, read from the kernel's own poses after 1 to 5
rounds: the round after them finds the fixed point and ends the kernel,
or the count pass follows round 5). Prints the card's name and power
limit beside the numbers.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import chip_smoke as cs

REPS = 64                   # units of work in the long launch
LAUNCHES = 20               # launches timed, each way; the median is kept


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_k18_polish: no CUDA device")
    from eyoc_tpu_torch.registration import ransac
    from eyoc_tpu_torch.utils import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    solve_fn = kernels.load("probes/polish_split", (P, I, I, P, P),
                            symbol="probe_solve")
    pass_fn = kernels.load("probes/polish_split",
                           (P, P, P, I, P, ctypes.c_float, I, I, P, P),
                           symbol="probe_pass")
    cfg = ransac.RansacConfig()
    thr = cfg.distance_threshold
    src, tgt, valid, T = cs.correspondences(torch.Generator().manual_seed(0))
    # the polish's first moments: the true pose's inliers, in f64
    d = (src @ T[:3, :3].T + T[:3, 3] - tgt).norm(dim=1)
    w = ((d < thr) & valid).double()
    cA = (w[:, None] * src.double()).sum(0) / w.sum()
    cB = (w[:, None] * tgt.double()).sum(0) / w.sum()
    H = ((src.double() - cA) * w[:, None]).T @ (tgt.double() - cB)
    solve_in = torch.cat([H.reshape(9), cA, cB]).float().contiguous()
    out = torch.empty(16, device="cuda")
    pose = T.float().contiguous()
    N = valid.shape[0]
    stream = kernels.stream_handle(torch.cuda.current_device())
    p = kernels.ptr

    solves = ("solve", "solve, warp", "chain, divisions",
              "chain, reciprocals")

    def launch(kind, reps):
        if kind in solves:
            err = solve_fn(p(solve_in), reps, solves.index(kind), p(out),
                           stream)
        else:
            err = pass_fn(p(src), p(tgt), p(valid), N, p(pose), thr, reps,
                          int(kind == "pass, shared"), p(out), stream)
        kernels.check_error(kind, err)

    def launch_ms(kind, reps):
        times = []
        for _ in range(LAUNCHES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(kind, reps)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    print(f"card: {smi}")
    unit_us = {}
    for kind in (*solves, "pass, global", "pass, shared"):
        launch(kind, 1)                     # builds and warms up
        torch.cuda.synchronize()
        one, many = launch_ms(kind, 1), launch_ms(kind, 1 + REPS)
        unit_us[kind] = (many - one) / REPS * 1e3
        print(f"{kind}: {unit_us[kind]:.3f} us a unit (launch of 1: "
              f"{one * 1e3:.2f} us, of {1 + REPS}: {many * 1e3:.2f} us; "
              f"median of {LAUNCHES}) on {smi}")
    # the same bits from both solves and both chains, the same sums from
    # both passes
    for a, b, n in (("solve", "solve, warp", 16),
                    ("chain, divisions", "chain, reciprocals", 2)):
        launch(a, 3)
        x = out[:n].clone()
        launch(b, 3)
        same = torch.equal(x.view(torch.int32), out[:n].view(torch.int32))
        print(f"{a} and {b}: the same bits: {same}")
        if not same:
            raise SystemExit(f"profile_k18_polish: {a} and {b} differ")
    launch("pass, global", 1)
    g = out[:7].clone()
    launch("pass, shared", 1)
    print(f"pass sums, global vs shared layout: inliers {float(g[0]):g} / "
          f"{float(out[0]):g}, largest difference "
          f"{float((g - out[:7]).abs().max()):.3g}")
    k18 = (pose[None].contiguous(), torch.zeros((), dtype=torch.int32,
                                                device="cuda"),
           src, tgt, valid, thr, cfg.polish_iters)
    ms = cs.time_ms(lambda: ransac.ransac_polish(*k18), reps=20)
    _, events, _, _ = cs.count_kernels(lambda: ransac.ransac_polish(*k18), 5)
    dev = sum(cs._dev_ms(e) for e in events) / 5
    it = cfg.polish_iters
    poses = [ransac.ransac_polish(*k18[:-1], k)[0] for k in range(it + 1)]
    k = next((k for k in range(1, it)
              if torch.equal(poses[k], poses[k + 1])), it)

    def model(k):
        return (k * (2 * unit_us["pass, shared"] + unit_us["solve"])
                + unit_us["pass, shared"]) / 1e3
    print(f"ransac_polish (N = {N}, {it} rounds): {ms:.4f} ms a call (CUDA "
          f"events), device {dev:.4f} ms; {k} rounds solve before the "
          f"inliers stop changing; the model {k} x (2 passes + a solve) + a "
          f"pass: {model(k):.4f} ms, of which the solves "
          f"{k * unit_us['solve'] / 1e3:.4f} ({it} rounds: {model(it):.4f} "
          f"ms) on {smi}")


if __name__ == "__main__":
    main()
