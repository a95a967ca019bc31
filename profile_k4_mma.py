#!/usr/bin/env python3
"""The tensor-core rate of one GPU for the operand types that kernel K4
(csrc/sc2_seed_counts.cu) could use, to choose between them and to give
K4's bound its b1 rate (NVIDIA publishes none for b1); and the `mma.sync`
tf32 rate and latency that kernel K8 (csrc/masked_knn2.cu, 3xTF32) runs
at, against the published TF32 peak (a `wgmma` one).

    python3 profile_k4_mma.py

Builds csrc/probes/mma_rate.cu (through `kernels.build`, nvcc, sm_90a)
and times, with CUDA events, launches in which every warp runs rounds of
8 independent `mma.sync` on register operands (b1 m16n8k256 AND + POPC,
s8 m16n8k32, f16 m16n8k16, tf32 m16n8k8; tf32 also as one chain of 8
dependent MMAs, whose time per MMA is the latency), then launches in
which every warpgroup runs
rounds of 4 `wgmma` on operands in shared memory (b1 m64n256k256 AND +
POPC, s8 m64n256k32). Prints MMAs per SM per microsecond and the dense
rate in ops/s (a b1 product counted as 2 ops, as an int8 one), beside the
card's name and power limit; the s8 `wgmma` rate is there to be read
against the published int8 peak. The last line gives the highest b1 rate
measured: `chip_smoke.py`'s PEAK["b1"]. K4's product needs S * N * N
binary products (1000 x 5000 x 5000 on the eval path): the line "K4
product at this rate" converts.
"""

from __future__ import annotations

import ctypes
import subprocess

from eyoc_tpu_torch.utils import kernels

# kind: (name, products per MMA, threads a block, MMAs per round and warp
# or warpgroup, block counts per SM)
SHAPES = {0: ("mma.sync b1 m16n8k256", 16 * 8 * 256, 128, 8, (2, 4, 8)),
          1: ("mma.sync s8 m16n8k32", 16 * 8 * 32, 128, 8, (2, 4, 8)),
          2: ("mma.sync f16 m16n8k16", 16 * 8 * 16, 128, 8, (2, 4, 8)),
          3: ("wgmma b1 m64n256k256", 64 * 256 * 256, 128, 4, (1, 2, 3)),
          4: ("wgmma s8 m64n256k32", 64 * 256 * 32, 128, 4, (1, 2, 3)),
          5: ("mma.sync tf32 m16n8k8", 16 * 8 * 8, 128, 8, (2, 4, 8)),
          6: ("mma.sync tf32 m16n8k8, one chain", 16 * 8 * 8, 128, 8,
              (2, 4, 8))}
WGMMA = (3, 4)
K4_PRODUCTS = 1000 * 5000 * 5000


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_k4_mma: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fn = kernels.load("probes/mma_rate", [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 3, symbol="mma_rate")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.arange(32, dtype=torch.int32, device="cuda") * 0x01010101
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card: {smi}, {sms} SMs")
    best_b1 = 0.0
    for kind, (name, macs, threads, per_round, per_sm) in SHAPES.items():
        for blocks_per_sm in per_sm:
            blocks = sms * blocks_per_sm
            iters = 1024 if kind in WGMMA else 4096

            def run():
                err = fn(kind, blocks, threads, iters, buf.data_ptr(),
                         sink.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"mma_rate {name}: cudaError {err}")
            run()
            torch.cuda.synchronize()
            ms = kernels_time(run)
            groups = blocks * threads // (128 if kind in WGMMA else 32)
            mmas = groups * per_round * iters
            rate = 2.0 * mmas * macs / (ms * 1e-3)
            if "b1" in name:
                best_b1 = max(best_b1, rate)
            k4 = 2.0 * K4_PRODUCTS / rate * 1e3
            print(f"{name:22s} {blocks_per_sm} blocks/SM: {ms:.3f} ms, "
                  f"{mmas / sms / (ms * 1e3):.1f} MMAs per SM per us, "
                  f"{rate / 1e12:.1f} T ops/s; K4 product at this rate "
                  f"{k4:.4f} ms")
    print(f"on {smi}")
    print(f"highest b1 rate: {best_b1:.4e} ops/s")


def kernels_time(fn, reps: int = 5) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


if __name__ == "__main__":
    main()
