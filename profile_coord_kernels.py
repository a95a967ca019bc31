#!/usr/bin/env python3
"""Where K11 (`brick_pyramid`) and K12 (`conv_maps`) spend their device
time on one GPU, at the eval shape (one cloud of 131072 points,
`chip_smoke.make_pairs`) and the train shape (the 8 clouds of a batch
side, `chip_smoke.make_train_batch`):

    python3 profile_coord_kernels.py

- K11: each launch's device time (`skeleton`, `lookups`) at tiles of 256,
  512 (`bricks.K11_TILE`), 1024 and 2048 level-0 rows, each tile's output
  checked bit-equal to the plain version;
- K12: each launch's device time (`tables`, `maps`) without and with the
  inverses (and, at the eval shape, with the side-7 first map of FCGF's
  3DMatch model in place of the side-5 one, checked bit-equal to the
  plain version), and three ablations of csrc/conv_maps.cu's maps pass,
  built beside it into build/probes/ by text edits of the source (the
  neighbourhood staging cut, the entries cut, the stores cut; their
  outputs are wrong and unused): they split the maps pass into staging,
  entry reads and stores.

Device times from torch.profiler over 20 calls after one warm-up. Prints
the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import chip_smoke as cs

STORES = '''      if (vec && q + 4 <= n) {
        *reinterpret_cast<int4*>(out + q) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && q + j < n; ++j) out[q + j] = v[j];
      }'''


def ablations(src: str) -> dict:
    """{name: source} of the maps pass with one phase cut."""
    if STORES not in src or "  if (nbrs) {" not in src:
        raise SystemExit("profile_coord_kernels: conv_maps.cu changed; "
                         "update the ablations' edits")
    return {
        "no staging": src.replace("  if (nbrs) {", "  if (false) {").replace(
            "const bool up_item = ups &&", "const bool up_item = false &&"),
        "no entries": src.replace(
            "  for (int m = 0; m < g.n_maps; ++m) {\n    const Map& mp",
            "  for (int m = 0; m < 0; ++m) {\n    const Map& mp"),
        "no stores": src.replace(
            STORES, "      if ((v[0] ^ v[1] ^ v[2] ^ v[3]) == -12345) "
            "out[q] = 0;"),
    }


def device_us(fn, reps: int = 20) -> dict:
    """{kernel name: device us a call} over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t:
            name = re.search(r"::(\w+)", e.key)   # a kernel's own name
            out[name.group(1) if name else e.key] = round(t / reps, 2)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_coord_kernels: no CUDA device")
    from eyoc_tpu_torch.sparse import brick_conv, bricks
    from eyoc_tpu_torch.sparse import voxelize as vz
    from eyoc_tpu_torch.training.pipeline import brick_caps
    from eyoc_tpu_torch.utils import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; build {kernels.build_all():.1f} s", flush=True)
    out_dir = kernels.BUILD_DIR.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    src = (kernels.CSRC / "conv_maps.cu").read_text()
    for i, (name, text) in enumerate(ablations(src).items()):
        cu = out_dir / f"conv_maps_ablation{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
        libs[name] = ctypes.CDLL(str(so))
    real_load = kernels.load

    def load_from(lib):
        def load(name, argtypes, symbol=None):
            if name != "conv_maps":
                return real_load(name, argtypes, symbol)
            fn = getattr(lib, "eyoc_conv_maps")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        return load

    pair = cs.make_pairs()[0].to("cuda")
    batch = cs.make_train_batch().to("cuda")
    for what, xyz, n in (("eval", pair.xyz0, pair.n0),
                         ("train", batch.xyz0, batch.n0)):
        B = xyz.shape[0]
        vox, keys = vz.voxelize_batched(xyz, n, 0.3, cs.CAPS[0],
                                        cs.WINDOW_BITS)
        args = (keys, vox.mask.reshape(-1), B, brick_caps(cs.CAPS),
                cs.WINDOW_BITS)
        want = bricks.build_pyramid_plain(*args)
        tile = bricks.K11_TILE
        for t in (256, 512, 1024, 2048):
            bricks.K11_TILE = t
            diff = cs._differ(bricks.build_pyramid(*args), want)
            if diff:
                raise AssertionError(f"K11 at tiles of {t}: {diff} differ")
            us = device_us(lambda: bricks.build_pyramid(*args))
            print(f"{what} (B = {B}): K11 at tiles of {t} rows, bit-equal; "
                  f"device us a call {us}", flush=True)
        bricks.K11_TILE = tile
        pyr = bricks.build_pyramid(*args)
        for inverse in (False, True):
            def call():
                return brick_conv.conv_maps(pyr, 4, 5, inverse=inverse)
            print(f"{what} (B = {B}): K12 inverse {inverse}, device us a "
                  f"call {device_us(call)}", flush=True)
            for name, lib in libs.items():
                kernels.load = load_from(lib)
                try:
                    print(f"  {name}: {device_us(call)}", flush=True)
                finally:
                    kernels.load = real_load
        if what == "eval":
            def side7():
                return brick_conv.conv_maps(pyr, 4, 7)
            if cs._differ(side7(), brick_conv.conv_maps_staged_plain(
                    pyr, 4, 7)):
                raise AssertionError("K12 at side 7 differs from the plain "
                                     "version")
            print(f"{what} (B = {B}): K12 with the side-7 first map, "
                  f"bit-equal; device us a call {device_us(side7)}",
                  flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
