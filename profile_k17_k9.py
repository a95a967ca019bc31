#!/usr/bin/env python3
"""Where the time of K17 `ransac_verify` and K9 `masked_argmin_excl` goes,
on one GPU: each kernel's source is built again in cut-down variants (a
text substitution each, into build/profile_k17_k9/) that stop at a phase
or drop a part of the work, and every variant is timed by torch.profiler
(chip_smoke.py's `device_ms`) at the main path's shapes beside the kernel
itself.

    python3 profile_k17_k9.py [--reps N]

K17 at 2048 kept poses (K16's top 2048 of the default RansacConfig) x
5000 correspondences, all valid (chip_smoke.py's `correspondences`):
- `launch`: every block returns at once (the launch alone);
- `prologue`: stops after the loads, the compaction and the poses'
  staging;
- `rows`: stops after the tests (no sums, tickets or argmax);
- `no tests`: the whole kernel with each test cut to one compare.

K9 at the gated step's 8192 anchors x 2048 candidates x 32 (unit features,
coordinates uniform in a 40 m box, r = 1.5 m):
- `anchors`: stops once the anchors are in registers (the launch, the
  first window's copies issued, the anchors' loads);
- `windows`: stops after the sweep (no merge of the splits);
- `no sweep`: the whole kernel without the products and the minima;
- `products only`: the sweep's products (each tile's 3xTF32 MMAs) and
  nothing of its epilogue;
- `no minima`: the products and the distances with their vote, but no
  candidate taken;
- `no exclusion`: every winning candidate taken without its test;
- `no threshold`: without the quad's shared minimum.

A variant's output is not the kernel's: only the kernel itself is held to
its plain version here (chip_smoke.py checks both fully). Prints the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np

import chip_smoke as cs

OUT = Path(__file__).resolve().parent / "build" / "profile_k17_k9"

K17_VARIANTS = {
    "launch": [("  int* gbest = sums + Hk;\n",
                "  int* gbest = sums + Hk;\n  if (N >= 0) return;\n")],
    "prologue": [("  // slots t, t + T, ...: their poses in registers\n",
                  "  if (N >= 0) return;\n")],
    "rows": [("  // the group's counts, added over the splits behind the "
              "group's ticket\n",
              "  if (c[0] != -12345) {\n    if (t == 0) counts[h0] = c[0] + "
              "c[1];\n    return;\n  }\n")],
    "no tests": [("c[k] += residual2(T[k], p.x, p.y, p.z, p.w, q.x, q.y) "
                  "< thr2;", "c[k] += p.x < thr2;")],
}
K9_VARIANTS = {
    "anchors": [("  if (rows > 0) load_a_rows(q, q0, nv, ah, al, qn);\n",
                 "  if (rows > 0) load_a_rows(q, q0, nv, ah, al, qn);\n"
                 "  if (qn[0][0] != 12345.f) {\n    if (tid == 0) out_i[q0] = "
                 "(int)qn[0][0];\n    return;\n  }\n")],
    "windows": [("  // the four lanes of a row merge their minima under "
                 "(distance, index)\n",
                 "  if (bd[0][0] != 12345.f) {\n    if (tid == 0) out_i[q0] = "
                 "bi[0][0] + (int)bd[0][0];\n    return;\n  }\n")],
    "no sweep": [("    if (rows > 16)\n      sweep_excl<2>",
                  "    if (rows > 1000)\n      sweep_excl<2>"),
                 ("    else if (rows > 0)\n      sweep_excl<1>",
                  "    else if (rows > 1000)\n      sweep_excl<1>")],
    "products only": [("    tile_dot<MT>(sm.k8, nt, ah, al, acc);\n",
                       "    tile_dot<MT>(sm.k8, nt, ah, al, acc);\n"
                       "    if (nt >= 0) {\n      bd[0][0] = fminf(bd[0][0], "
                       "acc[0][0] + acc[MT - 1][3]);\n      continue;\n"
                       "    }\n")],
    "no minima": [("    if (__any_sync(0xffffffffu, any)) {\n"
                   "      const float4 c0",
                   "    if (__any_sync(0xffffffffu, any && acc[0][0] == "
                   "12345.f)) {\n      const float4 c0")],
    "no exclusion": [("if (d < bd && !excluded(*p, c, r2)) {",
                      "if (d < bd) {")],
    "no threshold": [("  return d < bd && d <= th;", "  return d < bd;")],
}


def variant(name: str, subs):
    """The kernel source `name` with `subs` applied, built by nvcc (the
    package's flags) into OUT; returns the loaded library."""
    from eyoc_tpu_torch.utils import kernels
    text = (kernels.CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"profile_k17_k9: {name}.cu has no {old!r}")
        text = text.replace(old, new)
    tag = hashlib.sha1(text.encode()).hexdigest()[:12]
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}-{tag}.cu", OUT / f"lib{name}-{tag}.so"
    if not so.exists():
        cu.write_text(text)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                               str(kernels.CSRC), "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for a {name} variant:\n"
                             f"{proc.stderr}")
    return ctypes.CDLL(str(so))


def bind(lib, symbol: str, argtypes):
    fn = getattr(lib, f"eyoc_{symbol}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def timed(label, symbol, lib, argtypes, call, reps):
    """Device ms a call of `call` with the wrapper's entry `symbol` bound to
    `lib` (the loaded entry is put back after)."""
    from eyoc_tpu_torch.utils import kernels
    saved = kernels._fns.get(symbol)
    kernels._fns[symbol] = bind(lib, symbol, argtypes)
    try:
        ms = cs.device_ms([call], reps)
    finally:
        kernels._fns[symbol] = saved
    print(f"  {label}: {ms:.4f} ms device a call", flush=True)
    return ms


def main() -> None:
    import torch
    from eyoc_tpu_torch.ops import knn
    from eyoc_tpu_torch.registration import ransac
    from eyoc_tpu_torch.utils import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k17_k9: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()

    cfg = ransac.RansacConfig()
    src, tgt, valid, _ = cs.correspondences(torch.Generator().manual_seed(0))
    draws = ransac.ransac_draws(
        cfg, "cuda", torch.Generator(device="cuda").manual_seed(5))
    thr = cfg.distance_threshold
    trans, coarse, _, _ = ransac.ransac_hypotheses_topk(
        src, tgt, valid, *draws, thr, cfg.edge_length_ratio,
        cfg.full_verify_top)
    k17 = (trans, coarse, None, src, tgt, valid, thr)
    got, want = ransac.ransac_verify(*k17), ransac.ransac_verify_plain(*k17)
    if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
        raise SystemExit("K17 disagrees with its plain version")
    print(f"K17 ransac_verify, {trans.shape[0]} x {src.shape[0]}:")
    ms = cs.device_ms([lambda: ransac.ransac_verify(*k17)], args.reps)
    print(f"  the kernel: {ms:.4f} ms device a call", flush=True)
    for name, subs in K17_VARIANTS.items():
        timed(name, "ransac_verify", variant("ransac", subs),
              ransac._K17_ARGS, lambda: ransac.ransac_verify(*k17),
              args.reps)

    rng = np.random.default_rng(0)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    P, M = 8192, 2048
    a, c = (torch.from_numpy(unit(n, 32)).cuda() for n in (P, M))
    px, cx = (torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(
        np.float32)).cuda() for n in (P, M))
    k9 = (a, c, px, cx, 1.5 * 1.5)
    ok, _ = cs._excl_close(knn.masked_argmin_excl(*k9),
                           knn.masked_argmin_excl_plain(*k9), *k9)
    if not ok:
        raise SystemExit("K9 disagrees with its plain version")
    print(f"K9 masked_argmin_excl, {P} x {M} x 32:")
    ms = cs.device_ms([lambda: knn.masked_argmin_excl(*k9)], args.reps)
    print(f"  the kernel: {ms:.4f} ms device a call", flush=True)
    for name, subs in K9_VARIANTS.items():
        timed(name, "masked_argmin_excl", variant("masked_knn2", subs),
              knn._K9_ARGS, lambda: knn.masked_argmin_excl(*k9), args.reps)
    print(f"on {smi}")


if __name__ == "__main__":
    main()
