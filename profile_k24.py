#!/usr/bin/env python3
"""K24's device time, and that of the kernels that share its Jacobi solve,
for this tree of the port or another one, so that two trees are compared
in one chip call.

    python3 profile_k24.py [--root DIR] [--tag NAME]

--root: the directory whose `eyoc_tpu_torch` is imported (default: this
script's); a parent commit unpacked with `git archive` into a git-ignored
directory (build/parent) is measured by the same code. Run the trees in
turn, parent, change, change, parent, in one call: a card's power limit
and clocks differ between machines.

On chip_smoke.py's inputs (generators of their own, as phase 2 draws them)
it times, each as the device time (torch.profiler, chip_smoke's
`device_ms`), the CUDA-event time, the host's microseconds a call and the
device kernels a call with each kernel's device time (profile_k19_k23's
`time_call`):
- K24 `sc2_irls_jacobi` and K15 `sc2_irls` at the eval shape (B = 1, N =
  5000), the labeling shape (B = 8, N = 8000, synthetic), the eval shape
  at refine_unroll 4 and on the 8 problems of one recorded labeling
  (chip_smoke's `record_extension_steps`, the kernels line's `_label`
  row; 10-123 valid rows a problem); where the tree has their cluster
  form, each at clusters of 2, 4, 8 and 16 CTAs as well, with the rounds
  checked against the plain IRLS's;
- the round split from the device clock (cycles of thread 0 of the first
  problem's first CTA, the mean over the rounds): the cluster form's
  stamped entry where the tree has it (pass 1, its CTA sums and pushes,
  its cluster barrier and sums, pass 2, the same, the solve and the block
  barrier), and where the tree has the single-block form (the parent's K15
  and K24) by a copy of its sc2_refine.cu with clock64() stamps put in by
  text (`single_block_split`: pass 1, its tree, pass 2, its tree, the
  solve);
- one `jacobi_pose` alone and the division and root chain of its 48
  rotations (csrc/probes/polish_split.cu, as profile_k18_polish.py reads
  them: the difference of launches of 1 and 1 + 64 solves, over 64);
- the rows that share the solve: K23 `sc2_seed_transforms_jacobi` at both
  shapes (its `head_poses` kernel), K16 `ransac_hypotheses_topk` (its
  `solve_count`), K18 `ransac_polish` and `icp_solve`, on chip_smoke's
  `jacobi_user_calls`, with sha1 digests of their outputs, which two trees
  must share where the solve keeps its bits.
Prints the card's name and power limit, then one JSON line (also appended
to build/profile_k24_<tag>.json).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import chip_smoke as cs
from profile_k19_k23 import time_call

CLUSTERS = (2, 4, 8, 16)
SOLVE_REPS = 64             # solves in the long launch of the solve probe


def irls_args(cfg, shape):
    """sc2_irls's arguments at a shape (chip_smoke's Jacobi sets), from
    the kernels before it."""
    make = {"eval": cs.jacobi_eval_set, "label": cs.jacobi_label_set}[shape]
    (args, _), = cs.sc2_calls(*make(), cfg)["sc2_irls"]
    return args


def configs(SC2PCRConfig):
    """(row name, config, shape) of K24's and K15's rows."""
    e_cfg = SC2PCRConfig(max_points=cs.N_CORR, seed_cap=cs.N_SEEDS)
    l_cfg = cs.ext_config().sc2
    return (("eval", e_cfg, "eval"), ("label", l_cfg, "label"),
            (f"unroll {cs.UNROLL}",
             dataclasses.replace(e_cfg, refine_unroll=cs.UNROLL), "eval"))


def recorded_args():
    """sc2_irls's arguments on the 8 SC2-PCR problems of one recorded
    labeling (chip_smoke's extension step at the published recipe)."""
    from eyoc_tpu_torch.models import load_model
    from eyoc_tpu_torch.ops.matching import load_similarity_tables
    calls = cs.record_extension_steps(
        load_model("ResUNetBN2C"), cs.make_train_batch().to("cuda"),
        load_similarity_tables("waymo").to("cuda"))
    (args, _), = calls["sc2_irls"]
    return args


def irls_rows(sc2pcr, SC2PCRConfig):
    """K24's and K15's rows; with the cluster form, at each cluster size
    too, against the plain IRLS (the rounds equal)."""
    rows = {}
    cluster = hasattr(sc2pcr, "K24_CLUSTER")
    recorded = recorded_args()
    cases = [(name, cfg, shape) for name, cfg, shape in
             configs(SC2PCRConfig)] + [("recorded label", recorded[0], None)]
    for name, cfg, shape in cases:
        for qcp in (False, True):
            c = dataclasses.replace(cfg, qcp_kabsch=qcp)
            args = (irls_args(c, shape) if shape else
                    (c,) + tuple(recorded[1:]))
            k = "K15" if qcp else "K24"
            rows[f"{k} {name}"] = time_call(sc2pcr.sc2_irls, args)
            if not cluster:
                continue
            _, it_p = sc2pcr.sc2_irls_plain(*args)
            knob = f"{k}_CLUSTER"
            default = getattr(sc2pcr, knob)
            for C in CLUSTERS:
                setattr(sc2pcr, knob, C)
                row = time_call(sc2pcr.sc2_irls, args)
                row["rounds_equal_plain"] = bool(
                    (sc2pcr.sc2_irls(*args)[1].cpu() == it_p.cpu()).all())
                rows[f"{k} {name} cluster {C}"] = row
            setattr(sc2pcr, knob, default)
    return rows


def cluster_split(sc2pcr, kernels, SC2PCRConfig):
    """The cluster form's round at the eval shape from its stamped entry:
    mean cycles of each part over the rounds, and a round's."""
    import torch
    cfg = dataclasses.replace(configs(SC2PCRConfig)[0][1], qcp_kabsch=False)
    _, trans, best, src, tgt, valid = irls_args(cfg, "eval")
    fn = kernels.load("sc2_refine", sc2pcr._K15_ARGS[:-1] + (
        ctypes.c_void_p, ctypes.c_void_p), symbol="sc2_irls_jacobi_stamped")
    B, N = valid.shape
    rounds = 20
    stamps = torch.zeros((rounds, 8), dtype=torch.int64, device="cuda")
    out = torch.empty((B, 4, 4), device="cuda")
    it = torch.empty(B, dtype=torch.int32, device="cuda")
    p = kernels.ptr
    for _ in range(3):
        kernels.check_error("sc2_irls_jacobi_stamped", fn(
            p(trans), p(best), p(src), p(tgt), p(valid), B, N,
            trans.shape[1], sc2pcr._irls_threshold(cfg), rounds, 0,
            sc2pcr.K24_CLUSTER, None, p(out), p(it), p(stamps),
            kernels.stream_handle(0)))
        torch.cuda.synchronize()
    n = int(it[0])
    s = stamps[:n].cpu().double()
    step = s[:, 1:] - s[:, :-1]
    names = ("pass1", "cta_sums1", "cluster1", "pass2", "cta_sums2",
             "cluster2", "solve")
    split = {k: float(step[:, i].mean()) for i, k in enumerate(names)}
    split["round"] = float((s[:, 7] - s[:, 0]).mean())
    split["rounds"] = n
    return split


# the single-block irls's round, stamped by text: (marker, stamp index,
# after the marker)
MARKS = (("    for (int k = 0; k < 16; ++k) T[k] = pose[k];\n", 0, True),
         ("    block_sums(s1, part1);\n", 1, False),
         ("    block_sums(s1, part1);\n", 2, True),
         ("    block_sums(s2, part2);\n", 3, False),
         ("    block_sums(s2, part2);\n", 4, True),
         ("    prev = cur;\n    cur = count;\n", 5, False))


def single_block_split(sc2pcr, SC2PCRConfig):
    """The single-block irls's round (the parent's K15 and K24) at the eval
    shape: a copy of the tree's sc2_refine.cu with thread 0 of problem 0
    writing clock64() into a __device__ array at MARKS in the `irls`
    kernel, built by nvcc beside the tree's other builds; mean cycles of
    pass 1, its tree, pass 2, its tree and the solve (with its barrier)
    over 4 rounds (refine_unroll 4), and a round's. None where the tree's
    irls is the cluster form."""
    import torch
    from eyoc_tpu_torch.utils import kernels
    text = (kernels.CSRC / "sc2_refine.cu").read_text()
    if "block_sums(s1, part1);" not in text:
        return None
    lo = text.index("__launch_bounds__(kIrlsThreads) irls(")
    hi = text.index("\n}\n", lo) + 3
    body = text[lo:hi]
    for mark, k, after in MARKS:
        if body.count(mark) != 1:
            raise RuntimeError(f"single_block_split: {mark!r} is not in "
                               "the irls kernel once")
        st = (f"    if (t == 0 && b == 0 && it < 64) g_stamps[6 * it + {k}]"
              " = clock64();\n")
        body = body.replace(mark, mark + st if after else st + mark)
    text = text[:lo] + body + text[hi:]
    text = text.replace('#include "jacobi_pose.cuh"\n',
                        '#include "jacobi_pose.cuh"\n'
                        "__device__ long long g_stamps[6 * 64];\n")
    text += ('\nextern "C" int eyoc_probe_stamps(long long* out) {\n'
             "  return cudaMemcpyFromSymbol(out, g_stamps, "
             "sizeof(g_stamps));\n}\n")
    out_dir = kernels.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "sc2_refine_stamped.cu"
    src.write_text(text)
    lib_path = out_dir / "libsc2_refine_stamped.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                           str(kernels.CSRC), "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    cfg = configs(SC2PCRConfig)[0][1]
    out = {}
    for qcp in (False, True):
        entry = "eyoc_sc2_irls" + ("" if qcp else "_jacobi")
        c = dataclasses.replace(cfg, qcp_kabsch=qcp, refine_unroll=4)
        _, trans, best, src_, tgt, valid = irls_args(c, "eval")
        fn = getattr(lib, entry)
        fn.argtypes = list(sc2pcr._K15_ARGS)
        fn.restype = ctypes.c_int
        B, N = valid.shape
        o = torch.empty((B, 4, 4), device="cuda")
        it = torch.empty(B, dtype=torch.int32, device="cuda")
        p = kernels.ptr
        for _ in range(3):
            kernels.check_error(entry, fn(
                p(trans), p(best), p(src_), p(tgt), p(valid), B, N,
                trans.shape[1], sc2pcr._irls_threshold(c), 20, 4, None,
                p(o), p(it), kernels.stream_handle(0)))
            torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (6 * 64))()
        kernels.check_error("probe_stamps", lib.eyoc_probe_stamps(buf))
        s = torch.tensor(list(buf), dtype=torch.float64).view(64, 6)[:4]
        step = s[:, 1:] - s[:, :-1]
        names = ("pass1", "tree1", "pass2", "tree2", "solve")
        row = {k: float(step[:, i].mean()) for i, k in enumerate(names)}
        row["round"] = float((s[1:, 0] - s[:-1, 0]).mean())
        out["K15" if qcp else "K24"] = row
    return out


def solve_alone(kernels):
    """One jacobi_pose and the division and root chain of its rotations,
    in microseconds (csrc/probes/polish_split.cu's probe_solve: kinds 0 and
    2, the median of 20 launches each of 1 and 1 + SOLVE_REPS units)."""
    import torch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = kernels.load("probes/polish_split", (P, I, I, P, P),
                      symbol="probe_solve")
    src, tgt, valid, T = cs.correspondences(torch.Generator().manual_seed(0))
    d = (src @ T[:3, :3].T + T[:3, 3] - tgt).norm(dim=1)
    w = ((d < 0.3) & valid).double()
    cA = (w[:, None] * src.double()).sum(0) / w.sum()
    cB = (w[:, None] * tgt.double()).sum(0) / w.sum()
    H = ((src.double() - cA) * w[:, None]).T @ (tgt.double() - cB)
    x = torch.cat([H.reshape(9), cA, cB]).float().contiguous()
    out = torch.empty(16, device="cuda")
    stream = kernels.stream_handle(0)

    def ms(kind, reps):
        times = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            kernels.check_error("probe_solve", fn(x.data_ptr(), reps, kind,
                                                  out.data_ptr(), stream))
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)
    res = {}
    for name, kind in (("solve_us", 0), ("chain_us", 2)):
        ms(kind, 1)
        res[name] = (ms(kind, 1 + SOLVE_REPS) - ms(kind, 1)) / SOLVE_REPS \
            * 1e3
    return res


def shared_rows(sc2pcr, SC2PCRConfig):
    """K23 at both shapes and the ransac.cu users of the solve: times and
    digests."""
    rows, digests = {}, {}
    e_cfg = SC2PCRConfig(max_points=cs.N_CORR, seed_cap=cs.N_SEEDS,
                         qcp_kabsch=False)
    l_cfg = dataclasses.replace(cs.ext_config().sc2, qcp_kabsch=False)
    for shape, make, cfg in (("eval", cs.jacobi_eval_set, e_cfg),
                             ("label", cs.jacobi_label_set, l_cfg)):
        (args, _), = cs.sc2_calls(*make(), cfg)["sc2_seed_transforms"]
        digests[f"K23 {shape}"] = cs.sc2_digest(
            sc2pcr.sc2_seed_transforms(*args))
        rows[f"K23 {shape}"] = time_call(sc2pcr.sc2_seed_transforms, args)
    calls = cs.jacobi_user_calls()
    digests.update(cs.jacobi_digests(calls))
    for name, (fn, args) in calls.items():
        rows[name] = time_call(fn, args)
    return rows, digests


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import eyoc_tpu_torch
    from eyoc_tpu_torch.registration import sc2pcr
    from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
    from eyoc_tpu_torch.utils import kernels
    if not torch.cuda.is_available():
        raise SystemExit("profile_k24: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    out = dict(tag=args.tag, root=os.path.dirname(eyoc_tpu_torch.__file__),
               card=smi, key=cs.k23_digest_key())
    out["rows"] = irls_rows(sc2pcr, SC2PCRConfig)
    out["cluster_round_cycles"] = (cluster_split(sc2pcr, kernels,
                                                 SC2PCRConfig)
                                   if hasattr(sc2pcr, "K24_CLUSTER")
                                   else None)
    out["single_block_round_cycles"] = single_block_split(sc2pcr,
                                                          SC2PCRConfig)
    out["solve"] = solve_alone(kernels)
    shared, out["digests"] = shared_rows(sc2pcr, SC2PCRConfig)
    out["rows"].update(shared)
    print(smi)
    line = json.dumps(out)
    os.makedirs("build", exist_ok=True)
    with open(f"build/profile_k24_{args.tag}.json", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
