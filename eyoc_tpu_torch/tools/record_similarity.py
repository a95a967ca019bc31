"""Record feature-similarity-vs-range statistics and build distSimPlot tables
(counterpart of eyoc_tpu/tools/record_similarity.py).

The reference's `Similarity` spatial filter consumes lookup tables
(`config/dist_sim_plot/{dataset}_distSimPlot.npz`) mapping a
(min endpoint range, |Δrange|) grid cell — per frame-interval bucket — to
the expected feature cosine similarity of GT correspondences. The
recording half is the reference trainer's `plot_similarity`
instrumentation (`lib/trainer.py:914,1226-1239,1356-1358,1409-1410`),
which logs per-GT-correspondence `(range0, range1, cosine)` triples; the
offline binning that turns those logs into tables is not in the
reference tree. This module provides both halves:

- `dist_similarity_samples` — the triples on the card: the four row
  gathers are K6 `take_rows` (a row of zeros for an index out of range),
  the norms and the cosine plain torch.
- `build_similarity_tables` — host-side binning into the 6-bucket table
  stack (numpy, the JAX module's bits), using the exact lookup geometry
  of the filter (lib/trainer.py:1136-1147: x-grid 5 m on min-range,
  per-bucket y-grid {1, 1.5, 2, 2.5, 2.5, 2.5} m on |Δrange|,
  `map[d1, d0]` indexing).
- `save_similarity_tables` — writes the `{"res": [6 arrays]}` npz layout
  that `ops.matching.load_similarity_tables` reads back.
- `make_record_step` — a one-pair step: both clouds' eval features at the
  config's caps and window bits, the GT correspondences (one K2 launch at
  D = 3), then the triples.

CLI: `python -m eyoc_tpu_torch.tools.record_similarity --help` — runs a
trained checkpoint over a pair dataset on the card (`--device cpu`: the
plain versions on the host), logging triples and emitting the npz.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from eyoc_tpu_torch.ops.rows import take_rows, take_rows_plain

# |Δrange| grid size per frame-interval bucket (reference lib/trainer.py:1139)
YGRID = (1.0, 1.5, 2.0, 2.5, 2.5, 2.5)
XGRID = 5.0  # min-range grid size (reference gridsize[0])


def _samples(gather, xyz0, xyz1, f0, f1, idx0, idx1, valid):
    idx0 = idx0.to(torch.int32).contiguous()
    idx1 = idx1.to(torch.int32).contiguous()
    d0 = torch.linalg.norm(gather(xyz0.float().contiguous(), idx0), dim=-1)
    d1 = torch.linalg.norm(gather(xyz1.float().contiguous(), idx1), dim=-1)
    # engine features may be bf16; recorded statistics want f32 cosines
    g0 = gather(f0.contiguous(), idx0).float()
    g1 = gather(f1.contiguous(), idx1).float()
    dot = (g0 * g1).sum(-1)
    nrm = torch.linalg.norm(g0, dim=-1) * torch.linalg.norm(g1, dim=-1)
    cos = dot / torch.clamp(nrm, min=1e-12)
    return d0, d1, cos, valid


def dist_similarity_samples(xyz0, xyz1, f0, f1, idx0, idx1, valid):
    """Per-correspondence (range0, range1, cosine) triples.

    xyz*: [N, 3] cloud coordinates (LiDAR frame), f*: [N, D] features,
    idx0/idx1/valid: [M] correspondence indices + validity mask.
    Returns (d0 [M], d1 [M], cos [M], valid [M]) — the masked analog of the
    reference's 5000-sample log rows (lib/trainer.py:1228-1239). The
    values are meant only where `valid` holds: an index out of range reads
    a zero row (K6), where the JAX module's `jnp.take` fills NaN."""
    return _samples(take_rows, xyz0, xyz1, f0, f1, idx0, idx1, valid)


def dist_similarity_samples_plain(xyz0, xyz1, f0, f1, idx0, idx1, valid):
    """`dist_similarity_samples` with the plain row gather (on any
    device)."""
    return _samples(take_rows_plain, xyz0, xyz1, f0, f1, idx0, idx1, valid)


def build_similarity_tables(
    samples,
    min_count: int = 20,
    max_shape: tuple[int, int] = (64, 64),
):
    """Bin logged triples into the 6 per-bucket mean-cosine tables.

    `samples`: iterable of (frame_distance, d0, d1, cos) where d0/d1/cos are
    1-D arrays of equal length (host numpy). Cells with fewer than
    `min_count` samples get similarity 0 (the filter then drops them for
    any positive threshold — conservative, like an unobserved region).
    Returns a list of 6 float32 arrays shaped [y_bins, x_bins] with the
    filter's `map[Δrange_bin, minrange_bin]` indexing.
    """
    sums = [np.zeros(max_shape, np.float64) for _ in range(6)]
    counts = [np.zeros(max_shape, np.int64) for _ in range(6)]
    for frame_distance, d0, d1, cos in samples:
        b = int(np.clip(int(frame_distance) // 5, 0, 5))
        d0 = np.asarray(d0, np.float64)
        d1 = np.asarray(d1, np.float64)
        cos = np.asarray(cos, np.float64)
        mn = np.minimum(d0, d1)
        dd = np.abs(d0 - d1)
        col = np.clip((mn / XGRID).astype(np.int64), 0, max_shape[1] - 1)
        row = np.clip((dd / YGRID[b]).astype(np.int64), 0, max_shape[0] - 1)
        np.add.at(sums[b], (row, col), cos)
        np.add.at(counts[b], (row, col), 1)
    tables = []
    for b in range(6):
        with np.errstate(invalid="ignore"):
            t = np.where(counts[b] >= min_count, sums[b] / np.maximum(counts[b], 1), 0.0)
        # trim trailing all-empty rows/cols so table extents reflect the
        # observed range geometry (the shipped tables are ~(12-20, 16-18))
        occ = counts[b] >= min_count
        ys = int(occ.any(axis=1).cumsum().argmax()) + 1 if occ.any() else 1
        xs = int(occ.any(axis=0).cumsum().argmax()) + 1 if occ.any() else 1
        tables.append(t[:ys, :xs].astype(np.float32))
    return tables


def save_similarity_tables(path: str, tables) -> None:
    """Write the `{"res": [...]}` npz layout (reference lib/trainer.py:1130)."""
    res = np.empty(len(tables), dtype=object)
    for i, t in enumerate(tables):
        res[i] = np.asarray(t, np.float32)
    np.savez(path, res=res)


def make_record_step(cfg):
    """(model, batch) -> (d0, d1, cos, valid) for a 1-pair RawBatch on the
    batch's device: both clouds' eval features (preprocess_clouds, then
    `model.embed`) at `cfg`'s caps, voxel size and window bits (an
    EvalConfig, or any object with those fields), the GT correspondences
    on the device (`gt_positive_pairs`), the similarity triples of every
    voxel of cloud 0 (`dist_similarity_samples`)."""
    from eyoc_tpu_torch.training.pipeline import (gt_positive_pairs,
                                                  preprocess_clouds)

    @torch.no_grad()
    def step(model, batch):
        vox, feats = [], []
        for xyz, n in ((batch.xyz0, batch.n0), (batch.xyz1, batch.n1)):
            v, pyr = preprocess_clouds(xyz, n, caps=cfg.caps,
                                       voxel_size=cfg.voxel_size,
                                       window_bits=cfg.window_bits)
            vox.append(v)
            feats.append(model.embed(pyr))
        i0, i1, ok = gt_positive_pairs(vox[0], vox[1], batch.T_gt,
                                       batch.search_radius)
        cap = vox[0].xyz.shape[1]
        f0, f1 = (f.reshape(-1, f.shape[-1])[:cap] for f in feats)
        return dist_similarity_samples(
            vox[0].xyz[0], vox[1].xyz[0], f0, f1, i0[0], i1[0], ok[0])

    return step


def main(argv=None, config_overrides=None):
    """The JAX tool's flags, and --device (default: the card);
    `config_overrides` (a dict) sets config fields that have no flag here,
    such as the capacities and window bits.
    Returns (the tables, each pair's step seconds on the host clock: the
    batch's copy to the device until its triples are on the host)."""
    import argparse

    p = argparse.ArgumentParser(
        description="Record GT-correspondence similarity stats over a pair "
        "dataset with a trained checkpoint and build distSimPlot tables.")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint path base (no extension)")
    p.add_argument("--dataset", default="KittiNFramePairDataset")
    p.add_argument("--kitti_root", default="")
    p.add_argument("--out", required=True, help="output npz path")
    p.add_argument("--model", default="ResUNetBN2C")
    p.add_argument("--voxel_size", type=float, default=0.3)
    p.add_argument("--pair_min_dist", type=int, default=1)
    p.add_argument("--pair_max_dist", type=int, default=30)
    p.add_argument("--max_pairs", type=int, default=2000)
    p.add_argument("--min_count", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA device; 'cpu' "
                        "runs the plain versions)")
    args = p.parse_args(argv)

    from eyoc_tpu_torch.config import get_config
    from eyoc_tpu_torch.data.loader import make_data_loader
    from eyoc_tpu_torch.models import init_unet, load_model
    from eyoc_tpu_torch.training import checkpoint as ckpt
    from eyoc_tpu_torch.training.trainer import build_step_config
    from eyoc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    config = get_config([])
    config.dataset = args.dataset
    config.model = args.model
    for k in ("voxel_size", "pair_min_dist", "pair_max_dist", "kitti_root"):
        setattr(config, k, getattr(args, k))
    config.update(config_overrides or {})
    config.supervised = True  # GT-pose correspondence mode
    spec = load_model(config.model)
    model = init_unet(spec, torch.Generator().manual_seed(0), 1,
                      config.model_n_out, config.conv1_kernel_size,
                      device=dev)
    ckpt.load_weights_only(args.checkpoint, model)
    loader = make_data_loader(config, "train", 1, shuffle=False, device=dev)
    _, cfg = build_step_config(config, spec)
    step = make_record_step(cfg)

    logs, secs = [], []
    for i, batch in enumerate(loader):
        if i >= args.max_pairs:
            break
        t0 = time.perf_counter()
        d0, d1, cos, v = (x.cpu().numpy() for x in step(model, batch.to(dev)))
        secs.append(time.perf_counter() - t0)
        logs.append((int(batch.frame_distance[0]), d0[v], d1[v], cos[v]))
    tables = build_similarity_tables(logs, min_count=args.min_count)
    save_similarity_tables(args.out, tables)
    print(f"wrote {args.out}: shapes {[t.shape for t in tables]}")
    return tables, secs


if __name__ == "__main__":
    main()
