"""Correspondence generation and filtering, the front half of the labeling
(counterpart of eyoc_tpu/ops/matching.py).

For each pair: bidirectional feature kNN, K = 2 (Lowe) or K = 1
(feature_filter="None"); ratio-test weights; the top `num_corres` matches
per direction by weight, concatenated; a spatial filter on the matched
endpoints' ranges (Spherical, Similarity or None); compaction of the kept
matches. Every function takes a batch of B pairs on a leading axis (the
JAX package's functions take one pair and run under `lax.map`):
`mutual_topk_matches` runs the kNN of both directions of every pair in one
call of `masked_knn_batched`, one kernel launch (K2 or K8) for 2B problems.

Top-k ties go to the lowest index, as `lax.top_k` (the stable sort of
registration/sc2pcr.py:topk).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from eyoc_tpu_torch.ops.knn import masked_knn_batched
from eyoc_tpu_torch.registration.sc2pcr import topk

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")
_NEG = -1e30        # the weight of a match from an invalid row


class SimilarityTables(NamedTuple):
    """The 6 frame-bucket similarity maps, zero-padded to one stack."""

    maps: torch.Tensor    # [6, X, Y] f32
    xlims: torch.Tensor   # [6] int64, valid extent of the |d range| axis
    ylims: torch.Tensor   # [6] int64, valid extent of the min-range axis
    ygrid: torch.Tensor   # [6] f32, grid size of the |d range| axis

    def to(self, device) -> "SimilarityTables":
        return SimilarityTables(*(t.to(device) for t in self))


def load_similarity_tables(dataset: str) -> SimilarityTables:
    """The port's copy of `{dataset}_distSimPlot.npz` (kitti or waymo; the
    reference's config/dist_sim_plot), on the CPU."""
    path = os.path.join(_ASSET_DIR, f"{dataset}_distSimPlot.npz")
    raw = np.load(path, allow_pickle=True)["res"].tolist()
    tables = [np.asarray(raw[i], np.float32) for i in range(6)]
    X = max(t.shape[0] for t in tables)
    Y = max(t.shape[1] for t in tables)
    maps = np.zeros((6, X, Y), np.float32)
    for i, t in enumerate(tables):
        maps[i, :t.shape[0], :t.shape[1]] = t
    # frame bucket -> |d range| grid size (reference lib/trainer.py:1139)
    ygrid = np.asarray([1.0, 1.5, 2.0, 2.5, 2.5, 2.5], np.float32)
    return SimilarityTables(
        torch.from_numpy(maps),
        torch.tensor([t.shape[0] for t in tables], dtype=torch.int64),
        torch.tensor([t.shape[1] for t in tables], dtype=torch.int64),
        torch.from_numpy(ygrid))


def ratio_test_weights(d2: torch.Tensor) -> torch.Tensor:
    """Lowe ratio weights from squared feature distances [..., 2] -> [...]:
    1 - max(d2_1 / 2, 1e-9) / max(d2_2 / 2, 1e-9) (unit features, cosine
    = 1 - d2 / 2; reference lib/trainer.py:993-1010)."""
    dists = torch.clamp(0.5 * d2, min=1e-9)
    return 1.0 - dists[..., 0] / dists[..., 1]


def mutual_topk_matches(F0, mask0, F1, mask1, *, num_corres: int = 5000,
                        feature_filter: str = "Lowe"):
    """Bidirectional feature matching with top-k selection, for B pairs.

    F0 [B, N0, C], F1 [B, N1, C] f32, masks [B, N0] / [B, N1]. Returns
    (idx0, idx1 [B, 2k] int32, weight [B, 2k] f32, valid [B, 2k] bool),
    k = min(num_corres, N0, N1): the first half cloud 0 -> 1, the second
    cloud 1 -> 0. With feature_filter "None" the weights are the raw
    squared distances and the k largest are kept, as the reference does
    (lib/trainer.py:1074-1076, 1012-1016)."""
    B = F0.shape[0]
    k = min(num_corres, F0.shape[1], F1.shape[1])
    K = 2 if feature_filter == "Lowe" else 1
    F0, F1 = F0.float().contiguous(), F1.float().contiguous()
    if F0.shape == F1.shape:        # both directions in one launch
        d2, nn = masked_knn_batched(torch.cat([F0, F1]),
                                    torch.cat([mask0, mask1]),
                                    torch.cat([F1, F0]),
                                    torch.cat([mask1, mask0]), K)
        d2_01, d2_10, nn_01, nn_10 = d2[:B], d2[B:], nn[:B], nn[B:]
    else:
        d2_01, nn_01 = masked_knn_batched(F0, mask0, F1, mask1, K)
        d2_10, nn_10 = masked_knn_batched(F1, mask1, F0, mask0, K)
    if feature_filter == "Lowe":
        w_01, w_10 = ratio_test_weights(d2_01), ratio_test_weights(d2_10)
    else:
        w_01, w_10 = d2_01[..., 0], d2_10[..., 0]
    w_01 = torch.where(mask0, w_01, torch.full_like(w_01, _NEG))
    w_10 = torch.where(mask1, w_10, torch.full_like(w_10, _NEG))
    w0_top, src0 = topk(w_01, k)
    w1_top, src1 = topk(w_10, k)
    tgt0 = torch.gather(nn_01[..., 0], 1, src0)
    tgt1 = torch.gather(nn_10[..., 0], 1, src1)
    idx0 = torch.cat([src0.to(torch.int32), tgt1], 1)
    idx1 = torch.cat([tgt0, src1.to(torch.int32)], 1)
    weight = torch.cat([w0_top, w1_top], 1)
    return idx0, idx1, weight, weight > _NEG


def _range(xyz: torch.Tensor) -> torch.Tensor:
    """|xyz| over the last axis as sqrt(sum(x * x)) (jnp.linalg.norm)."""
    return torch.sqrt(torch.sum(xyz * xyz, -1))


def spatial_filter_mask(xyz0_corr, xyz1_corr, *,
                        spatial_filter: str = "Spherical",
                        radius: float = 20.0,
                        similarity: SimilarityTables | None = None,
                        similarity_thresh: float = 0.4,
                        frame_distance: torch.Tensor | None = None):
    """Per-match keep mask [B, M] from the matched endpoints' ranges
    xyz*_corr [B, M, 3] (LiDAR frame; reference lib/trainer.py:1110-1147).

    Spherical: both ranges beyond `radius`. Similarity: the table of the
    pair's frame bucket clip(frame_distance // 5, 0, 5) at row |r0 - r1| /
    ygrid (clipped to the table's xlim) and column min(r0, r1) / 5 m
    (clipped to its ylim), above `similarity_thresh`; frame_distance [B]."""
    if spatial_filter == "None":
        return torch.ones(xyz0_corr.shape[:-1], dtype=torch.bool,
                          device=xyz0_corr.device)
    r0, r1 = _range(xyz0_corr), _range(xyz1_corr)
    if spatial_filter == "Spherical":
        return (r0 > radius) & (r1 > radius)
    if spatial_filter == "Similarity":
        if similarity is None or frame_distance is None:
            raise ValueError("Similarity needs the tables and the frame "
                             "distance")
        d1 = torch.abs(r0 - r1)
        d0 = torch.minimum(r0, r1)
        bucket = torch.clamp(torch.div(frame_distance, 5,
                                       rounding_mode="floor"), 0, 5).long()
        xlim = similarity.xlims[bucket][:, None]
        ylim = similarity.ylims[bucket][:, None]
        gy = similarity.ygrid[bucket][:, None]
        i0 = torch.clamp((d0 / 5.0).to(torch.int32), min=0)
        i0 = torch.minimum(i0.long(), ylim - 1)
        i1 = torch.clamp((d1 / gy).to(torch.int32), min=0)
        i1 = torch.minimum(i1.long(), xlim - 1)
        vals = similarity.maps[bucket[:, None], i1, i0]
        return vals > similarity_thresh
    raise ValueError(f"unknown spatial_filter {spatial_filter!r}")


def compact_matches(idx0, idx1, valid, capacity: int):
    """Stable-compact each pair's valid matches [B, M] to the front and
    keep the first `capacity` (SC2-PCR's max_points truncation, reference
    scripts/SC2_PCR/SC2_PCR.py:324-327). Returns (idx0, idx1, valid), each
    [B, min(M, capacity)]."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1,
                          stable=True)[:, :capacity]
    return (torch.gather(idx0, 1, order), torch.gather(idx1, 1, order),
            torch.gather(valid, 1, order))
