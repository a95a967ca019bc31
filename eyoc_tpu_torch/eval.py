"""The test protocol on one pair (counterpart of the test half of
eyoc_tpu/training/steps.py: make_embed_step, make_register_step and
make_test_step, :558-648), with SC2-PCR as the estimator.

embed_pair:    voxelize + brick pyramid + ResUNet eval forward, both clouds
register_pair: 5000-point random subset of both clouds -> feature 1-NN ->
               SC2-PCR
test_pair:     both, plus RTE / RRE against the ground-truth pose

Randomness is explicit: the subset takes its uniform noise as an argument,
or draws it from a `torch.Generator` when none is given.
"""

from __future__ import annotations

import dataclasses

import torch

from eyoc_tpu_torch.geometry.metrics import rre_deg, rte
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig, sc2_pcr_estimator
from eyoc_tpu_torch.sparse import morton
from eyoc_tpu_torch.training.pipeline import RawBatch, preprocess_clouds
from eyoc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """The static configuration of the test protocol (a subset of the JAX
    StepConfig)."""

    caps: tuple
    voxel_size: float = 0.3
    window_bits: tuple = morton.BITS
    eval_sample_points: int = 5000
    sc2: SC2PCRConfig = SC2PCRConfig()


def random_subset(noise: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of a uniform random n-subset given i.i.d. uniform `noise`
    (invalid rows pre-set to 2.0): the exact top-n of -noise, ties to the
    lowest index. The JAX `_random_subset` takes `approx_max_k` instead
    (steps.py:94); over i.i.d. noise both select a subset with the same
    distribution."""
    n = min(n, noise.shape[-1])
    return torch.sort(-noise, descending=True, stable=True).indices[:n]


def subset_noise(mask: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform noise for `random_subset`, 2.0 at invalid rows; drawn on the
    generator's device and moved to the mask's."""
    u = torch.rand(mask.shape, generator=generator).to(mask.device)
    return torch.where(mask, u, torch.full_like(u, 2.0))


def _on_device(batch: RawBatch, device) -> RawBatch:
    return batch.to(resolve_device(device))


@torch.no_grad()
def embed_pair(model, batch: RawBatch, cfg: EvalConfig, device=None):
    """Features of both clouds of a one-pair batch.

    Returns (xyz0 [cap, 3], f0 [cap, C], m0 [cap], xyz1, f1, m1)."""
    batch = _on_device(batch, device)
    out = []
    for xyz, n in ((batch.xyz0, batch.n0), (batch.xyz1, batch.n1)):
        vox, pyr = preprocess_clouds(xyz, n, caps=cfg.caps,
                                     voxel_size=cfg.voxel_size,
                                     window_bits=cfg.window_bits)
        feats = model.embed(pyr)
        out += [vox.xyz[0], feats, vox.mask[0]]
    return tuple(out)


@torch.no_grad()
def register_pair(x0, f0, m0, x1, f1, m1, cfg: EvalConfig,
                  noise=None, generator: torch.Generator | None = None):
    """Random 5000-point subsets of both clouds -> SC2-PCR; returns T_est
    [4, 4]. `noise` = (noise0 [cap], noise1 [cap]) or None."""
    if noise is None:
        noise = (subset_noise(m0, generator), subset_noise(m1, generator))
    n = cfg.eval_sample_points
    sel0 = random_subset(noise[0].to(m0.device), n)
    sel1 = random_subset(noise[1].to(m1.device), n)
    T_est, _, _, _ = sc2_pcr_estimator(
        x0[sel0], f0[sel0], m0[sel0], x1[sel1], f1[sel1], m1[sel1], cfg.sc2)
    return T_est


@torch.no_grad()
def test_pair(model, batch: RawBatch, cfg: EvalConfig, noise=None,
              generator: torch.Generator | None = None, device=None):
    """The test protocol on one pair (reference scripts/test_kitti.py:
    128-212). Returns {"T_est", "rte", "rre"}."""
    batch = _on_device(batch, device)
    T_est = register_pair(*embed_pair(model, batch, cfg, batch.xyz0.device),
                          cfg, noise=noise, generator=generator)
    T_gt = batch.T_gt[0]
    return {"T_est": T_est, "rte": rte(T_est, T_gt), "rre": rre_deg(T_est, T_gt)}
