"""The test protocol and the valid step on one pair (counterpart of the
eval half of eyoc_tpu/training/steps.py: make_valid_step, :517-554, and
make_embed_step, make_register_step and make_test_step, :558-648), with
SC2-PCR or RANSAC as the test protocol's estimator.

embed_pair:    voxelize + brick pyramid + ResUNet eval forward, both clouds
register_pair: optionally each cloud's valid voxels thinned to a share
               (`downsample_single`), a 5000-point random subset of both
               clouds, then SC2-PCR (feature 1-NN inside), or with
               `use_ransac` the feature 1-NN of cloud 0's subset in cloud
               1's (K2) and RANSAC over those correspondences
test_pair:     both, plus RTE / RRE against the ground-truth pose
valid_metrics: the trainers' validation after the features: a 5000-point
               random subset of both clouds, the feature 1-NN of cloud 0's
               subset in cloud 1's (K2), the IRLS pose (K19), and
               corr_dist, RTE, RRE and the hit ratio against a pose
valid_pair:    both (embed_pair, valid_metrics) against the ground truth

Randomness is explicit: the thinning, the subset and RANSAC take their
uniforms as arguments (`keep`, `noise`, `draws`), or draw them from a
`torch.Generator` when they are not given.
"""

from __future__ import annotations

import dataclasses

import torch

from eyoc_tpu_torch.geometry.metrics import (corr_dist, hit_ratio, rre_deg,
                                             rte)
from eyoc_tpu_torch.geometry.robust import est_quad_linear_robust
from eyoc_tpu_torch.ops.knn import masked_argmin
from eyoc_tpu_torch.registration.ransac import (RansacConfig,
                                                ransac_registration)
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
    use_ransac: bool = False
    ransac: RansacConfig | None = None     # None: threshold = voxel_size
    downsample_single: float = 1.0         # share of valid voxels kept
    hit_ratio_thresh: float = 0.1          # the valid step's (m)

    @property
    def ransac_config(self) -> RansacConfig:
        """RANSAC's configuration; its distance threshold is the voxel size
        unless given (steps.py:575)."""
        return self.ransac or RansacConfig(distance_threshold=self.voxel_size)


def random_subset(noise: torch.Tensor, n: int) -> torch.Tensor:
    """Indices [..., n] of a uniform random n-subset of the last axis given
    i.i.d. uniform `noise` (invalid rows pre-set to 2.0): the exact top-n
    of -noise, ties to the lowest index. The JAX `_random_subset` takes
    `approx_max_k` instead (steps.py:94), which is exact on the CPU; over
    i.i.d. noise both select a subset with the same distribution."""
    n = min(n, noise.shape[-1])
    return torch.sort(-noise, dim=-1, descending=True,
                      stable=True).indices[..., :n]


def uniforms(mask: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniforms of the mask's shape, drawn on the generator's device (the
    default one's: the mask's) and moved to the mask's."""
    where = generator.device if generator is not None else mask.device
    return torch.rand(mask.shape, generator=generator,
                      device=where).to(mask.device)


def subset_noise(mask: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform noise for `random_subset`, 2.0 at invalid rows."""
    u = uniforms(mask, generator)
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
                  noise=None, keep=None, draws=None,
                  generator: torch.Generator | None = None):
    """Random 5000-point subsets of both clouds -> SC2-PCR, or feature 1-NN
    -> RANSAC (`cfg.use_ransac`); returns T_est [4, 4].

    noise = (noise0 [cap], noise1 [cap]) orders each cloud's subset (the
    rows thinned away or invalid take 2.0); keep = (u0 [cap], u1 [cap])
    thins each cloud to its rows with u < `cfg.downsample_single` (read only
    below 1.0); draws = RANSAC's (u_tri, u_sub). Any of them not given is
    drawn from `generator`."""
    n = cfg.eval_sample_points
    sub = []
    for k, (x, f, m) in enumerate(((x0, f0, m0), (x1, f1, m1))):
        if cfg.downsample_single < 1.0:
            u = keep[k].to(m.device) if keep is not None \
                else uniforms(m, generator)
            m = m & (u < cfg.downsample_single)
        z = noise[k].to(m.device) if noise is not None \
            else uniforms(m, generator)
        sel = random_subset(torch.where(m, z, torch.full_like(z, 2.0)), n)
        sub += [x[sel], f[sel], m[sel]]
    sx0, sf0, sm0, sx1, sf1, sm1 = sub
    if not cfg.use_ransac:
        return sc2_pcr_estimator(sx0, sf0, sm0, sx1, sf1, sm1, cfg.sc2)[0]
    _, nn = masked_argmin(sf0.float().contiguous(), sm0,
                          sf1.float().contiguous(), sm1)
    T_est, _ = ransac_registration(sx0, sx1[nn.long()], sm0,
                                   cfg.ransac_config, draws=draws,
                                   generator=generator)
    return T_est


@torch.no_grad()
def test_pair(model, batch: RawBatch, cfg: EvalConfig, noise=None,
              keep=None, draws=None, generator: torch.Generator | None = None,
              device=None):
    """The test protocol on one pair (reference scripts/test_kitti.py:
    128-212). Returns {"T_est", "rte", "rre"}."""
    batch = _on_device(batch, device)
    T_est = register_pair(*embed_pair(model, batch, cfg, batch.xyz0.device),
                          cfg, noise=noise, keep=keep, draws=draws,
                          generator=generator)
    T_gt = batch.T_gt[0]
    return {"T_est": T_est, "rte": rte(T_est, T_gt), "rre": rre_deg(T_est, T_gt)}


@torch.no_grad()
def valid_metrics(x0, f0, m0, x1, f1, m1, T_gt, cfg: EvalConfig,
                  noise=None, generator: torch.Generator | None = None):
    """The valid step after the features: a random `eval_sample_points`
    subset of both clouds, the feature 1-NN of cloud 0's subset in cloud
    1's (K2), the IRLS pose of those correspondences (K19), and {"loss"
    (corr_dist of the pose), "rte", "rre", "hit_ratio" (at
    cfg.hit_ratio_thresh)} against T_gt [4, 4].

    noise = (noise0 [cap], noise1 [cap]) orders each cloud's subset (the
    JAX step's uniforms of its first and second key; invalid rows take
    2.0); not given, both are drawn from `generator`, cloud 0's first."""
    sel = []
    for k, m in enumerate((m0, m1)):
        z = noise[k].to(m.device) if noise is not None \
            else uniforms(m, generator)
        sel.append(random_subset(torch.where(m, z, torch.full_like(z, 2.0)),
                                 cfg.eval_sample_points))
    sel0, sel1 = sel
    sel_ok = m0[sel0]
    _, nn = masked_argmin(f0[sel0].float().contiguous(), sel_ok,
                          f1[sel1].float().contiguous(), m1[sel1])
    xyz0_c = x0[sel0]
    xyz1_c = x1[sel1][nn.long()]
    T_est = est_quad_linear_robust(xyz0_c, xyz1_c, sel_ok)
    return {"loss": corr_dist(T_est, T_gt, xyz0_c, mask=sel_ok),
            "rte": rte(T_est, T_gt), "rre": rre_deg(T_est, T_gt),
            "hit_ratio": hit_ratio(xyz0_c, xyz1_c, T_gt, cfg.hit_ratio_thresh,
                                   mask=sel_ok)}


@torch.no_grad()
def valid_pair(model, batch: RawBatch, cfg: EvalConfig, noise=None,
               generator: torch.Generator | None = None, device=None):
    """The valid step on one pair (make_valid_step, steps.py:517-554;
    reference lib/trainer.py:1736-1826): `embed_pair`, then
    `valid_metrics` against the pair's ground-truth pose."""
    batch = _on_device(batch, device)
    return valid_metrics(*embed_pair(model, batch, cfg, batch.xyz0.device),
                         batch.T_gt[0], cfg, noise=noise,
                         generator=generator)
