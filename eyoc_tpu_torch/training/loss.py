"""Hardest-contrastive loss (counterpart of eyoc_tpu/training/loss.py:
hardest_contrastive_loss, _sample_valid and the pair-membership search,
:27-158).

Semantics are the JAX package's (reference
contrastive_hardest_negative_loss): sample `num_pos` positive pairs and
`num_hn_samples` negative candidates per cloud, mine the hardest negative in
both directions, drop mined negatives that are themselves positive pairs,
and take
    pos: relu(||f0 - f1||^2 - pos_thresh)     (squared distance)
    neg: relu(neg_thresh - min_dist)^2        (plain L2 distance).

The random draws come in as explicit uniforms (`LossDraws`), so a test can
feed the port the JAX package's own `jax.random.uniform` values.

On the card the mining runs as kernel K2 (`masked_argmin`) on the detached
features; the mined distance is then recomputed with autograd from rows
taken by kernel K6 (`take_rows`): sqrt(sum (posF0 - subF1[ind])^2 + 1e-7).
Its gradient equals the gradient JAX takes through `jnp.min` of the Gram
form, up to rounding. `safe_radius > 0` needs a pairwise mask that K2 does
not take: the plain path carries it on the CPU, and a CUDA tensor raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eyoc_tpu_torch.geometry.metrics import pdist, pdist2
from eyoc_tpu_torch.ops.knn import masked_argmin
from eyoc_tpu_torch.ops.rows import take_rows

_BIG = 1e9          # excluded candidates (loss.py:100)
_KEY_SHIFT = 31     # membership key i * 2^31 + j (indices < 2^30)


class LossDraws(NamedTuple):
    """Uniform [0, 1) draws of one loss call: sel0 / sel1 [num_hn_samples]
    and pos [num_pos] (the three `jax.random.uniform` calls of
    loss.py:81-90)."""

    sel0: torch.Tensor
    sel1: torch.Tensor
    pos: torch.Tensor


def sample_valid(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Indices [n] int64 uniform over the valid rows of `mask`, from n
    uniforms `u`: ranks floor(u * count) mapped through the stable order
    that puts valid rows first (loss.py:27-34)."""
    count = torch.clamp(mask.sum(dtype=torch.int32), min=1)
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    ranks = (u.to(torch.float32) * count).to(torch.int32)
    return order[ranks.long()]


def pair_keys(pos_i, pos_j, pos_valid) -> torch.Tensor:
    """Sorted int64 keys i * 2^31 + j of the valid positive pairs (invalid
    pairs get the JAX sentinel (2^30, 2^30)); the same order as JAX's
    lexicographic sort of (i, j)."""
    big = 2 ** 30
    ki = torch.where(pos_valid, pos_i, big).long()
    kj = torch.where(pos_valid, pos_j, big).long()
    return torch.sort((ki << _KEY_SHIFT) + kj).values


def pair_member(keys: torch.Tensor, i, j) -> torch.Tensor:
    """Whether each (i, j) is a key of `keys` (loss.py:124-140)."""
    q = (i.long() << _KEY_SHIFT) + j.long()
    at = torch.clamp(torch.searchsorted(keys, q), max=keys.shape[0] - 1)
    return keys[at] == q


def _masked_mean(x, m):
    mf = m.to(torch.float32)
    return torch.sum(x * mf) / torch.clamp(torch.sum(mf), min=1.0)


def _mine(anchor, cand, near):
    """Hardest candidate per anchor row on detached features: (index [P]
    int64, chosen-is-excluded [P] bool or None)."""
    a, c = anchor.detach().float(), cand.detach().float()
    if near is None:
        ones_a = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
        ones_c = torch.ones(c.shape[0], dtype=torch.bool, device=a.device)
        _, ind = masked_argmin(a.contiguous(), ones_a, c.contiguous(), ones_c)
        return ind.long(), None
    if a.device.type != "cpu":
        raise NotImplementedError(
            "hardest_contrastive_loss: safe_radius > 0 is not ported to the "
            "card yet (ROADMAP queue 1: safe_radius mining on the card)")
    d = torch.where(near, torch.full_like(near, _BIG, dtype=torch.float32),
                    pdist(a, c))
    ind = torch.argmin(d, dim=1)
    return ind, near.gather(1, ind[:, None])[:, 0]


def hardest_contrastive_loss(F0, mask0, F1, mask1, pos_i, pos_j, pos_valid,
                             draws: LossDraws, *, pos_thresh: float = 0.1,
                             neg_thresh: float = 1.4, xyz0=None, xyz1=None,
                             safe_radius: float = 0.0):
    """F0/F1: [N, C] collated features (zero at invalid rows); masks [N];
    pos_i/pos_j [P] flat positive indices with validity pos_valid [P].
    safe_radius > 0 (with xyz0/xyz1 [N, 3]) excludes candidates within
    that distance of the anchor's partner from the mining (loss.py:64-77).

    Returns (pos_loss, neg_loss, aux) where aux holds the sampled and mined
    indices and the negative masks (for tests)."""
    sel0 = sample_valid(draws.sel0, mask0)
    sel1 = sample_valid(draws.sel1, mask1)
    psel = sample_valid(draws.pos, pos_valid)
    pi, pj, pv = pos_i[psel], pos_j[psel], pos_valid[psel]

    posF0 = take_rows(F0, pi)
    posF1 = take_rows(F1, pj)
    near1 = near0 = None
    if safe_radius > 0.0 and xyz0 is not None and xyz1 is not None:
        r2 = safe_radius * safe_radius
        near1 = pdist2(xyz1[pj.long()], xyz1[sel1]) < r2
        near0 = pdist2(xyz0[pi.long()], xyz0[sel0]) < r2
    ind01, excl01 = _mine(posF0, take_rows(F1.detach(), sel1), near1)
    ind10, excl10 = _mine(posF1, take_rows(F0.detach(), sel0), near0)
    neg_j0 = sel1[ind01]
    neg_i1 = sel0[ind10]

    def mined_dist(anchor, src, rows, excluded):
        d = torch.sqrt(torch.sum((anchor - take_rows(src, rows)) ** 2, 1)
                       + 1e-7)
        if excluded is not None:          # every candidate was excluded
            d = torch.where(excluded, torch.full_like(d, _BIG), d)
        return d

    D01min = mined_dist(posF0, F1, neg_j0, excl01)
    D10min = mined_dist(posF1, F0, neg_i1, excl10)

    keys = pair_keys(pos_i, pos_j, pos_valid)
    mask0_neg = ~pair_member(keys, pi, neg_j0) & pv
    mask1_neg = ~pair_member(keys, neg_i1, pj) & pv

    pos_sq = torch.sum((posF0 - posF1) ** 2, 1)
    pos_loss = _masked_mean(torch.relu(pos_sq - pos_thresh), pv)
    neg0 = _masked_mean(torch.relu(neg_thresh - D01min) ** 2, mask0_neg)
    neg1 = _masked_mean(torch.relu(neg_thresh - D10min) ** 2, mask1_neg)
    aux = dict(sel0=sel0, sel1=sel1, psel=psel, ind01=ind01, ind10=ind10,
               mask0_neg=mask0_neg, mask1_neg=mask1_neg)
    return pos_loss, 0.5 * (neg0 + neg1), aux
