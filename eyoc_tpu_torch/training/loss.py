"""The four metric losses (counterpart of eyoc_tpu/training/loss.py:
hardest_contrastive_loss, random_negative_contrastive_loss, triplet_loss,
hardest_triplet_loss, _sample_valid and the pair-membership search,
:27-285).

Semantics are the JAX package's. The hardest-contrastive loss (reference
contrastive_hardest_negative_loss) samples `num_pos` positive pairs and
`num_hn_samples` negative candidates per cloud, mines the hardest negative
in both directions, drops mined negatives that are themselves positive
pairs, and takes
    pos: relu(||f0 - f1||^2 - pos_thresh)     (squared distance)
    neg: relu(neg_thresh - min_dist)^2        (plain L2 distance).
The contrastive loss takes every positive and random negative pairs; the
triplet losses take random triplets, and the hardest triplet adds the
hardest negative of each sampled positive in both directions.

The random draws come in as explicit uniforms (`LossDraws`), so a test can
feed the port the JAX package's own `jax.random.uniform` values.

On the card every row gather is kernel K6 (`take_rows`, its backward the
scatter-add). The mining runs as kernel K2 (`masked_argmin`) on the
detached features; the mined distance is then recomputed with autograd
from rows taken by K6: sqrt(sum (posF0 - subF1[ind])^2 + 1e-7), JAX's
`pdist` at the argmin. Its gradient equals the gradient JAX takes through
`jnp.min` of the Gram form, up to rounding. With `safe_radius > 0` the
hardest-contrastive mining is kernel K9 (`masked_argmin_excl`): K2 that
skips each candidate whose coordinates lie within the radius of the
anchor's partner, and flags an anchor whose every candidate was skipped
(its mined distance is then 1e9, as in JAX).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eyoc_tpu_torch.ops.knn import masked_argmin, masked_argmin_excl
from eyoc_tpu_torch.ops.rows import take_rows

_BIG = 1e9          # excluded candidates (loss.py:100)
_KEY_SHIFT = 31     # membership key i * 2^31 + j (indices < 2^30)


class LossDraws(NamedTuple):
    """Uniform [0, 1) draws of one loss call, one field a
    `jax.random.uniform` call of the JAX loss (None where the loss draws
    none):
    - hardest contrastive: sel0 / sel1 [num_hn_samples], pos [num_pos]
      (loss.py:81-90);
    - contrastive: sel0 / sel1 [num_neg], the random negatives' rows in
      cloud 0 and cloud 1 (loss.py:204-206);
    - triplet: pos [num_pos], rand [num_rand], neg [num_rand] (the
      positives, the random triplets' anchors and their negatives in cloud
      1, loss.py:223-232);
    - hardest triplet: all five (loss.py:250-266)."""

    sel0: Optional[torch.Tensor]
    sel1: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    rand: Optional[torch.Tensor] = None
    neg: Optional[torch.Tensor] = None


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


def _dist(a, b, eps: float):
    """Row-wise sqrt(sum (a - b)^2 + eps), differentiable."""
    return torch.sqrt(torch.sum((a - b) ** 2, 1) + eps)


def _mine(anchor, cand, excl):
    """Hardest candidate per anchor row on detached features: (index [P]
    int64, every-candidate-excluded [P] bool or None). `excl` is None or
    (partner coordinates [P, 3], candidate coordinates [M, 3], r^2)."""
    a, c = anchor.detach().float().contiguous(), cand.detach().float()
    c = c.contiguous()
    if excl is None:
        ones_a = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
        ones_c = torch.ones(c.shape[0], dtype=torch.bool, device=a.device)
        _, ind = masked_argmin(a, ones_a, c, ones_c)
        return ind.long(), None
    pxyz, cxyz, r2 = excl
    ind, excluded = masked_argmin_excl(a, c, pxyz.float().contiguous(),
                                       cxyz.float().contiguous(), r2)
    return ind.long(), excluded


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
    excl1 = excl0 = None
    if safe_radius > 0.0 and xyz0 is not None and xyz1 is not None:
        r2 = safe_radius * safe_radius
        excl1 = (xyz1[pj.long()], xyz1[sel1], r2)
        excl0 = (xyz0[pi.long()], xyz0[sel0], r2)
    ind01, excl01 = _mine(posF0, take_rows(F1.detach(), sel1), excl1)
    ind10, excl10 = _mine(posF1, take_rows(F0.detach(), sel0), excl0)
    neg_j0 = sel1[ind01]
    neg_i1 = sel0[ind10]

    def mined_dist(anchor, src, rows, excluded):
        d = _dist(anchor, take_rows(src, rows), 1e-7)
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


def random_negative_contrastive_loss(F0, mask0, F1, mask1, pos_i, pos_j,
                                     pos_valid, draws: LossDraws, *,
                                     neg_thresh: float = 1.4):
    """The plain FCGF contrastive loss (loss.py:193-213; reference
    ContrastiveLossTrainer): pos = the mean squared distance over every
    valid positive; neg = relu(neg_thresh - sqrt(d^2 + 1e-4))^2 over random
    (i, j) pairs (`draws.sel0`, `draws.sel1`) that are not positives.

    Returns (pos_loss, neg_loss, aux) with the negatives' rows and mask."""
    posF0 = take_rows(F0, pos_i)
    posF1 = take_rows(F1, pos_j)
    pos_loss = _masked_mean(torch.sum((posF0 - posF1) ** 2, 1), pos_valid)
    ni = sample_valid(draws.sel0, mask0)
    nj = sample_valid(draws.sel1, mask1)
    keep = ~pair_member(pair_keys(pos_i, pos_j, pos_valid), ni, nj)
    d = _dist(take_rows(F0, ni), take_rows(F1, nj), 1e-4)
    neg_loss = _masked_mean(torch.relu(neg_thresh - d) ** 2, keep)
    return pos_loss, neg_loss, dict(ni=ni, nj=nj, keep=keep)


def _random_triplets(F0, F1, pos_i, pos_j, pos_valid, keys, mask1,
                     draws: LossDraws, neg_thresh: float):
    """The random triplets of both triplet losses: anchors and positives
    drawn from the positive pairs (`draws.rand`), negatives from cloud 1's
    valid rows (`draws.neg`). Returns (hinge terms, keep mask, negative
    distances)."""
    rsel = sample_valid(draws.rand, pos_valid)
    anchors, positives = pos_i[rsel], pos_j[rsel]
    negatives = sample_valid(draws.neg, mask1)
    keep = pos_valid[rsel] & ~pair_member(keys, anchors, negatives)
    fa = take_rows(F0, anchors)
    rp = _dist(fa, take_rows(F1, positives), 1e-7)
    rn = _dist(fa, take_rows(F1, negatives), 1e-7)
    return torch.relu(rp + neg_thresh - rn), keep, rn


def triplet_loss(F0, mask0, F1, mask1, pos_i, pos_j, pos_valid,
                 draws: LossDraws, *, neg_thresh: float = 1.4):
    """Random triplets (loss.py:216-239; reference
    TripletLossTrainer.triplet_loss): the mean of relu(d(a, p) +
    neg_thresh - d(a, n)) over the kept triplets.

    Returns (loss, mean positive distance over `num_pos` sampled
    positives, mean negative distance over the kept triplets, aux)."""
    psel = sample_valid(draws.pos, pos_valid)
    pi, pj, pv = pos_i[psel], pos_j[psel], pos_valid[psel]
    pos_dist = _dist(take_rows(F0, pi), take_rows(F1, pj), 1e-7)
    keys = pair_keys(pos_i, pos_j, pos_valid)
    terms, keep, rn = _random_triplets(F0, F1, pos_i, pos_j, pos_valid, keys,
                                       mask1, draws, neg_thresh)
    return (_masked_mean(terms, keep), _masked_mean(pos_dist, pv),
            _masked_mean(rn, keep), dict(psel=psel, keep=keep))


def hardest_triplet_loss(F0, mask0, F1, mask1, pos_i, pos_j, pos_valid,
                         draws: LossDraws, *, neg_thresh: float = 1.4):
    """Hardest and random triplets (loss.py:242-285; reference
    HardestTripletLossTrainer): one relu mean over the random triplets and
    both directions of the hardest-negative triplets, the hardest negative
    of each sampled positive mined among `num_hn_samples` candidates per
    cloud (K2 on the card).

    Returns (loss, mean positive distance, mean mined distance of both
    directions, aux)."""
    sel0 = sample_valid(draws.sel0, mask0)
    sel1 = sample_valid(draws.sel1, mask1)
    psel = sample_valid(draws.pos, pos_valid)
    pi, pj, pv = pos_i[psel], pos_j[psel], pos_valid[psel]
    posF0 = take_rows(F0, pi)
    posF1 = take_rows(F1, pj)
    ind01, _ = _mine(posF0, take_rows(F1.detach(), sel1), None)
    ind10, _ = _mine(posF1, take_rows(F0.detach(), sel0), None)
    neg_j0 = sel1[ind01]
    neg_i1 = sel0[ind10]
    D01min = _dist(posF0, take_rows(F1, neg_j0), 1e-7)
    D10min = _dist(posF1, take_rows(F0, neg_i1), 1e-7)

    keys = pair_keys(pos_i, pos_j, pos_valid)
    mask0n = pv & ~pair_member(keys, pi, neg_j0)
    mask1n = pv & ~pair_member(keys, neg_i1, pj)
    pos_dist = _dist(posF0, posF1, 1e-7)
    rterms, rkeep, _ = _random_triplets(F0, F1, pos_i, pos_j, pos_valid,
                                        keys, mask1, draws, neg_thresh)
    terms = torch.cat([rterms, torch.relu(pos_dist + neg_thresh - D01min),
                       torch.relu(pos_dist + neg_thresh - D10min)])
    keep = torch.cat([rkeep, mask0n, mask1n])
    neg_mean = 0.5 * (_masked_mean(D01min, pv) + _masked_mean(D10min, pv))
    return (_masked_mean(terms, keep), _masked_mean(pos_dist, pv), neg_mean,
            dict(sel0=sel0, sel1=sel1, psel=psel, ind01=ind01, ind10=ind10,
                 keep=keep))
