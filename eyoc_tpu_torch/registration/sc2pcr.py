"""SC2-PCR: second-order spatial-compatibility registration
(counterpart of eyoc_tpu/registration/sc2pcr.py).

Stages, as in the JAX package (reference scripts/SC2_PCR/SC2_PCR.py):
1. leading eigenvector of the N x N soft compatibility matrix by 20 power
   iterations -> kernel K3 `sc2_power_iteration` (the matrix is rebuilt
   from the coordinates inside every matvec and never stored);
2. NMS seed picking (plain torch);
3. second-order counts on the seed rows -> kernel K4 `sc2_seed_counts`;
4. two-stage consensus (k1 top-k -> local SC^2 -> k2 top-k -> k2 x k2
   power iteration) + per-seed weighted QCP Kabsch + inlier-count fitness
   (plain torch, batched over the seeds);
5. IRLS post-refinement with the inlier-count stop: a Python loop with one
   host sync per iteration, at most 20.

Top-k: every selection takes the exact top-k with ties to the lowest index,
which is `lax.top_k`'s order; the JAX `_chunked_topk` returns the same
indices (an element of the global top-k is in the top-k of its chunk, and
chunks are concatenated in index order). So seeds and consensus sets match
the JAX package exactly up to float rounding.

Distances that meet a threshold are written as sqrt((dx*dx + dy*dy) +
dz*dz), the order the kernels use, so kernel and plain version agree bit
for bit on every threshold test.

Of SC2PCRConfig's TPU tuning switches only the defaults are carried: exact
top-k (`approx_topk=False`), f32 power iteration (`bf16_power=False`) and
the IRLS while-loop (`refine_unroll=0`); `chunk_topk` is exact by
construction and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from eyoc_tpu_torch.geometry.se3 import transform_points
from eyoc_tpu_torch.geometry.svd3 import kabsch_qcp
from eyoc_tpu_torch.ops.knn import masked_argmin
from eyoc_tpu_torch.utils import kernels


@dataclasses.dataclass(frozen=True)
class SC2PCRConfig:
    """Mirrors scripts/SC2_PCR/config_json/config_KITTI.json."""

    d_thre: float = 0.1
    num_iterations: int = 20
    ratio: float = 0.2
    nms_radius: float = 0.6
    max_points: int = 8000
    k1: int = 30
    k2: int = 20
    inlier_threshold: float = 0.6
    seed_cap: int | None = None   # static seed count; default max_points*ratio
    qcp_kabsch: bool = True       # the Jacobi `kabsch` is not ported yet

    @property
    def num_seeds(self) -> int:
        return self.seed_cap or int(self.max_points * self.ratio)


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis (size 3) as sqrt((x*x + y*y) + z*z)."""
    x, y, z = d.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def _pairwise_dist(a: torch.Tensor) -> torch.Tensor:
    return _norm3(a[..., :, None, :] - a[..., None, :, :])


def _cross(src, tgt):
    return torch.abs(_pairwise_dist(src) - _pairwise_dist(tgt))


def topk(x: torch.Tensor, k: int):
    """Exact top-k along the last axis, ties to the lowest index."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _power_iteration(M: torch.Tensor, iters: int) -> torch.Tensor:
    """Leading eigenvector of [..., n, n] in full f32; returns [..., n]."""
    v = torch.ones(M.shape[:-1] + (1,), dtype=torch.float32, device=M.device)
    for _ in range(iters):
        v = M @ v
        v = v / (torch.linalg.norm(v, dim=-2, keepdim=True) + 1e-6)
    return v[..., 0]


# ---------------------------------------------------------------- kernel K3


def sc2_power_iteration_plain(src, tgt, valid, d_thre: float, iters: int):
    """The JAX composition: materialize SC [N, N], then `iters` matvecs."""
    pair_ok = valid[:, None] & valid[None, :]
    cross = _cross(src, tgt)
    sc = torch.clamp(1.0 - cross ** 2 / d_thre ** 2, min=0.0) * pair_ok
    return _power_iteration(sc, iters)


_K3_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p)


def sc2_power_iteration(src, tgt, valid, d_thre: float, iters: int):
    """K3: leading eigenvector [N] of SC[i, j] = clip(1 - (|s_i - s_j| -
    |t_i - t_j|)^2 / d^2, 0) * valid_i * valid_j, normalized as
    v / (|v| + 1e-6) after each of `iters` matvecs from v0 = ones.

    src/tgt [N, 3] f32, valid [N] bool. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if src.is_cpu:
        return sc2_power_iteration_plain(src, tgt, valid, d_thre, iters)
    fn = kernels.load("sc2_power_iteration", _K3_ARGS)
    f32 = torch.float32
    dev = kernels.require_cuda("sc2_power_iteration", src, tgt, valid,
                               dtypes=(f32, f32, torch.bool))
    n = src.shape[0]
    if src.shape != (n, 3) or tgt.shape != (n, 3) or valid.shape != (n,):
        raise ValueError("sc2_power_iteration: expected [N, 3], [N, 3], [N]")
    row_blocks = -(-n // 256)
    splits = max(1, min(-(-264 // max(row_blocks, 1)), -(-n // 256), 64))
    part = torch.empty((splits, n), dtype=f32, device=src.device)
    v = torch.empty(n, dtype=f32, device=src.device)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), n, float(d_thre ** 2), int(iters),
             splits, p(part), p(v), kernels.stream_handle(dev))
    kernels.check_launch("sc2_power_iteration", err)
    return v


# ---------------------------------------------------------------- kernel K4


def sc2_seed_counts_plain(src, tgt, valid, seeds, d_thre: float):
    """The JAX composition: [N, N] hard/tight masks, the [S, N] @ [N, N]
    product (exact integer counts in f32), times the seed rows of hard."""
    pair_ok = valid[:, None] & valid[None, :]
    cross = _cross(src, tgt)
    hard = (cross < d_thre) & pair_ok
    tight = ((cross < d_thre / 2.0) & pair_ok).float()
    seeds = seeds.long()
    return (tight[seeds] @ tight) * hard[seeds].float()


_K4_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def sc2_seed_counts(src, tgt, valid, seeds, d_thre: float):
    """K4: SC2 [S, N] f32 = hard[seed_s, j] * sum_k tight[seed_s, k] *
    tight[k, j], with hard = |dS - dT| < d and tight = |dS - dT| < d/2 over
    valid pairs; exact counts.

    seeds [S] int32 rows. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if src.is_cpu:
        return sc2_seed_counts_plain(src, tgt, valid, seeds, d_thre)
    fn = kernels.load("sc2_seed_counts", _K4_ARGS)
    f32 = torch.float32
    dev = kernels.require_cuda("sc2_seed_counts", src, tgt, valid, seeds,
                               dtypes=(f32, f32, torch.bool, torch.int32))
    n = src.shape[0]
    ns = seeds.shape[0]
    if src.shape != (n, 3) or tgt.shape != (n, 3) or valid.shape != (n,):
        raise ValueError("sc2_seed_counts: expected [N, 3], [N, 3], [N]")
    bits = torch.empty((n, -(-n // 32)), dtype=torch.int32, device=src.device)
    out = torch.empty((ns, n), dtype=f32, device=src.device)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), n, p(seeds), ns, float(d_thre),
             float(d_thre / 2.0), p(bits), p(out), kernels.stream_handle(dev))
    kernels.check_launch("sc2_seed_counts", err)
    return out


# ------------------------------------------------------------------ stages


def _pick_seeds(src_dist, scores, radius: float, num_seeds: int):
    """NMS seed selection (reference pick_seeds, SC2_PCR.py:33-59)."""
    relation = (scores[:, None] >= scores[None, :]) | (src_dist >= radius)
    is_local_max = torch.all(relation, dim=-1).to(scores.dtype)
    local_scores = scores * is_local_max
    _, seeds = topk(local_scores, num_seeds)
    seed_ok = local_scores[seeds] > 0
    return seeds.to(torch.int32), seed_ok


def _take3(x, idx):
    """x [S, K, 3] rows idx [S, J] -> [S, J, 3]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))


def _seed_transforms(cfg: SC2PCRConfig, seed_ok, SC2, src, tgt, valid):
    """Two-stage consensus + per-seed Kabsch (reference cal_seed_trans)."""
    d = cfg.d_thre
    SC2 = torch.where(valid[None, :], SC2, torch.full_like(SC2, -1.0))
    _, knn_idx = topk(SC2, cfg.k1)                           # [S, k1]
    nbr_ok = valid[knn_idx]
    src_knn = src[knn_idx]                                   # [S, k1, 3]
    tgt_knn = tgt[knn_idx]
    cross = torch.abs(_pairwise_dist(src_knn) - _pairwise_dist(tgt_knn))
    pair_ok = nbr_ok[:, :, None] & nbr_ok[:, None, :]
    local_hard = ((cross < d) & pair_ok).float()
    local_sc2 = (local_hard[:, :1, :] @ local_hard)[:, 0, :]  # exact counts

    local_sc2 = torch.where(nbr_ok, local_sc2, torch.full_like(local_sc2, -1.0))
    _, fine_sel = topk(local_sc2, cfg.k2)                    # [S, k2]
    fine_ok = torch.gather(nbr_ok, 1, fine_sel)
    src_fine = _take3(src_knn, fine_sel)
    tgt_fine = _take3(tgt_knn, fine_sel)

    cross = torch.abs(_pairwise_dist(src_fine) - _pairwise_dist(tgt_fine))
    local_sc = torch.clamp(1.0 - cross ** 2 / d ** 2, min=0.0)
    fine_pair_ok = fine_ok[:, :, None] & fine_ok[:, None, :]
    eye = torch.eye(cfg.k2, dtype=torch.bool, device=src.device)
    local_sc = torch.where(fine_pair_ok & ~eye[None], local_sc,
                           torch.zeros_like(local_sc))

    w = _power_iteration(local_sc, cfg.num_iterations)      # [S, k2]
    w = torch.abs(w) * fine_ok
    w = w / (torch.sum(w, -1, keepdim=True) + 1e-6)
    trans = kabsch_qcp(src_fine, tgt_fine, w)                # [S, 4, 4]

    # fitness over the full correspondence set, full f32
    pred = (torch.einsum("sij,nj->sni", trans[:, :3, :3], src)
            + trans[:, None, :3, 3])
    dist = _norm3(pred - tgt[None])
    fit = torch.sum((dist < cfg.inlier_threshold) & valid[None], -1).float()
    fit = torch.where(seed_ok, fit, torch.full_like(fit, -1.0))
    best = torch.argmax(fit)
    return trans[best], fit


def _post_refine(cfg: SC2PCRConfig, trans, src, tgt, valid, it_num: int = 20):
    """IRLS refinement with the inlier-count stop (reference :238-278)."""
    thr = 0.10 if cfg.inlier_threshold == 0.10 else 1.2
    prev, cur, it = 0, 0, 0
    while it < it_num and (it == 0 or abs(cur - prev) >= 1):
        dist = _norm3(transform_points(src, trans) - tgt)
        inlier = (dist < thr) & valid
        w = (1.0 / (1.0 + (dist / thr) ** 2)) * inlier
        new_trans = kabsch_qcp(src[None], tgt[None], w[None])[0]
        new_count = int(inlier.sum())          # one host sync per iteration
        if new_count > 0:
            trans = new_trans
        prev, cur, it = cur, new_count, it + 1
    return trans


def sc2_pcr(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
            cfg: SC2PCRConfig = SC2PCRConfig()):
    """Register one padded correspondence set: src/tgt [N, 3] f32 matched
    coordinates, valid [N] bool. Returns (trans [4, 4], fitness [S])."""
    n = src.shape[0]
    if n > cfg.max_points:
        raise ValueError(f"{n} correspondences exceed max_points "
                         f"{cfg.max_points}")
    if not cfg.qcp_kabsch:
        raise NotImplementedError("only the QCP Kabsch solver is ported")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    valid = valid.contiguous()
    confidence = sc2_power_iteration(src, tgt, valid, cfg.d_thre,
                                     cfg.num_iterations) * valid.float()
    num_seeds = min(cfg.num_seeds, n)
    pair_ok = valid[:, None] & valid[None, :]
    src_dist = torch.where(pair_ok, _pairwise_dist(src),
                           torch.full((), float("inf"), device=src.device))
    seeds, seed_ok = _pick_seeds(src_dist, confidence, cfg.nms_radius,
                                 num_seeds)
    del src_dist, pair_ok
    SC2 = sc2_seed_counts(src, tgt, valid, seeds, cfg.d_thre)
    trans, fitness = _seed_transforms(cfg, seed_ok, SC2, src, tgt, valid)
    trans = _post_refine(cfg, trans, src, tgt, valid)
    return trans, fitness


def sc2_pcr_estimator(src_xyz, src_feat, src_mask, tgt_xyz, tgt_feat,
                      tgt_mask, cfg: SC2PCRConfig = SC2PCRConfig()):
    """Feature 1-NN matching -> SC2-PCR (reference Matcher.estimator).

    Returns (trans [4, 4], inlier_labels [N], fitness, nn [N])."""
    _, nn = masked_argmin(src_feat.float().contiguous(), src_mask,
                          tgt_feat.float().contiguous(), tgt_mask)
    tgt_corr = tgt_xyz[nn.long()]
    trans, fitness = sc2_pcr(src_xyz, tgt_corr, src_mask, cfg)
    dist = _norm3(transform_points(src_xyz, trans) - tgt_corr)
    labels = ((dist < cfg.inlier_threshold) & src_mask).float()
    return trans, labels, fitness, nn
