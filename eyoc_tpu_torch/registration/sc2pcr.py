"""SC2-PCR: second-order spatial-compatibility registration
(counterpart of eyoc_tpu/registration/sc2pcr.py).

Stages, as in the JAX package (reference scripts/SC2_PCR/SC2_PCR.py):
1. leading eigenvector of the N x N soft compatibility matrix by 20 power
   iterations -> kernel K3 `sc2_power_iteration` (one launch for all
   iterations; the symmetric matrix is never stored, each of its values
   rebuilt from the coordinates once per iteration);
2. NMS seed picking (plain torch);
3. second-order counts on the seed rows and each seed's k1 best columns ->
   kernel K4 `sc2_seed_topk` (the counts on b1 tensor cores, each split of
   the columns keeping its top k1 in the epilogue, then a merge; the
   [S, N] counts are never stored). `sc2_seed_counts`, the same product
   with the counts stored, is off the main path;
4. two-stage consensus (local SC^2 of the k1 -> k2 top-k -> k2 x k2
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
dz*dz), with no fused multiply-add, in the plain versions and in K4, so
K4 and its plain version agree bit for bit on every threshold test. K3 has
no threshold: it sums with FMAs and multiplies by 1/d^2, and is held to
its plain version within a tolerance (chip_smoke.py's K3_RTOL).

Of SC2PCRConfig's TPU tuning switches only the defaults are carried: exact
top-k (`approx_topk=False`), f32 power iteration (`bf16_power=False`) and
the IRLS while-loop (`refine_unroll=0`); `chunk_topk` is exact by
construction and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

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
    """Leading eigenvector of [..., n, n] in M's dtype (full f32 on the
    paths); returns [..., n]."""
    v = torch.ones(M.shape[:-1] + (1,), dtype=M.dtype, device=M.device)
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


def sc2_power_iteration_tiled_plain(src, tgt, valid, d_thre: float,
                                    iters: int, tile: int = 128):
    """K3's reformulation in plain torch: the tile pairs (I <= J) of the
    upper triangle, each SC block made once per iteration with the
    reciprocal of d^2; its row sums go to y_I and (off the diagonal) its
    column sums to y_J; y_i of tile I adds the partials of pairs (K, I) for
    K < I and (I, K) for K >= I in the order of K, as the kernel does."""
    n = src.shape[0]
    nt = -(-n // tile)
    inv_d2 = 1.0 / (d_thre * d_thre)
    vf = valid.to(torch.float32)
    v = torch.ones(n, dtype=torch.float32, device=src.device)
    if iters == 0:
        return v
    rows = [slice(t * tile, min(n, (t + 1) * tile)) for t in range(nt)]
    for _ in range(iters):
        vv = v * vf
        row_part, col_part = {}, {}
        for I in range(nt):
            for J in range(I, nt):
                a, b = rows[I], rows[J]
                ds = _norm3(src[a, None, :] - src[None, b, :])
                dt = _norm3(tgt[a, None, :] - tgt[None, b, :])
                x = ds - dt
                sc = torch.clamp(1.0 - (x * x) * inv_d2, min=0.0)
                row_part[I, J] = sc @ vv[b]
                if I != J:
                    col_part[I, J] = vv[a] @ sc
        ys = []
        for I in range(nt):
            y = torch.zeros_like(row_part[I, I])
            for K in range(nt):
                y = y + (col_part[K, I] if K < I else row_part[I, K])
            ys.append(y)
        y = torch.cat(ys) * vf
        v = y / (torch.sqrt(torch.sum(y * y)) + 1e-6)
    return v


# K3's tile (rows and columns) of csrc/sc2_power_iteration.cu:kTile; the
# partials buffer holds two rows of partials for each tile pair, then one
# sum of squares per tile
_K3_TILE = 128
_K3_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p)


def sc2_power_iteration(src, tgt, valid, d_thre: float, iters: int):
    """K3: leading eigenvector [N] of SC[i, j] = clip(1 - (|s_i - s_j| -
    |t_i - t_j|)^2 / d^2, 0) * valid_i * valid_j, normalized as
    v / (|v| + 1e-6) after each of `iters` matvecs from v0 = ones.

    src/tgt [N, 3] f32, valid [N] bool. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (one cooperative launch for
    all iterations) or raises."""
    if src.is_cpu:
        return sc2_power_iteration_plain(src, tgt, valid, d_thre, iters)
    fn = kernels.load("sc2_power_iteration", _K3_ARGS)
    f32 = torch.float32
    dev = kernels.require_cuda("sc2_power_iteration", src, tgt, valid,
                               dtypes=(f32, f32, torch.bool))
    n = src.shape[0]
    if src.shape != (n, 3) or tgt.shape != (n, 3) or valid.shape != (n,):
        raise ValueError("sc2_power_iteration: expected [N, 3], [N, 3], [N]")
    nt = -(-n // _K3_TILE)
    part_len = nt * (nt + 1) * _K3_TILE + nt
    part = src.new_empty(part_len)
    v = src.new_empty(n)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), n, 1.0 / float(d_thre) ** 2,
             int(iters), p(part), part_len, p(v), kernels.stream_handle(dev))
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


def _seed_keys(src, tgt, valid, seeds, d_thre: float):
    """The consensus's keys [S, N]: the counts, -1 at invalid columns."""
    SC2 = sc2_seed_counts_plain(src, tgt, valid, seeds, d_thre)
    return torch.where(valid[None, :], SC2, torch.full_like(SC2, -1.0))


def sc2_seed_topk_plain(src, tgt, valid, seeds, d_thre: float, k: int):
    """The JAX composition: the masked [S, N] counts, then the exact top k
    (ties to the lowest column); idx [S, min(k, N)] int32."""
    _, idx = topk(_seed_keys(src, tgt, valid, seeds, d_thre), k)
    return idx.to(torch.int32)


def sc2_seed_topk_tiled_plain(src, tgt, valid, seeds, d_thre: float, k: int,
                              tile: int):
    """K4's selection in plain torch: each key becomes the composite
    (key + 1) * 65536 + 65535 - j (larger is better, no two equal), each
    chunk of `tile` columns keeps its best k, and the chunks' candidates,
    concatenated in column order, give the best k; idx as
    `sc2_seed_topk_plain`. Exact since an element of the global top k is
    in the top k of its chunk."""
    keys = _seed_keys(src, tgt, valid, seeds, d_thre).to(torch.int64)
    n = keys.shape[1]
    j = torch.arange(n, device=keys.device)
    comp = (keys + 1) * 65536 + (65535 - j)
    k = min(k, n)
    cand = torch.cat([torch.topk(comp[:, c:c + tile],
                                 min(k, tile, n - c)).values
                      for c in range(0, n, tile)], dim=1)
    best = torch.topk(cand, k).values
    return (65535 - best % 65536).to(torch.int32)


# K4's seed rows per block (csrc/sc2_seed_counts.cu:kBM), columns per tile
# (kBN), and the most splits and list entries the kernels take
_K4_SEEDS, _K4_COLS, _K4_MAX_SPLITS, _K4_MAX_K = 64, 64, 32, 32
_K4_MAX_N = 13056            # 64 + 64 packed rows fit in a block's memory
_K4_COUNTS_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p)
_K4_TOPK_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                 ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def k4_plan(ns: int, n: int, resident: int) -> tuple[int, int]:
    """(seed groups, column splits) of a K4 product launch: as many splits
    as keep every block resident at once (`resident`: occupancy x SMs), at
    most one per 64-column tile and _K4_MAX_SPLITS."""
    groups = -(-ns // _K4_SEEDS)
    splits = min(resident // max(groups, 1), -(-n // _K4_COLS),
                 _K4_MAX_SPLITS)
    return groups, max(splits, 1)


_k4_resident_blocks: dict = {}


def _k4_resident(dev: int, n: int) -> int:
    """Blocks of K4's product kernel that device `dev` holds at once."""
    words = -(-n // 256) * 8
    got = _k4_resident_blocks.get((dev, words))
    if got is None:
        fn = kernels.load("sc2_seed_counts", (ctypes.c_int,),
                          symbol="sc2_seed_resident")
        with torch.cuda.device(dev):
            got = fn(n)
        if got <= 0:
            raise RuntimeError("sc2_seed_counts: occupancy query failed")
        _k4_resident_blocks[(dev, words)] = got
    return got


def _k4_args(name, src, tgt, valid, seeds):
    """Checks K4's inputs; returns (device, n, ns, splits, bits)."""
    f32 = torch.float32
    dev = kernels.require_cuda(name, src, tgt, valid, seeds,
                               dtypes=(f32, f32, torch.bool, torch.int32))
    n = src.shape[0]
    if src.shape != (n, 3) or tgt.shape != (n, 3) or valid.shape != (n,) \
            or seeds.dim() != 1:
        raise ValueError(f"{name}: expected [N, 3], [N, 3], [N], [S]")
    if n > _K4_MAX_N:
        raise ValueError(f"{name}: N = {n} exceeds {_K4_MAX_N}")
    _, splits = k4_plan(seeds.shape[0], n, _k4_resident(dev, n))
    words = -(-n // 256) * 8              # the packed tight and hard rows
    bits = torch.empty((2, 32 * words, words), dtype=torch.int32,
                       device=src.device)
    return dev, n, seeds.shape[0], splits, bits


def sc2_seed_counts(src, tgt, valid, seeds, d_thre: float):
    """K4: SC2 [S, N] f32 = hard[seed_s, j] * sum_k tight[seed_s, k] *
    tight[k, j], with hard = |dS - dT| < d and tight = |dS - dT| < d/2 over
    valid pairs; exact counts.

    seeds [S] int32 rows. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (the packing, then the product on b1 tensor
    cores) or raises. Off the main path, which takes `sc2_seed_topk`."""
    if src.is_cpu:
        return sc2_seed_counts_plain(src, tgt, valid, seeds, d_thre)
    fn = kernels.load("sc2_seed_counts", _K4_COUNTS_ARGS)
    dev, n, ns, splits, bits = _k4_args("sc2_seed_counts", src, tgt, valid,
                                        seeds)
    out = torch.empty((ns, n), dtype=torch.float32, device=src.device)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), n, p(seeds), ns, float(d_thre),
             float(d_thre / 2.0), splits, p(bits), p(out),
             kernels.stream_handle(dev))
    kernels.check_launch("sc2_seed_counts", err)
    return out


def sc2_seed_topk(src, tgt, valid, seeds, d_thre: float, k: int):
    """K4 with the consensus's k1 selection: idx [S, min(k, N)] int32, each
    seed row's columns of largest key = valid[j] ? SC2[s, j] : -1 (SC2 as
    `sc2_seed_counts`), by key descending, then column ascending (the
    order of `topk` and `lax.top_k`).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (the packing, the product with each split's top k in its epilogue, the
    merge of the splits) or raises. No [S, N] tensor is made on the card."""
    if src.is_cpu:
        return sc2_seed_topk_plain(src, tgt, valid, seeds, d_thre, k)
    fn = kernels.load("sc2_seed_counts", _K4_TOPK_ARGS,
                      symbol="sc2_seed_topk")
    dev, n, ns, splits, bits = _k4_args("sc2_seed_topk", src, tgt, valid,
                                        seeds)
    k = min(k, n)
    if not 1 <= k <= _K4_MAX_K:
        raise ValueError(f"sc2_seed_topk: k = {k} not in 1..{_K4_MAX_K}")
    cand = torch.empty(ns * splits * k, dtype=torch.int32, device=src.device)
    idx = torch.empty((ns, k), dtype=torch.int32, device=src.device)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), n, p(seeds), ns, float(d_thre),
             float(d_thre / 2.0), k, splits, p(bits), p(cand), p(idx),
             kernels.stream_handle(dev))
    kernels.check_launch("sc2_seed_topk", err)
    return idx


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


def _seed_transforms(cfg: SC2PCRConfig, seed_ok, knn_idx, src, tgt, valid):
    """Two-stage consensus + per-seed Kabsch (reference cal_seed_trans),
    from each seed's k1 columns `knn_idx` [S, k1] (`sc2_seed_topk`)."""
    d = cfg.d_thre
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
    knn_idx = sc2_seed_topk(src, tgt, valid, seeds, cfg.d_thre, cfg.k1)
    trans, fitness = _seed_transforms(cfg, seed_ok, knn_idx, src, tgt, valid)
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
