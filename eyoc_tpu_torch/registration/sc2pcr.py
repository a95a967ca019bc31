"""SC2-PCR: second-order spatial-compatibility registration
(counterpart of eyoc_tpu/registration/sc2pcr.py).

Stages, as in the JAX package (reference scripts/SC2_PCR/SC2_PCR.py), for
B problems at once in `sc2_pcr_batched` (`sc2_pcr` is its B = 1 case),
with no host sync from the correspondences to the pose:
1. leading eigenvector of the N x N soft compatibility matrix by 20 power
   iterations -> kernel K3 `sc2_power_iteration`, one launch a problem (one
   launch for all iterations; the symmetric matrix is never stored, each
   of its values rebuilt from the coordinates once per iteration);
2. NMS seed picking -> kernel K13 `sc2_nms` (each pair of valid rows
   within the radius tested once for the local-max flags, then each
   nonzero local score ranked by count among the others and the zero rows
   placed by a scan: no [N, N] tensor and no sort);
3. second-order counts on the seed rows and each seed's k1 best columns ->
   kernel K4 `sc2_seed_topk`, one call a problem (the counts on b1 tensor
   cores, each split of the columns keeping its top k1 in the epilogue,
   then a merge; the [S, N] counts are never stored). `sc2_seed_counts`,
   the same product with the counts stored, is off the main path;
4. two-stage consensus (local SC^2 of the k1 -> k2 top-k -> k2 x k2
   power iteration) + per-seed weighted Kabsch + inlier-count fitness
   and its argmax -> kernel K14 `sc2_seed_transforms` (the valid rows
   compacted once, then a warp a seed, then the fitness of groups of seeds
   on tiles of the rows), or with `qcp_kabsch=False` K23
   `sc2_seed_transforms_jacobi`, the same kernels with the Jacobi solve
   (its heads' solves a thread a head, in a launch of their own);
5. IRLS post-refinement with the inlier-count stop, or `refine_unroll`
   rounds with none -> kernel K15 `sc2_irls` (one thread-block cluster of
   K15_CLUSTER CTAs a problem runs the loop, its valid rows split over the
   CTAs' shared memory, each pass's sums pushed into every CTA before one
   cluster barrier, every CTA solving the same pose, starting from the
   best seed's pose read on the card), or with `qcp_kabsch=False` K24
   `sc2_irls_jacobi` (the same kernel with the Jacobi solve, K24_CLUSTER
   CTAs a problem).

Every kernel has a plain version here (the CPU path and the card's
oracle); the per-pair `_pick_seeds`, `_seed_transforms` and `_post_refine`
are the JAX functions' plain counterparts that the batched ones are held
to.

Top-k: every selection takes the exact top-k with ties to the lowest index,
which is `lax.top_k`'s order; the JAX `_chunked_topk` returns the same
indices (an element of the global top-k is in the top-k of its chunk, and
chunks are concatenated in index order). So seeds and consensus sets match
the JAX package exactly up to float rounding.

Distances that meet a threshold are written as sqrt((dx*dx + dy*dy) +
dz*dz), with no fused multiply-add, in the plain versions and in K4, K13
and K14, so those kernels and their plain versions agree bit for bit on
every radius and compatibility test (the local scores, the seeds, the
consensus sets). The fitness and IRLS inlier tests follow a warped point,
which the plain version makes with torch.matmul and the kernels with
their own products: a point within rounding of the threshold may count
on one side only. K3 has no threshold: it sums with FMAs and multiplies
by 1/d^2, and is held to its plain version within a tolerance
(chip_smoke.py's K3_RTOL).

SC2PCRConfig's TPU tuning switches: `qcp_kabsch` picks the pose solve
(the QCP quartic of `kabsch_qcp`, or the 8-sweep Jacobi of `kabsch`: K14 /
K15 or K23 / K24); `bf16_power` runs stage 1 on K3's bf16 form (SC and the
iterate rounded to bf16, f32 sums); `refine_unroll` > 0 runs that many IRLS
rounds with no stop. `approx_topk`, `topk_recall` and `chunk_topk` are
accepted and read by nothing, since the exact top-k is what they select:
`jax.lax.approx_max_k` lowers to the exact top-k off the TPU (bit-equal to
`lax.top_k` at recall 0.85, 0.95 and 1.0 on [200, 8000] f32 under jax
0.9.0 on the CPU), and `_chunked_topk` is exact by construction, so every
selection here is the one the JAX package makes off the TPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from eyoc_tpu_torch.geometry.se3 import transform_points
from eyoc_tpu_torch.geometry.svd3 import kabsch, kabsch_qcp
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
    qcp_kabsch: bool = True       # QCP quartic Kabsch (K14, K15); False:
    #   the 8-sweep Jacobi `kabsch` (K23, K24)
    # approx_topk, topk_recall, chunk_topk: for config parity only, read by
    # nothing (every top-k here is exact; see the module docstring)
    approx_topk: bool = False
    topk_recall: float = 0.85
    bf16_power: bool = False      # stage 1 on bf16 SC and iterate (K3 bf16)
    chunk_topk: int = 1000
    refine_unroll: int = 0        # > 0: that many IRLS rounds, no stop

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


def _solver(cfg: SC2PCRConfig):
    """The pose solve of the config: `kabsch_qcp` or the Jacobi `kabsch`."""
    return kabsch_qcp if cfg.qcp_kabsch else kabsch


def _power_iteration(M: torch.Tensor, iters: int,
                     bf16: bool = False) -> torch.Tensor:
    """Leading eigenvector of [..., n, n] in M's dtype (full f32 on the
    paths); returns [..., n]. bf16: M and each iterate rounded to bf16
    before the product, the product and the norm in f32
    (eyoc_tpu/registration/sc2pcr.py:100-119)."""
    if bf16:
        M = M.bfloat16().float()
    v = torch.ones(M.shape[:-1] + (1,), dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v = M @ (v.bfloat16().float() if bf16 else v)
        v = v / (torch.linalg.norm(v, dim=-2, keepdim=True) + 1e-6)
    return v[..., 0]


# ---------------------------------------------------------------- kernel K3


def sc2_power_iteration_plain(src, tgt, valid, d_thre: float, iters: int,
                              bf16: bool = False):
    """The JAX composition: materialize SC [N, N], then `iters` matvecs
    (with `bf16`, of SC and the iterate rounded to bf16)."""
    pair_ok = valid[:, None] & valid[None, :]
    cross = _cross(src, tgt)
    sc = torch.clamp(1.0 - cross ** 2 / d_thre ** 2, min=0.0) * pair_ok
    return _power_iteration(sc, iters, bf16)


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


def sc2_power_iteration(src, tgt, valid, d_thre: float, iters: int,
                        bf16: bool = False):
    """K3: leading eigenvector [N] of SC[i, j] = clip(1 - (|s_i - s_j| -
    |t_i - t_j|)^2 / d^2, 0) * valid_i * valid_j, normalized as
    v / (|v| + 1e-6) after each of `iters` matvecs from v0 = ones. With
    `bf16` (SC2PCRConfig.bf16_power), K3's bf16 form: each SC value and
    each v_j rounded to bf16 before the product, sums in f32.

    src/tgt [N, 3] f32, valid [N] bool. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (one cooperative launch for
    all iterations) or raises."""
    if src.is_cpu:
        return sc2_power_iteration_plain(src, tgt, valid, d_thre, iters,
                                         bf16)
    return _launch_k3(src, tgt, valid, d_thre, iters, bf16)


def _launch_k3(src, tgt, valid, d_thre, iters, bf16):
    name = "sc2_power_iteration_bf16" if bf16 else "sc2_power_iteration"
    fn = kernels.load("sc2_power_iteration", _K3_ARGS, symbol=name)
    f32 = torch.float32
    dev = kernels.require_cuda(name, src, tgt, valid,
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
    kernels.check_launch(name, err)
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


def _masked_dist(src, valid):
    """[N, N] distances of the valid pairs, inf elsewhere
    (eyoc_tpu/registration/sc2pcr.py:291)."""
    pair_ok = valid[:, None] & valid[None, :]
    return torch.where(pair_ok, _pairwise_dist(src),
                       torch.full((), float("inf"), device=src.device))


def _pick_seeds(src_dist, scores, radius: float, num_seeds: int):
    """NMS seed selection (reference pick_seeds, SC2_PCR.py:33-59)."""
    relation = (scores[:, None] >= scores[None, :]) | (src_dist >= radius)
    is_local_max = torch.all(relation, dim=-1).to(scores.dtype)
    return _seeds_from_local(scores * is_local_max, num_seeds)


def _seeds_from_local(local, num_seeds: int):
    """The top `num_seeds` of the local scores [..., N] (ties to the lowest
    index) and which of them are positive."""
    _, seeds = topk(local, num_seeds)
    seed_ok = torch.gather(local, -1, seeds) > 0
    return seeds.to(torch.int32), seed_ok


def _gather_rows(x, idx):
    """x [..., K, C] rows idx [..., J] -> [..., J, C]."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape
                                                     + x.shape[-1:]))


def _seed_rows(x, idx):
    """Each seed's rows idx [..., S, k] of its problem's x [..., N, C] ->
    [..., S, k, C]."""
    x = x[..., None, :, :].expand(idx.shape[:-1] + x.shape[-2:])
    return _gather_rows(x, idx)


def _consensus(cfg: SC2PCRConfig, knn_idx, src, tgt, valid):
    """The two-stage consensus (reference cal_seed_trans :61-135) from each
    seed's k1 columns knn_idx [..., S, k1] of the problems src/tgt
    [..., N, 3], valid [..., N]: (fine_sel [..., S, k2] positions among the
    k1 columns, the consensus points src_fine/tgt_fine [..., S, k2, 3],
    their Kabsch weights w [..., S, k2])."""
    d = cfg.d_thre
    idx = knn_idx.long()
    nbr_ok = _seed_rows(valid[..., None], idx)[..., 0]
    src_knn = _seed_rows(src, idx)                          # [..., S, k1, 3]
    tgt_knn = _seed_rows(tgt, idx)
    cross = torch.abs(_pairwise_dist(src_knn) - _pairwise_dist(tgt_knn))
    pair_ok = nbr_ok[..., :, None] & nbr_ok[..., None, :]
    local_hard = ((cross < d) & pair_ok).float()
    local_sc2 = (local_hard[..., :1, :] @ local_hard)[..., 0, :]  # exact

    local_sc2 = torch.where(nbr_ok, local_sc2, torch.full_like(local_sc2, -1.0))
    _, fine_sel = topk(local_sc2, cfg.k2)                    # [..., S, k2]
    fine_ok = torch.gather(nbr_ok, -1, fine_sel)
    src_fine = _gather_rows(src_knn, fine_sel)
    tgt_fine = _gather_rows(tgt_knn, fine_sel)

    cross = torch.abs(_pairwise_dist(src_fine) - _pairwise_dist(tgt_fine))
    local_sc = torch.clamp(1.0 - cross ** 2 / d ** 2, min=0.0)
    fine_pair_ok = fine_ok[..., :, None] & fine_ok[..., None, :]
    k2 = fine_sel.shape[-1]
    eye = torch.eye(k2, dtype=torch.bool, device=src.device)
    local_sc = torch.where(fine_pair_ok & ~eye, local_sc,
                           torch.zeros_like(local_sc))

    w = _power_iteration(local_sc, cfg.num_iterations)      # [..., S, k2]
    w = torch.abs(w) * fine_ok
    w = w / (torch.sum(w, -1, keepdim=True) + 1e-6)
    return fine_sel, src_fine, tgt_fine, w


def _fitness(cfg: SC2PCRConfig, trans, seed_ok, src, tgt, valid):
    """Inliers of each seed's pose trans [..., S, 4, 4] over the full
    correspondence set, full f32; -1 where the seed is not ok."""
    pred = (torch.einsum("...sij,...nj->...sni", trans[..., :3, :3], src)
            + trans[..., None, :3, 3])
    dist = _norm3(pred - tgt[..., None, :, :])
    fit = torch.sum((dist < cfg.inlier_threshold) & valid[..., None, :],
                    -1).float()
    return torch.where(seed_ok, fit, torch.full_like(fit, -1.0))


def _seed_transforms(cfg: SC2PCRConfig, seed_ok, knn_idx, src, tgt, valid):
    """Two-stage consensus + per-seed Kabsch (reference cal_seed_trans) of
    one problem, from each seed's k1 columns `knn_idx` [S, k1]
    (`sc2_seed_topk`): (the best seed's pose [4, 4], fitness [S])."""
    _, src_fine, tgt_fine, w = _consensus(cfg, knn_idx, src, tgt, valid)
    trans = _solver(cfg)(src_fine, tgt_fine, w)              # [S, 4, 4]
    fit = _fitness(cfg, trans, seed_ok, src, tgt, valid)
    best = torch.argmax(fit)
    return trans[best], fit


def _irls_threshold(cfg: SC2PCRConfig) -> float:
    """The IRLS inlier threshold (eyoc_tpu/registration/sc2pcr.py:221)."""
    return 0.10 if cfg.inlier_threshold == 0.10 else 1.2


def _post_refine(cfg: SC2PCRConfig, trans, src, tgt, valid, it_num: int = 20):
    """IRLS refinement with the inlier-count stop (reference :238-278) of
    one problem, one host sync per iteration; with refine_unroll > 0,
    exactly that many rounds and no stop (JAX :224-236)."""
    thr = _irls_threshold(cfg)
    solve = _solver(cfg)
    unroll = cfg.refine_unroll
    prev, cur, it = 0, 0, 0
    while (it < unroll if unroll > 0
           else it < it_num and (it == 0 or abs(cur - prev) >= 1)):
        dist = _norm3(transform_points(src, trans) - tgt)
        inlier = (dist < thr) & valid
        w = (1.0 / (1.0 + (dist / thr) ** 2)) * inlier
        new_trans = solve(src[None], tgt[None], w[None])[0]
        new_count = int(inlier.sum())          # one host sync per iteration
        if new_count > 0:
            trans = new_trans
        prev, cur, it = cur, new_count, it + 1
    return trans


# -------------------------------------------------------------- kernel K13


def sc2_nms_plain(src, valid, scores, radius: float, num_seeds: int):
    """`_pick_seeds` on each problem's masked [N, N] distances, one problem
    at a time (an [N, N] f32 and bool pair a problem: 320 MB at N = 8000).
    src [B, N, 3], valid [B, N], scores [B, N] -> (seeds [B, S] int32,
    seed_ok [B, S] bool)."""
    out = [_pick_seeds(_masked_dist(src[b], valid[b]), scores[b], radius,
                       num_seeds) for b in range(src.shape[0])]
    return (torch.stack([s for s, _ in out]),
            torch.stack([ok for _, ok in out]))


def _order_key(v):
    """K13's integer order of float scores: the bits, negatives flipped,
    every NaN the largest (int64, so that the flip cannot overflow)."""
    bits = v.contiguous().view(torch.int32).long()
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return torch.where(torch.isnan(v), torch.full_like(key, 0x7FC00000), key)


def sc2_nms_rank_plain(src, valid, scores, radius: float, num_seeds: int):
    """K13's selection in plain torch, for `sc2_nms_plain`'s outputs: each
    problem's local scores as `_pick_seeds` makes them; the nonzero ones
    (in index order) ranked by count, rank p = #{q: local_q > local_p, or
    equal with q < p}, plus the zero rows where local_p < 0; a zero row
    ranked after the P positive entries by a scan, P + (zero rows before
    it); the rows of rank < S are the seeds. Scores compare as
    `_order_key`s: -0.0 ties +0.0 (both zero rows), a NaN ranks first.

    src [B, N, 3], valid [B, N], scores [B, N] -> (seeds [B, S] int32,
    seed_ok [B, S] bool), S = min(num_seeds, N)."""
    B, N = valid.shape
    S = min(num_seeds, N)
    seeds = torch.empty((B, S), dtype=torch.int32, device=src.device)
    seed_ok = torch.empty((B, S), dtype=torch.bool, device=src.device)
    for b in range(B):
        sc = scores[b]
        relation = (sc[:, None] >= sc[None, :]) | \
            (_masked_dist(src[b], valid[b]) >= radius)
        local = sc * torch.all(relation, dim=-1).to(sc.dtype)
        zero = local == 0
        nz = torch.nonzero(~zero)[:, 0]
        key = _order_key(local[nz])
        p = torch.arange(nz.numel(), device=src.device)
        beats = (key[None, :] > key[:, None]) | \
            ((key[None, :] == key[:, None]) & (p[None, :] < p[:, None]))
        rank = torch.empty(N, dtype=torch.long, device=src.device)
        rank[nz] = beats.sum(1) + torch.where(key < 0, int(zero.sum()), 0)
        positive = int((key > 0).sum())
        rank[zero] = positive + torch.arange(int(zero.sum()),
                                             device=src.device)
        order = torch.empty(N, dtype=torch.long, device=src.device)
        order[rank] = torch.arange(N, device=src.device)
        seeds[b] = order[:S].to(torch.int32)
        seed_ok[b] = local[order[:S]] > 0
    return seeds, seed_ok


# K13's most rows a problem (csrc/sc2_nms.cu:kMaxRows: nms_rank's shared
# memory)
K13_MAX_ROWS = 17920
_K13_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 4
# K13's flag words, one a row, kept per device and zeroed once: each call
# marks its suppressed rows with a new epoch (csrc/sc2_nms.cu), so a call
# leaves nothing to clear. Calls on one stream may share them.
_k13_words: dict = {}


def _k13_epoch(device, n: int):
    """(the device's flag words, at least n, and this call's epoch)."""
    words, epoch = _k13_words.get(device, (None, 0))
    if words is None or words.numel() < n or epoch >= 2 ** 31 - 1:
        words = torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                            device=device)
        epoch = 0
    _k13_words[device] = (words, epoch + 1)
    return words, epoch + 1


def sc2_nms(src, valid, scores, radius: float, num_seeds: int):
    """K13: NMS seeds of B problems. local[b, i] = scores[b, i] * flag, flag
    0 where a valid row j of larger score lies within `radius` of a valid
    row i; then the top `num_seeds` local scores of each problem (ties to
    the lowest index) and seed_ok = local > 0 there.

    src [B, N, 3] f32, valid [B, N] bool, scores [B, N] f32, finite (0 at
    invalid rows) -> (seeds [B, S] int32, seed_ok [B, S] bool), S =
    min(num_seeds, N). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (two launches: the flags of each pair of rows,
    then each nonzero local score's rank; N at most K13_MAX_ROWS) or
    raises."""
    if src.is_cpu:
        return sc2_nms_plain(src, valid, scores, radius, num_seeds)
    return _launch_k13(src, valid, scores, radius, num_seeds)


def _launch_k13(src, valid, scores, radius, num_seeds):
    fn = kernels.load("sc2_nms", _K13_ARGS)
    f32 = torch.float32
    dev = kernels.require_cuda("sc2_nms", src, valid, scores,
                               dtypes=(f32, torch.bool, f32))
    B, N = valid.shape
    if src.shape != (B, N, 3) or scores.shape != (B, N):
        raise ValueError("sc2_nms: expected [B, N, 3], [B, N], [B, N]")
    if N > K13_MAX_ROWS:
        raise ValueError(f"sc2_nms: {N} rows a problem, the kernel holds "
                         f"at most {K13_MAX_ROWS}")
    S = min(num_seeds, N)
    seeds = torch.empty((B, S), dtype=torch.int32, device=src.device)
    seed_ok = torch.empty((B, S), dtype=torch.bool, device=src.device)
    words, epoch = _k13_epoch(src.device, B * N)
    p = kernels.ptr
    err = fn(p(src), p(valid), p(scores), B, N, float(radius), S, epoch,
             p(words), p(seeds), p(seed_ok), kernels.stream_handle(dev))
    kernels.check_launch("sc2_nms", err)
    return seeds, seed_ok


# -------------------------------------------------------------- kernel K14


def seed_transforms_batched_plain(cfg: SC2PCRConfig, seed_ok, knn_idx, src,
                                  tgt, valid):
    """`_seed_transforms` with a problem axis (the plain version of K14,
    and of K23 with qcp_kabsch=False): knn_idx [B, S, k1], seed_ok
    [B, S], src/tgt [B, N, 3], valid [B, N] -> (trans [B, S, 4, 4] each
    seed's pose, fitness [B, S], best [B] int32 the first argmax, fine_sel
    [B, S, k2] int32 the consensus sets as positions among the k1
    columns)."""
    fine_sel, src_fine, tgt_fine, w = _consensus(cfg, knn_idx, src, tgt,
                                                 valid)
    trans = _solver(cfg)(src_fine, tgt_fine, w)
    fit = _fitness(cfg, trans, seed_ok, src, tgt, valid)
    best = torch.argmax(fit, -1).to(torch.int32)
    return trans, fit, best, fine_sel.to(torch.int32)


# seed_consensus's most k1 (csrc/sc2_refine.cu:kMaxK)
_K14_MAX_K = 32
_K14_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int) + (
    ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int) + (
    ctypes.c_void_p,) * 5
# K23's entry: K14's and the heads' moments before the stream
_K23_ARGS = _K14_ARGS[:-1] + (ctypes.c_void_p, ctypes.c_void_p)
# K14's compaction: rows a block (csrc/sc2_refine.cu:kChunk), and the most
# epochs its count words take before they are zeroed again (kMaxEpoch)
_K14_CHUNK, _K14_MAX_EPOCH = 1024, 1 << 20
# K14's count words, kept per device and zeroed once: each call tags its
# chunks' counts with a new epoch, so a call leaves nothing to clear
_k14_words: dict = {}


def _k14_epoch(device, n: int):
    """(the device's count words, at least n, and this call's epoch)."""
    words, epoch = _k14_words.get(device, (None, 0))
    if words is None or words.numel() < n or epoch + 1 >= _K14_MAX_EPOCH:
        words = torch.zeros(max(n, 1 << 12), dtype=torch.int32,
                            device=device)
        epoch = 0
    _k14_words[device] = (words, epoch + 1)
    return words, epoch + 1


def _k14_scratch(B: int, N: int, S: int, device):
    """K14's scratch, 9 B N + B + 3 B S int32 words: each problem's valid
    rows compacted (two float4s a row), each row's place among them, the
    counts; each seed's fitness counter, head flag and head."""
    return torch.empty(9 * B * N + B + 3 * B * S, dtype=torch.int32,
                       device=device)


def _k23_moments(B: int, S: int, device):
    """K23's heads' moments, [B, S, 17] f32 (H, GA, GB, cA, cB), from the
    consensus to the solves."""
    return torch.empty((B, S, 17), dtype=torch.float32, device=device)


def sc2_seed_transforms(cfg: SC2PCRConfig, seed_ok, knn_idx, src, tgt,
                        valid):
    """K14, or K23 `sc2_seed_transforms_jacobi` with qcp_kabsch=False:
    `seed_transforms_batched_plain` (its outputs and arguments): each
    problem's valid rows compacted once; a warp a (problem, seed) for the
    consensus and pose (QCP, or Jacobi), made once for a run of seeds with
    the same k1 columns; the fitness of each group of seeds on tiles of the
    rows, and the argmax by each problem's last block.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (three launches; K23 four: its Jacobi solves a thread a head, in a
    launch of their own) or raises."""
    if src.is_cpu:
        return seed_transforms_batched_plain(cfg, seed_ok, knn_idx, src, tgt,
                                             valid)
    return _launch_k14(cfg, seed_ok, knn_idx, src, tgt, valid)


def _launch_k14(cfg, seed_ok, knn_idx, src, tgt, valid):
    name = "sc2_seed_transforms" + ("" if cfg.qcp_kabsch else "_jacobi")
    fn = kernels.load("sc2_refine", _K14_ARGS if cfg.qcp_kabsch
                      else _K23_ARGS, symbol=name)
    f32 = torch.float32
    dev = kernels.require_cuda(
        name, src, tgt, valid, knn_idx, seed_ok,
        dtypes=(f32, f32, torch.bool, torch.int32, torch.bool))
    B, N = valid.shape
    S, k1 = knn_idx.shape[1:]
    if src.shape != (B, N, 3) or tgt.shape != (B, N, 3) \
            or knn_idx.shape != (B, S, k1) or seed_ok.shape != (B, S):
        raise ValueError(f"{name}: expected [B, N, 3] twice, "
                         "[B, N], [B, S, k1], [B, S]")
    k2 = min(cfg.k2, k1)
    if not 1 <= k1 <= _K14_MAX_K:
        raise ValueError(f"{name}: k1 = {k1} not in 1..{_K14_MAX_K}")
    trans = torch.empty((B, S, 4, 4), dtype=f32, device=src.device)
    fit = torch.empty((B, S), dtype=f32, device=src.device)
    best = torch.empty(B, dtype=torch.int32, device=src.device)
    fine_sel = torch.empty((B, S, k2), dtype=torch.int32, device=src.device)
    scratch = _k14_scratch(B, N, S, src.device)
    moments = () if cfg.qcp_kabsch else (_k23_moments(B, S, src.device),)
    words, epoch = _k14_epoch(src.device, B * -(-N // _K14_CHUNK))
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), p(knn_idx), p(seed_ok), B, N, S, k1,
             k2, float(cfg.d_thre), float(cfg.d_thre ** 2),
             float(cfg.inlier_threshold), int(cfg.num_iterations),
             p(scratch), p(kernels.ticket(dev, B)), p(words), words.numel(),
             epoch, p(trans), p(fit), p(best), p(fine_sel),
             *map(p, moments), kernels.stream_handle(dev))
    kernels.check_launch(name, err)
    return trans, fit, best, fine_sel


# -------------------------------------------------------------- kernel K15


def post_refine_batched_plain(cfg: SC2PCRConfig, trans, src, tgt, valid,
                              it_num: int = 20):
    """`_post_refine` for B problems with no host sync (the plain version of
    K15, and of K24 with qcp_kabsch=False): it_num steps, each problem's
    state frozen by `where` once its stop holds, so each stops where the
    JAX while-loop stops; with refine_unroll > 0, exactly that many steps,
    none frozen. trans [B, 4, 4], src/tgt [B, N, 3], valid [B, N] ->
    (trans [B, 4, 4], iterations [B] int32)."""
    thr = _irls_threshold(cfg)
    solve = _solver(cfg)
    unroll = cfg.refine_unroll
    prev = cur = it = torch.zeros(src.shape[0], dtype=torch.int32,
                                  device=src.device)
    for _ in range(unroll if unroll > 0 else it_num):
        run = (it < it_num) & ((it == 0) | ((cur - prev).abs() >= 1))
        if unroll > 0:
            run = torch.ones_like(run)
        dist = _norm3(transform_points(src, trans) - tgt)
        inlier = (dist < thr) & valid
        w = (1.0 / (1.0 + (dist / thr) ** 2)) * inlier
        new_trans = solve(src, tgt, w)
        count = inlier.sum(-1, dtype=torch.int32)
        new_trans = torch.where((count > 0)[:, None, None], new_trans, trans)
        trans = torch.where(run[:, None, None], new_trans, trans)
        prev = torch.where(run, cur, prev)
        cur = torch.where(run, count, cur)
        it = torch.where(run, it + 1, it)
    return trans, it


_K15_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_float,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 4
# K15's and K24's CTAs a problem (one thread-block cluster,
# csrc/sc2_refine.cu: irls; profile_k24.py on an H100): K24 is fastest at
# 8 on every row; K15 at 8 is faster at the eval shape but slower than its
# single-block parent on a recorded labeling (10-123 valid rows a
# problem, where the barriers outweigh the rows they spread), at 2 no row
# is slower
K15_CLUSTER = 2
K24_CLUSTER = 8
# the most valid rows a CTA of K15 / K24 holds in shared memory
# (csrc/sc2_refine.cu:kIrlsRows): a problem of more than the cluster's
# CTAs times this reads its rows from a compacted copy in global memory
K15_MAX_ROWS = 4096


def _k15_spill(B: int, N: int, device):
    """K15's global copy of the valid rows, [B, 6, N] f32, for problems
    whose rows shared memory cannot hold."""
    return torch.empty((B, 6, N), dtype=torch.float32, device=device)


def sc2_irls_plain(cfg: SC2PCRConfig, trans, best, src, tgt, valid,
                   it_num: int = 20):
    """`post_refine_batched_plain` from each problem's pose
    trans[b, best[b]]."""
    start = trans[torch.arange(trans.shape[0], device=trans.device),
                  best.long()]
    return post_refine_batched_plain(cfg, start, src, tgt, valid, it_num)


def sc2_irls(cfg: SC2PCRConfig, trans, best, src, tgt, valid,
             it_num: int = 20):
    """K15, or K24 `sc2_irls_jacobi` with qcp_kabsch=False: IRLS of B
    problems from each problem's best seed pose trans[b, best[b]] (trans
    [B, S, 4, 4], best [B] int32) -> (trans [B, 4, 4], iterations [B]
    int32), as `sc2_irls_plain`; with refine_unroll > 0, exactly that many
    rounds.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one thread-block cluster a problem, its valid rows in the CTAs' shared
    memory, one launch) or raises."""
    if src.is_cpu:
        return sc2_irls_plain(cfg, trans, best, src, tgt, valid, it_num)
    return _launch_k15(cfg, trans, best, src, tgt, valid, it_num)


def _launch_k15(cfg, trans, best, src, tgt, valid, it_num):
    name = "sc2_irls" + ("" if cfg.qcp_kabsch else "_jacobi")
    fn = kernels.load("sc2_refine", _K15_ARGS, symbol=name)
    f32 = torch.float32
    dev = kernels.require_cuda(name, trans, best, src, tgt, valid,
                               dtypes=(f32, torch.int32, f32, f32,
                                       torch.bool))
    B, N = valid.shape
    S = trans.shape[1]
    if trans.shape != (B, S, 4, 4) or best.shape != (B,) \
            or src.shape != (B, N, 3) or tgt.shape != (B, N, 3):
        raise ValueError(f"{name}: expected [B, S, 4, 4], [B], [B, N, 3] "
                         "twice, [B, N]")
    out = torch.empty((B, 4, 4), dtype=f32, device=src.device)
    iters = torch.empty(B, dtype=torch.int32, device=src.device)
    p = kernels.ptr
    C = K15_CLUSTER if cfg.qcp_kabsch else K24_CLUSTER
    spill = (_k15_spill(B, N, src.device) if -(-N // C) > K15_MAX_ROWS
             else None)
    err = fn(p(trans), p(best), p(src), p(tgt), p(valid), B, N, S,
             _irls_threshold(cfg), int(it_num), int(cfg.refine_unroll), C,
             p(spill), p(out), p(iters), kernels.stream_handle(dev))
    kernels.check_launch(name, err)
    return out, iters


# --------------------------------------------------------------- SC2-PCR


def sc2_pcr_batched(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                    cfg: SC2PCRConfig = SC2PCRConfig()):
    """Register B padded correspondence sets at once: src/tgt [B, N, 3] f32
    matched coordinates, valid [B, N] bool. Returns (trans [B, 4, 4],
    fitness [B, S]); each problem's as `sc2_pcr` on it alone.

    On the card: K3 (or its bf16 form) and K4 once a problem, K13, K14 and
    K15 (K23 and K24 with qcp_kabsch=False) once for all, queued with no
    host sync."""
    B, n = valid.shape
    if n > cfg.max_points:
        raise ValueError(f"{n} correspondences exceed max_points "
                         f"{cfg.max_points}")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    valid = valid.contiguous()
    confidence = torch.stack([
        sc2_power_iteration(src[b], tgt[b], valid[b], cfg.d_thre,
                            cfg.num_iterations, cfg.bf16_power)
        for b in range(B)])
    confidence = confidence * valid.float()
    seeds, seed_ok = sc2_nms(src, valid, confidence, cfg.nms_radius,
                             min(cfg.num_seeds, n))
    knn_idx = torch.stack([
        sc2_seed_topk(src[b], tgt[b], valid[b], seeds[b], cfg.d_thre, cfg.k1)
        for b in range(B)])
    trans, fitness, best, _ = sc2_seed_transforms(cfg, seed_ok, knn_idx,
                                                  src, tgt, valid)
    trans, _ = sc2_irls(cfg, trans, best, src, tgt, valid)
    return trans, fitness


def sc2_pcr(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
            cfg: SC2PCRConfig = SC2PCRConfig()):
    """Register one padded correspondence set: src/tgt [N, 3] f32 matched
    coordinates, valid [N] bool. Returns (trans [4, 4], fitness [S]): the
    B = 1 case of `sc2_pcr_batched`."""
    trans, fitness = sc2_pcr_batched(src[None], tgt[None], valid[None], cfg)
    return trans[0], fitness[0]


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
