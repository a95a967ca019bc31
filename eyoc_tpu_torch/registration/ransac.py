"""Batched correspondence RANSAC, the test CLI's default estimator
(counterpart of eyoc_tpu/registration/ransac.py).

Stages, as in the JAX package, for one correspondence set whose valid rows
are compacted to the front:
1. hypotheses: a triplet of the valid prefix from three uniforms, Open3D's
   edge-length check (CorrespondenceCheckerBasedOnEdgeLength 0.9), the
   Jacobi Kabsch of the three points (geometry/svd3.kabsch), and its
   inlier count over a random subset of the valid prefix (two-stage:
   coarse scoring), -1 where the edge check fails;
2. the top `full_verify_top` coarse counts, ties to the lowest index
   (`lax.top_k`'s order), and their poses and counts. Stages 1-2 are
   kernel K16 `ransac_hypotheses_topk`: the edge check alone for every
   hypothesis, the survivors compacted, then solved and counted, a
   histogram of their counts, the selection and one sort of the k kept
   keys; no [H, 4, 4] pose array and no sort over H elements;
3. full verification -> kernel K17 `ransac_verify` (one launch: groups
   of K17_GROUP kept hypotheses, two poses a thread, times splits of the
   rows staged in shared memory) over the kept set: its count over every
   valid row, -1 where the edge check failed, and the first argmax, read
   by the next kernel on the card;
4. polish -> kernel K18 `ransac_polish` (one block, the valid rows held in
   its shared memory: at most K18_MAX_ROWS rows): `polish_iters` rounds
   of the weighted Jacobi Kabsch on the current inliers (|R s + t - t'| <
   threshold), the old pose kept where fewer than 3 rows are inliers; then
   the final inlier count. The kernel ends the rounds once a round's
   inliers are the last round's: every later round would give the same
   pose bits.
Single-stage (`coarse_subset` 0, or not below the row count, or
`full_verify_top` not below the hypothesis count): K16's entry
`ransac_hypotheses` (one thread a hypothesis, every pose) without the
subset, then K17 over every hypothesis.

Randomness is explicit: `draws` = (u_tri [H, 3], u_sub [coarse_subset])
uniforms, or drawn from a `torch.Generator` when not given.

Thresholds are the JAX package's, each in its own form: the counts test
d^2 < thr^2 (thr^2 in f64, then f32), the polish and the final count test
|d| < thr. The kernels warp with their own unfused products and the plain
versions with torch.matmul, so a row within rounding of the threshold may
count on one side only; the edge check (unfused distances, IEEE division)
agrees bit for bit.

A CPU tensor takes the plain versions; a CUDA tensor launches K16 -> K17
-> K18 with no host sync, or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from eyoc_tpu_torch.geometry.svd3 import kabsch
from eyoc_tpu_torch.registration.sc2pcr import _norm3, topk
from eyoc_tpu_torch.utils import kernels


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """The JAX package's RansacConfig (ransac.py:43-52) and its defaults."""

    num_hypotheses: int = 1048576
    distance_threshold: float = 0.3     # voxel_size (test_kitti.py:167)
    edge_length_ratio: float = 0.9      # Open3D checker (test_kitti.py:171)
    polish_iters: int = 5
    hyp_chunk: int = 512                # plain versions: hypotheses a chunk
    coarse_subset: int = 512            # correspondences per coarse score
    full_verify_top: int = 2048         # hypotheses fully verified


def two_stage(cfg: RansacConfig, n: int) -> bool:
    """Coarse scoring on a subset, then the top `full_verify_top` verified
    (the JAX package's condition, ransac.py:121)."""
    return 0 < cfg.coarse_subset < n and cfg.full_verify_top < \
        cfg.num_hypotheses


def ransac_draws(cfg: RansacConfig, device,
                 generator: torch.Generator | None = None):
    """(u_tri [H, 3], u_sub [coarse_subset]) uniforms, drawn on the
    generator's device (the default one's: `device`) and moved to
    `device`."""
    where = generator.device if generator is not None else device
    u_tri = torch.rand((cfg.num_hypotheses, 3), generator=generator,
                       device=where)
    u_sub = torch.rand((max(cfg.coarse_subset, 0),), generator=generator,
                       device=where)
    return u_tri.to(device), u_sub.to(device)


def _valid_count(valid: torch.Tensor) -> torch.Tensor:
    return torch.clamp(valid.sum(dtype=torch.int32), min=1)


def _prefix_rows(u: torch.Tensor, count: torch.Tensor, n: int):
    """Row indices (u * count) truncated, in f32 as the JAX package."""
    return (u * count.float()).int().clamp(max=n - 1).long()


# ------------------------------------------------------------ plain versions


def sample_triplets_plain(u_tri, src, tgt, count):
    """[H, 3, 3] source and target triplets of the valid prefix."""
    tri = _prefix_rows(u_tri, count, src.shape[0])
    return src[tri], tgt[tri]


def edge_ok_plain(s3, t3, ratio_lo: float):
    """Open3D's edge-length check: each of the three edge ratios |s| /
    (|t| + 1e-9) inside (ratio_lo, 1 / ratio_lo). [H] bool."""
    def edges(p):
        return torch.stack([_norm3(p[:, 0] - p[:, 1]),
                            _norm3(p[:, 1] - p[:, 2]),
                            _norm3(p[:, 2] - p[:, 0])], -1)
    ratio = edges(s3) / (edges(t3) + 1e-9)
    return ((ratio > ratio_lo) & (ratio < 1.0 / ratio_lo)).all(-1)


def count_inliers_plain(trans, src, tgt, valid, thr: float, chunk: int):
    """[H] f32 counts of the valid rows with |R s + t - t'|^2 < thr^2, for
    each pose of trans [H, 4, 4], `chunk` poses at a time (memory stays
    bounded at a million hypotheses)."""
    out = []
    for h0 in range(0, trans.shape[0], max(chunk, 1)):
        T = trans[h0:h0 + chunk]
        pred = (torch.einsum("hij,nj->hni", T[:, :3, :3], src)
                + T[:, None, :3, 3])
        d = pred - tgt[None]
        x, y, z = d.unbind(-1)
        d2 = x * x + y * y + z * z
        out.append(((d2 < thr * thr) & valid[None]).sum(-1).float())
    return torch.cat(out) if out else trans.new_zeros(0)


def ransac_hypotheses_plain(src, tgt, valid, u_tri, u_sub, thr: float,
                            ratio_lo: float, chunk: int = 512):
    """(trans [H, 4, 4], coarse [H] f32): each hypothesis's pose and its
    count over the subset rows (u_sub * count) of the valid prefix, -1
    where the edge check fails; with u_sub None, 0 or -1 (the edge flag
    alone)."""
    count = _valid_count(valid)
    s3, t3 = sample_triplets_plain(u_tri, src, tgt, count)
    edge = edge_ok_plain(s3, t3, ratio_lo)
    trans = kabsch(s3, t3)
    if u_sub is None:
        coarse = torch.zeros_like(edge, dtype=torch.float32)
    else:
        sub = _prefix_rows(u_sub, count, src.shape[0])
        ones = torch.ones(sub.shape[0], dtype=torch.bool, device=src.device)
        H = trans.shape[0]
        coarse = count_inliers_plain(trans, src[sub], tgt[sub], ones, thr,
                                     max(chunk, H // 128))
    return trans, torch.where(edge, coarse, torch.full_like(coarse, -1.0))


def ransac_hypotheses_topk_plain(src, tgt, valid, u_tri, u_sub, thr: float,
                                 ratio_lo: float, k: int, chunk: int = 512):
    """(trans [k, 4, 4], coarse [k], keep [k] int32, coarse [H]): the top k
    of `ransac_hypotheses_plain`'s coarse counts (`topk`: count descending,
    ties to the lowest index) with their poses and counts, and every
    hypothesis's count."""
    trans, coarse = ransac_hypotheses_plain(src, tgt, valid, u_tri, u_sub,
                                            thr, ratio_lo, chunk)
    keep = topk(coarse, k)[1]
    return trans[keep], coarse[keep], keep.int(), coarse


def ransac_select_plain(coarse: torch.Tensor, k: int, S: int):
    """K16's selection of the top k of coarse [H] (counts 0..S, -1 where
    the edge check failed), step for step as the kernel takes it: the
    survivors in index order and the histogram of their counts; the
    threshold count, at which the survivors counted from the top reach k;
    every survivor above it, and those at it while their rank among the
    ties is below the remainder; where fewer than k survive, every survivor
    and the lowest-index failing hypotheses (all below k); then one sort of
    the composite keys (count descending, index ascending). keep [k]
    int32, equal to `topk(coarse, k)[1]`."""
    c = coarse.long()
    surv = torch.nonzero(c >= 0)[:, 0]
    cnt = c[surv]
    hist = torch.bincount(cnt, minlength=S + 1)
    if surv.shape[0] >= k:
        above = torch.cumsum(hist.flip(0), 0).flip(0) - hist
        thr = int(torch.nonzero((above < k) & (k <= above + hist))[0, 0])
        tie = cnt == thr
        rank = torch.cumsum(tie.long(), 0) - tie.long()
        take = (cnt > thr) | (tie & (rank < k - int(above[thr])))
        kept, kept_c = surv[take], cnt[take]
    else:
        fails = torch.nonzero(c[:k] < 0)[:, 0][:k - surv.shape[0]]
        kept = torch.cat([surv, fails])
        kept_c = torch.cat([cnt, torch.full_like(fails, -1)])
    key = ((0xFFFF - (kept_c + 1)) << 32) | kept
    return kept[torch.argsort(key)].int()


def ransac_verify_plain(trans, coarse, keep, src, tgt, valid, thr: float,
                        chunk: int = 512):
    """(counts [Hk] f32, best int32 []): the full count of each kept
    hypothesis trans[keep[h]] (every one where keep is None), -1 where its
    edge check failed (coarse < 0); best is the row of trans of the first
    largest count."""
    rows = keep.long() if keep is not None else torch.arange(
        trans.shape[0], device=trans.device)
    counts = count_inliers_plain(trans[rows], src, tgt, valid, thr,
                                 min(chunk, rows.shape[0]))
    counts = torch.where(coarse[rows] >= 0, counts,
                         torch.full_like(counts, -1.0))
    return counts, rows[torch.argmax(counts)].int()


def _inliers(T, src, tgt, valid, thr: float):
    pred = torch.matmul(src, T[:3, :3].T) + T[:3, 3]
    return (_norm3(pred - tgt) < thr) & valid


def ransac_polish_plain(trans, best, src, tgt, valid, thr: float,
                        iters: int):
    """(T [4, 4], inliers int32 []): `iters` rounds of the weighted Kabsch
    on the inliers of trans[best], the old pose kept where fewer than 3 rows
    are inliers; then the inlier count."""
    T = trans[best.long()]
    for _ in range(iters):
        w = _inliers(T, src, tgt, valid, thr).float()
        new = kabsch(src[None], tgt[None], w[None])[0]
        T = torch.where(w.sum() >= 3, new, T)
    return T, _inliers(T, src, tgt, valid, thr).sum(dtype=torch.int32)


def _ransac(hypotheses, hypotheses_topk, verify, polish, src, tgt, valid,
            cfg, draws):
    """The stages' composition: two-stage, the hypotheses' top
    `full_verify_top` with their poses, then verification over them;
    single-stage, every hypothesis's pose and edge flag, then verification
    over all of them; then the polish."""
    thr = cfg.distance_threshold
    u_tri, u_sub = draws
    if two_stage(cfg, src.shape[0]):
        trans, coarse, _, _ = hypotheses_topk(src, tgt, valid, u_tri, u_sub,
                                              thr, cfg.edge_length_ratio,
                                              cfg.full_verify_top)
    else:
        trans, coarse = hypotheses(src, tgt, valid, u_tri, None, thr,
                                   cfg.edge_length_ratio)
    _, best = verify(trans, coarse, None, src, tgt, valid, thr)
    return polish(trans, best, src, tgt, valid, thr, cfg.polish_iters)


def ransac_registration_plain(src, tgt, valid, cfg: RansacConfig, draws):
    """`ransac_registration` through the plain versions (on any device),
    `cfg.hyp_chunk` hypotheses a chunk."""
    chunk = dict(chunk=cfg.hyp_chunk)
    return _ransac(functools.partial(ransac_hypotheses_plain, **chunk),
                   functools.partial(ransac_hypotheses_topk_plain, **chunk),
                   functools.partial(ransac_verify_plain, **chunk),
                   ransac_polish_plain, src.float(), tgt.float(), valid,
                   cfg, draws)


# ---------------------------------------------------------------- kernels

F32, BOOL, I32 = torch.float32, torch.bool, torch.int32
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_K16_ARGS = (_P, _P, _P, _I, _P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _P)
_K16_TOPK_ARGS = (_P, _P, _P, _I, _P, _I, _P, _I, _F, _F, _F, _I) \
    + (_P,) * 6 + (_I,) + (_P,) * 5
K16_MAX_TOP, K16_MAX_SUBSET = 4096, 2048
# the two-stage entry keeps the poses of its first K16_POSE_CACHE survivors
# (4 MiB; the eval path has ~37500) for the kept ones, and solves a kept
# survivor past it again
K16_POSE_CACHE = 65536
_K17_ARGS = (_P, _P, _P, _I, _P, _P, _P, _I, _F, _P, _P, _P, _P, _P)
# K17's kept hypotheses a pose group (csrc/ransac.cu:kVerifyGroup; the C
# entry eyoc_ransac_verify_groups gives the groups of Hk)
K17_GROUP = 256
_K18_ARGS = (_P, _P, _P, _P, _P, _I, _F, _I, _P, _P, _P)
# K18's polish holds the valid rows in shared memory: N at most this
# (csrc/ransac.cu:kPolishMaxRows)
K18_MAX_ROWS = 8192


def _rows3(name, src, tgt, valid):
    N = valid.shape[0]
    if src.shape != (N, 3) or tgt.shape != (N, 3) or valid.shape != (N,):
        raise ValueError(f"{name}: expected src, tgt [N, 3] and valid [N]")
    return N


def ransac_hypotheses(src, tgt, valid, u_tri, u_sub, thr: float,
                      ratio_lo: float):
    """K16, single-stage: `ransac_hypotheses_plain` (its arguments and
    outputs) as one thread a hypothesis, every pose written, the subset
    rows staged in shared memory.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (a one-block launch that counts the valid rows and gathers the subset,
    then the hypotheses) or raises."""
    if src.is_cpu:
        return ransac_hypotheses_plain(src, tgt, valid, u_tri, u_sub, thr,
                                       ratio_lo)
    return _launch_k16(src, tgt, valid, u_tri, u_sub, thr, ratio_lo)


def _launch_k16(src, tgt, valid, u_tri, u_sub, thr, ratio_lo):
    fn = kernels.load("ransac", _K16_ARGS, symbol="ransac_hypotheses")
    dev = kernels.require_cuda("ransac_hypotheses", src, tgt, valid, u_tri,
                               u_sub, dtypes=(F32, F32, BOOL, F32, F32))
    N = _rows3("ransac_hypotheses", src, tgt, valid)
    H = u_tri.shape[0]
    S = 0 if u_sub is None else u_sub.shape[0]
    if u_tri.shape != (H, 3) or (u_sub is not None and u_sub.dim() != 1):
        raise ValueError("ransac_hypotheses: expected u_tri [H, 3] and "
                         "u_sub [S]")
    scratch = torch.empty(1 + 6 * S, dtype=F32, device=src.device)
    trans = torch.empty((H, 4, 4), dtype=F32, device=src.device)
    coarse = torch.empty(H, dtype=F32, device=src.device)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), N, p(u_tri), H, p(u_sub), S,
             thr * thr, ratio_lo, 1.0 / ratio_lo, p(scratch), p(trans),
             p(coarse), kernels.stream_handle(dev))
    kernels.check_launch("ransac_hypotheses", err)
    return trans, coarse


def ransac_hypotheses_topk(src, tgt, valid, u_tri, u_sub, thr: float,
                           ratio_lo: float, k: int):
    """K16, two-stage: `ransac_hypotheses_topk_plain` (its arguments and
    outputs; keep bit-equal to `topk` of coarse) in six launches whose
    grids are fixed by H, S and k: the count of valid rows and the subset;
    the edge check of every hypothesis with the survivors compacted in
    index order; each survivor's Jacobi pose and subset count with a
    histogram of the counts; the selection of the top k; one sort of their
    keys; the k kept poses (those of the first K16_POSE_CACHE survivors
    kept from their solve).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises (k at most 4096, a subset of 1 to 2048 rows)."""
    if src.is_cpu:
        return ransac_hypotheses_topk_plain(src, tgt, valid, u_tri, u_sub,
                                            thr, ratio_lo, k)
    return _launch_k16_topk(src, tgt, valid, u_tri, u_sub, thr, ratio_lo, k)


def _launch_k16_topk(src, tgt, valid, u_tri, u_sub, thr, ratio_lo, k):
    fn = kernels.load("ransac", _K16_TOPK_ARGS,
                      symbol="ransac_hypotheses_topk")
    ctl_size = kernels.load("ransac", (_I, _I), symbol="ransac_topk_ctl")
    dev = kernels.require_cuda("ransac_hypotheses_topk", src, tgt, valid,
                               u_tri, u_sub,
                               dtypes=(F32, F32, BOOL, F32, F32))
    N = _rows3("ransac_hypotheses_topk", src, tgt, valid)
    H = u_tri.shape[0]
    S = u_sub.shape[0] if u_sub.dim() == 1 else -1
    if u_tri.shape != (H, 3) or not 0 < S <= K16_MAX_SUBSET \
            or not 0 < k <= min(H, K16_MAX_TOP):
        raise ValueError("ransac_hypotheses_topk: expected u_tri [H, 3], "
                         f"u_sub [S] with 0 < S <= {K16_MAX_SUBSET} and "
                         f"0 < k <= min(H, {K16_MAX_TOP})")
    nctl = ctl_size(H, S)
    C = min(H, K16_POSE_CACHE)
    scratch = torch.empty(1 + 6 * S, dtype=F32, device=src.device)
    ints = torch.empty(nctl + H + k, dtype=I32, device=src.device)
    kept = torch.empty(k, dtype=torch.int64, device=src.device)
    cache = torch.empty((C, 16), dtype=F32, device=src.device)
    coarse = torch.empty(H, dtype=F32, device=src.device)
    keep = torch.empty(k, dtype=I32, device=src.device)
    kept_coarse = torch.empty(k, dtype=F32, device=src.device)
    trans = torch.empty((k, 4, 4), dtype=F32, device=src.device)
    p = kernels.ptr
    err = fn(p(src), p(tgt), p(valid), N, p(u_tri), H, p(u_sub), S,
             thr * thr, ratio_lo, 1.0 / ratio_lo, k, p(scratch), p(ints),
             p(ints) + 4 * nctl, p(ints) + 4 * (nctl + H), p(kept), p(cache),
             C, p(coarse), p(keep), p(kept_coarse), p(trans),
             kernels.stream_handle(dev))
    kernels.check_launch("ransac_hypotheses_topk", err)
    return trans, kept_coarse, keep, coarse


def ransac_verify(trans, coarse, keep, src, tgt, valid, thr: float):
    """K17: `ransac_verify_plain` in one launch: a block a (group of
    K17_GROUP kept hypotheses, split of the rows), its live poses (edge
    flag and pose read through `keep` on the card) two a thread in
    registers against the split's valid rows in shared memory, the splits'
    integer counts added behind a ticket a group, the first argmax over the
    groups behind a last ticket.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch) or raises."""
    if src.is_cpu:
        return ransac_verify_plain(trans, coarse, keep, src, tgt, valid, thr)
    return _launch_k17(trans, coarse, keep, src, tgt, valid, thr)


def _launch_k17(trans, coarse, keep, src, tgt, valid, thr):
    fn = kernels.load("ransac", _K17_ARGS, symbol="ransac_verify")
    if keep is not None:
        keep = keep.to(I32).contiguous()
    dev = kernels.require_cuda("ransac_verify", trans, coarse, keep, src,
                               tgt, valid,
                               dtypes=(F32, F32, I32, F32, F32, BOOL))
    N = _rows3("ransac_verify", src, tgt, valid)
    H = coarse.shape[0]
    if trans.shape != (H, 4, 4) or (keep is not None and keep.dim() != 1):
        raise ValueError("ransac_verify: expected trans [H, 4, 4], coarse "
                         "[H] and keep [Hk]")
    Hk = H if keep is None else keep.shape[0]
    groups = -(-Hk // K17_GROUP)
    counts = torch.empty(Hk, dtype=F32, device=src.device)
    best = torch.empty((), dtype=I32, device=src.device)
    p = kernels.ptr
    err = fn(p(trans), p(coarse), p(keep), Hk, p(src), p(tgt), p(valid), N,
             thr * thr, p(_k17_sums(src.device, Hk + 2 * groups)),
             p(kernels.ticket(dev, groups + 1)), p(counts), p(best),
             kernels.stream_handle(dev))
    kernels.check_launch("ransac_verify", err)
    return counts, best


_k17_words: dict = {}


def _k17_sums(device, n: int) -> torch.Tensor:
    """n zeroed int32 words on `device` for K17's split sums and group
    maxima, which each launch leaves at zero (as `kernels.ticket`'s);
    allocated once per device, and again only to grow."""
    t = _k17_words.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=I32, device=device)
        _k17_words[device] = t
    return t


def ransac_polish(trans, best, src, tgt, valid, thr: float, iters: int):
    """K18 `ransac_polish`: `ransac_polish_plain` as one block that reads
    `best` on the card, copies the valid rows once into shared memory and
    runs every round from there, moments in two centred passes.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch; N at most K18_MAX_ROWS) or raises."""
    if src.is_cpu:
        return ransac_polish_plain(trans, best, src, tgt, valid, thr, iters)
    return _launch_k18(trans, best, src, tgt, valid, thr, iters)


def _launch_k18(trans, best, src, tgt, valid, thr, iters):
    fn = kernels.load("ransac", _K18_ARGS, symbol="ransac_polish")
    dev = kernels.require_cuda("ransac_polish", trans, best, src, tgt, valid,
                               dtypes=(F32, I32, F32, F32, BOOL))
    N = _rows3("ransac_polish", src, tgt, valid)
    if trans.dim() != 3 or trans.shape[1:] != (4, 4) or best.numel() != 1:
        raise ValueError("ransac_polish: expected trans [H, 4, 4] and one "
                         "best row")
    if not 0 < N <= K18_MAX_ROWS:
        raise ValueError(f"ransac_polish: {N} rows, the kernel holds 1 to "
                         f"{K18_MAX_ROWS}")
    T = torch.empty((4, 4), dtype=F32, device=src.device)
    inliers = torch.empty((), dtype=I32, device=src.device)
    p = kernels.ptr
    err = fn(p(trans), p(best), p(src), p(tgt), p(valid), N, thr,
             int(iters), p(T), p(inliers), kernels.stream_handle(dev))
    kernels.check_launch("ransac_polish", err)
    return T, inliers


def ransac_registration(src: torch.Tensor, tgt: torch.Tensor,
                        valid: torch.Tensor,
                        cfg: RansacConfig = RansacConfig(), draws=None,
                        generator: torch.Generator | None = None):
    """src/tgt: [N, 3] correspondences with the valid rows compacted to the
    front; valid: [N] bool. Returns (trans [4, 4], inlier count int32 [])."""
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    valid = valid.contiguous()
    if draws is None:
        draws = ransac_draws(cfg, src.device, generator)
    draws = tuple(None if d is None else d.float().contiguous()
                  for d in draws)
    return _ransac(ransac_hypotheses, ransac_hypotheses_topk, ransac_verify,
                   ransac_polish, src, tgt, valid, cfg, draws)
