"""IRLS robust pose estimation, the valid step's solver (counterpart of
eyoc_tpu/geometry/robust.py) -> kernel K19 `est_quad_linear_robust`.

20 rounds of a small-angle linearised 6-DoF solve with weights par / (|r|
+ par), `par` halved at rounds 5, 10 and 15, the 3N x 6 system folded into
6 x 6 normal equations (reference util/transform_estimation.py:56-116).

- `est_quad_linear_robust_plain` is the JAX function in plain torch: the
  stacked Jacobian, `einsum` normal equations, `torch.linalg.solve` (LU
  with partial pivoting, as jnp.linalg.solve), the warp compounding on the
  current points, weights zero at masked rows (a masked row still enters
  the sums, multiplied by 0, as in JAX). Batched over leading axes.
- K19 (csrc/robust_irls.cu) is one thread-block cluster of K19_CLUSTER
  CTAs a problem: the valid rows split evenly over the CTAs and copied
  once into their shared memory, 16 distinct sums a round by fixed trees
  (a warp's, the CTA's, then the CTAs' partials read through distributed
  shared memory after one cluster barrier), the 6 x 6 solve through its
  3 x 3 Schur complement on every thread, the warp in place. Masked rows
  are skipped, not multiplied by 0: for finite rows that is what JAX
  computes, and non-finite padding cannot poison the sums.
- `est_quad_linear_robust_k19_plain` is the kernel's reformulation in plain
  torch (its row ownership, sum trees, solve and pose arithmetic), for
  the CPU tests; the main path never calls it.
"""

from __future__ import annotations

import ctypes

import torch

from eyoc_tpu_torch.geometry.se3 import rot_x, rot_y, rot_z
from eyoc_tpu_torch.utils import kernels

NUM_ITERS = 20
TIKHONOV = 1e-6       # added to M's diagonal: a fully masked system is finite


def _small_angle_trans(x: torch.Tensor) -> torch.Tensor:
    """x [..., 6] twist (rx, ry, rz, tx, ty, tz) -> [..., 4, 4] with R =
    rz ry rx in full f32 (robust.py:19)."""
    R = rot_z(x[..., 2]) @ rot_y(x[..., 1]) @ rot_x(x[..., 0])
    T = torch.eye(4, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = x[..., 3:6]
    return T


def _normal_equations(pts0, pts1, w):
    """(M [..., 6, 6], v [..., 6]) = (sum w^2 J^T J, sum w^2 J^T r) of the
    rows J = [[0, z, -y, 1, 0, 0], [-z, 0, x, 0, 1, 0], [y, -x, 0, 0, 0, 1]]
    at pts0 [..., n, 3], r = pts1 - pts0, w [..., n] (robust.py:33)."""
    x, y, z = pts0.unbind(-1)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    J = torch.stack([
        torch.stack([zero, z, -y, one, zero, zero], -1),
        torch.stack([-z, zero, x, zero, one, zero], -1),
        torch.stack([y, -x, zero, zero, zero, one], -1)], -2)  # [..., n, 3, 6]
    r = pts1 - pts0
    Jw = J * (w * w)[..., None, None]
    M = torch.einsum("...nki,...nkj->...ij", Jw, J)
    v = torch.einsum("...nki,...nk->...i", Jw, r)
    return M, v


def est_quad_linear_robust_plain(pts0, pts1, mask=None,
                                 num_iters: int = NUM_ITERS):
    """The IRLS pose T [..., 4, 4] with pts1 ~ T(pts0): pts0 / pts1 [..., N,
    3], mask [..., N] validity; the first round weighs every valid row 1
    (robust.py:65, called as the valid step calls it, with no initial
    weights)."""
    pts0, pts1 = pts0.float(), pts1.float()
    lead = pts0.shape[:-2]
    valid = (torch.ones(pts0.shape[:-1], dtype=torch.float32,
                        device=pts0.device) if mask is None
             else mask.float())
    eye6 = torch.eye(6, dtype=torch.float32, device=pts0.device)
    trans = torch.eye(4, dtype=torch.float32, device=pts0.device).expand(
        lead + (4, 4)).clone()
    cur, w, par = pts0, valid, 1.0
    for i in range(num_iters):
        if i > 0 and i % 5 == 0:
            par = par / 2.0
        M, v = _normal_equations(cur, pts1, w)
        x = torch.linalg.solve(M + TIKHONOV * eye6, v)
        T_i = _small_angle_trans(x)
        cur = cur @ T_i[..., :3, :3].transpose(-1, -2) + T_i[..., None, :3, 3]
        d = cur - pts1
        w = par / (torch.sqrt(torch.sum(d * d, -1)) + par) * valid
        trans = T_i @ trans
    return trans


# ---------------------------------------------------------------- kernel K19

K19_CLUSTER = 8       # CTAs a problem: one thread-block cluster (portable)
K19_THREADS = 640     # a CTA's threads (20 warps)
K19_MAX_ROWS = 8192   # valid rows a CTA in shared memory (24 B a row);
                      # past it a problem's rows are read from a global copy
K19_SUMS = 16


def _k19_terms(w, p, q):
    """The 16 terms [16, n] of rows p, q [n, 3] at weights w [n], in K19's
    order and roundings (csrc/robust_irls.cu:row_terms): a = w^2, a x, a y,
    a z, a xx, a yy, a zz, a xy, a xz, a yz, a r0, a r1, a r2 and the three
    twist entries of v (r = q - p)."""
    x, y, z = p.unbind(-1)
    r0, r1, r2 = (q - p).unbind(-1)
    a = w * w
    ax, ay, az = a * x, a * y, a * z
    return torch.stack([a, ax, ay, az, ax * x, ay * y, az * z, ax * y,
                        ax * z, ay * z, a * r0, a * r1, a * r2,
                        ay * r2 - az * r1, az * r0 - ax * r2,
                        ax * r1 - ay * r0])


def _xor_tree(v: torch.Tensor, lanes: int = 32) -> torch.Tensor:
    """A xor-shuffle sum over the last axis (`lanes` lanes, a power of
    two): every lane's value after offsets lanes / 2, ..., 2, 1."""
    lane = torch.arange(lanes, device=v.device)
    off = lanes // 2
    while off:
        v = v + v[..., lane ^ off]
        off //= 2
    return v


def _k19_block_sums(terms: torch.Tensor, cluster: int | None = None,
                    threads: int | None = None) -> torch.Tensor:
    """K19's sum of terms [16, n] over a problem's rows (in rank order):
    CTA r of the cluster owns ranks [r q, (r + 1) q), q = ceil(n /
    cluster), its row j thread j % threads's; each thread adds its rows in
    order, a warp's threads by the xor tree, the CTA's warps by the same
    tree over 32 lanes (zeros past the warps), then the cluster's CTAs by
    it over theirs."""
    C = K19_CLUSTER if cluster is None else cluster
    T = K19_THREADS if threads is None else threads
    n = terms.shape[1]
    q = -(-n // C)
    per = -(-q // T)
    full = terms.new_zeros((K19_SUMS, C, per * T))
    live = torch.zeros((C, per * T), dtype=torch.bool, device=terms.device)
    for r in range(C):
        lo, hi = min(n, r * q), min(n, r * q + q)
        full[:, r, :hi - lo] = terms[:, lo:hi]
        live[r, :hi - lo] = True
    full = full.reshape(K19_SUMS, C, per, T)
    live = live.reshape(C, per, T)
    acc = terms.new_zeros((K19_SUMS, C, T))
    for j in range(per):
        # rows past a CTA's are not added (a zero would turn -0.0 into +0.0)
        acc = torch.where(live[:, j], acc + full[:, :, j], acc)
    part = _xor_tree(acc.reshape(K19_SUMS, C, T // 32, 32))[..., 0]
    # the CTA's warps in lanes 0 .. T / 32 - 1 of a warp, zeros past them
    lanes = torch.cat([part, part.new_zeros((K19_SUMS, C, 32 - T // 32))],
                      -1)
    cta = _xor_tree(lanes)[..., 0]
    return _xor_tree(cta, C)[:, 0]


def _k19_solve(S: torch.Tensor) -> torch.Tensor:
    """K19's solve of (M + 1e-6 I) x = v from the 16 sums, every operation
    rounded apart: h = 1 / (Sa + 1e-6); the rotation part by an LDL^T
    elimination (reciprocals of the pivots) of the Schur complement A -
    (|s|^2 I - s s^T) h against v_r - s x (v_t h), s = (Sx, Sy, Sz); then
    the translation (v_t + s x x_r) h."""
    (a, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz, r0, r1, r2, v0, v1,
     v2) = S.unbind()
    e = torch.tensor(TIKHONOV, dtype=torch.float32, device=S.device)
    h = 1.0 / (a + e)
    a00 = (syy + szz + e) - (sy * sy + sz * sz) * h
    a11 = (sxx + szz + e) - (sx * sx + sz * sz) * h
    a22 = (sxx + syy + e) - (sx * sx + sy * sy) * h
    a01 = -sxy + (sx * sy) * h
    a02 = -sxz + (sx * sz) * h
    a12 = -syz + (sy * sz) * h
    t0, t1, t2 = r0 * h, r1 * h, r2 * h
    g0 = v0 - (sy * t2 - sz * t1)
    g1 = v1 - (sz * t0 - sx * t2)
    g2 = v2 - (sx * t1 - sy * t0)
    p0 = 1.0 / a00
    l10, l20 = a01 * p0, a02 * p0
    b11 = a11 - l10 * a01
    b12 = a12 - l10 * a02
    b22 = a22 - l20 * a02
    h1 = g1 - l10 * g0
    h2 = g2 - l20 * g0
    p1 = 1.0 / b11
    l21 = b12 * p1
    c22 = b22 - l21 * b12
    x2 = (h2 - l21 * h1) / c22
    x1 = (h1 - b12 * x2) * p1
    x0 = ((g0 - a01 * x1) - a02 * x2) * p0
    return torch.stack([x0, x1, x2, (r0 + (sy * x2 - sz * x1)) * h,
                        (r1 + (sz * x0 - sx * x2)) * h,
                        (r2 + (sx * x1 - sy * x0)) * h])


def _k19_step_pose(x: torch.Tensor):
    """(Rc [3, 3], tc [3]) of twist x: R = rz ry rx as K19 forms it, each
    entry from the rz ry product's rows (a0, a1, a2) as (a0, a1 cx + a2 sx,
    a2 cx - a1 sx); sin and cos in f64, rounded to f32 (the card's sincosf
    is within an ulp or so of them)."""
    cx, cy, cz = torch.cos(x[:3].double()).float()
    sx, sy, sz = torch.sin(x[:3].double()).float()
    zero = torch.zeros_like(cx)
    A = torch.stack([torch.stack([cz * cy, -sz, cz * sy]),
                     torch.stack([sz * cy, cz, sz * sy]),
                     torch.stack([-sy, zero, cy])])
    R = torch.stack([A[:, 0], A[:, 1] * cx + A[:, 2] * sx,
                     A[:, 2] * cx - A[:, 1] * sx], 1)
    return R, x[3:6]


def _k19_apply(R: torch.Tensor, p: torch.Tensor, t=None):
    """R p (+ t) for rows p [n, 3], each entry (R_i0 p0 + R_i1 p1) + R_i2
    p2 (then + t_i)."""
    out = [(R[i, 0] * p[..., 0] + R[i, 1] * p[..., 1]) + R[i, 2] * p[..., 2]
           for i in range(3)]
    if t is not None:
        out = [o + t[i] for i, o in enumerate(out)]
    return torch.stack(out, -1)


def est_quad_linear_robust_k19_plain(pts0, pts1, mask=None,
                                     num_iters: int = NUM_ITERS,
                                     cluster: int | None = None,
                                     threads: int | None = None):
    """K19's reformulation of `est_quad_linear_robust_plain` in plain
    torch: per problem of pts0 / pts1 [B, N, 3], mask [B, N], the valid rows
    in index order; round 0's sums at weight 1; each round halves par at 5,
    10, 15, solves (`_k19_solve`), composes T = Tc T, warps the rows and,
    but in the last round, takes the next round's sums at w = par / (|p -
    q| + par); sums as a cluster of `cluster` CTAs of `threads` threads
    adds them (`_k19_block_sums`; default K19_CLUSTER, K19_THREADS).
    Returns [B, 4, 4]."""
    pts0, pts1 = pts0.float(), pts1.float()
    if mask is None:
        mask = torch.ones(pts0.shape[:-1], dtype=torch.bool,
                          device=pts0.device)
    out = []
    for b in range(pts0.shape[0]):
        p, q = pts0[b][mask[b]], pts1[b][mask[b]]
        S = _k19_block_sums(_k19_terms(torch.ones_like(p[:, 0]), p, q),
                            cluster, threads)
        R = torch.eye(3, dtype=torch.float32, device=p.device)
        t = torch.zeros(3, dtype=torch.float32, device=p.device)
        par = 1.0
        for i in range(num_iters):
            if i > 0 and i % 5 == 0:
                par *= 0.5
            Rc, tc = _k19_step_pose(_k19_solve(S))
            R, t = _k19_apply(Rc, R.T).T, _k19_apply(Rc, t, tc)
            if i == num_iters - 1:
                break
            p = _k19_apply(Rc, p, tc)
            d = p - q
            # the root in f64, rounded: torch's f32 root on the CPU is not
            # always the correctly rounded one that __fsqrt_rn gives
            norm = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                               + d[:, 2] * d[:, 2]).double()).float()
            S = _k19_block_sums(_k19_terms(par / (norm + par), p, q),
                                cluster, threads)
        T = torch.eye(4, dtype=torch.float32, device=p.device)
        T[:3, :3], T[:3, 3] = R, t
        out.append(T)
    return torch.stack(out)


_K19_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)


def _k19_spill(B: int, N: int, device):
    """K19's global copy of the valid rows, [B, 6, N] f32, for problems
    whose rows a cluster's shared memory cannot hold."""
    return torch.empty((B, 6, N), dtype=torch.float32, device=device)


def est_quad_linear_robust(pts0, pts1, mask=None,
                           num_iters: int = NUM_ITERS):
    """K19: the IRLS pose of `est_quad_linear_robust_plain` at unit initial
    weights. pts0 / pts1 [N, 3] or [B, N, 3] f32, mask [N] / [B, N] bool
    (None: every row) -> [4, 4] / [B, 4, 4] f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one cluster of K19_CLUSTER CTAs a problem, every round in the one
    launch) or raises."""
    if pts0.is_cpu:
        return est_quad_linear_robust_plain(pts0, pts1, mask, num_iters)
    if mask is None:
        mask = torch.ones(pts0.shape[:-1], dtype=torch.bool,
                          device=pts0.device)
    if pts0.dim() == 2:
        return _launch_k19(pts0[None], pts1[None], mask[None], num_iters)[0]
    return _launch_k19(pts0, pts1, mask, num_iters)


def _launch_k19(pts0, pts1, mask, num_iters):
    fn = kernels.load("robust_irls", _K19_ARGS,
                      symbol="est_quad_linear_robust")
    f32 = torch.float32
    dev = kernels.require_cuda("est_quad_linear_robust", pts0, pts1, mask,
                               dtypes=(f32, f32, torch.bool))
    B, N = mask.shape
    if pts0.shape != (B, N, 3) or pts1.shape != (B, N, 3):
        raise ValueError("est_quad_linear_robust: expected [B, N, 3] twice "
                         "and [B, N]")
    out = torch.empty((B, 4, 4), dtype=f32, device=pts0.device)
    C = K19_CLUSTER
    spill = (_k19_spill(B, N, pts0.device) if -(-N // C) > K19_MAX_ROWS
             else None)
    p = kernels.ptr
    err = fn(p(pts0), p(pts1), p(mask), B, N, int(num_iters), C, p(spill),
             p(out), kernels.stream_handle(dev))
    kernels.check_launch("est_quad_linear_robust", err)
    return out
