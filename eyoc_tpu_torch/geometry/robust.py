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
- K19 (csrc/robust_irls.cu) is one block a problem: the valid rows copied
  once into shared memory, 16 distinct sums a round by a fixed tree, the
  6 x 6 elimination with partial pivoting on every thread, the warp in
  place. Masked rows are skipped, not multiplied by 0: for finite rows that
  is what JAX computes, and non-finite padding cannot poison the sums.
- `est_quad_linear_robust_k19_plain` is the kernel's reformulation in plain
  torch (its row ownership, sum tree, elimination and pose arithmetic), for
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

K19_THREADS = 512     # a block's threads: one block a problem
K19_MAX_ROWS = 8192   # valid rows a problem in shared memory (24 B a row);
                      # past it they are read from a global copy
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


def _xor_tree(v: torch.Tensor) -> torch.Tensor:
    """A warp's xor-shuffle sum over the last axis (32 lanes), every lane's
    value after offsets 16, 8, 4, 2, 1."""
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v


def _k19_block_sums(terms: torch.Tensor) -> torch.Tensor:
    """K19's sum of terms [16, n] over its rows: row m is thread m %
    K19_THREADS's, each thread adds its rows in order, a warp's threads by
    the xor tree, then the 16 warps' partials by the same tree in lanes
    0-15 (the others 0)."""
    T = K19_THREADS
    n = terms.shape[1]
    per = -(-n // T)
    pad = terms.new_zeros((K19_SUMS, per * T - n))
    full = torch.cat([terms, pad], 1).reshape(K19_SUMS, per, T)
    acc = terms.new_zeros((K19_SUMS, T))
    for j in range(per):
        # rows past n are not added (a zero would turn -0.0 into +0.0)
        live = torch.arange(T, device=terms.device) + j * T < n
        acc = torch.where(live, acc + full[:, j], acc)
    part = _xor_tree(acc.reshape(K19_SUMS, T // 32, 32))[..., 0]
    lanes = torch.cat([part, part.new_zeros((K19_SUMS, 32 - T // 32))], 1)
    return _xor_tree(lanes)[:, 0]


def _k19_solve(S: torch.Tensor) -> torch.Tensor:
    """K19's 6 x 6 solve from the 16 sums: (M + 1e-6 I) x = v by Gaussian
    elimination with partial pivoting (the first largest |pivot|), then
    back substitution, every operation rounded apart."""
    (a, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz, r0, r1, r2, v0, v1,
     v2) = S.unbind()
    e = torch.tensor(TIKHONOV, dtype=torch.float32, device=S.device)
    z = torch.zeros_like(a)
    A = torch.stack([
        torch.stack([syy + szz + e, -sxy, -sxz, z, -sz, sy, v0]),
        torch.stack([-sxy, sxx + szz + e, -syz, sz, z, -sx, v1]),
        torch.stack([-sxz, -syz, sxx + syy + e, -sy, sx, z, v2]),
        torch.stack([z, sz, -sy, a + e, z, z, r0]),
        torch.stack([-sz, z, sx, z, a + e, z, r1]),
        torch.stack([sy, -sx, z, z, z, a + e, r2])])
    for k in range(6):
        p = k + int(torch.argmax(A[k:, k].abs()))
        if p != k:
            A[[k, p]] = A[[p, k]]
        for i in range(k + 1, 6):
            l = A[i, k] / A[k, k]
            A[i, k + 1:] = A[i, k + 1:] - l * A[k, k + 1:]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = A[i, 6]
        for j in range(i + 1, 6):
            s = s - A[i, j] * x[j]
        x[i] = s / A[i, i]
    return torch.stack(x)


def _k19_step_pose(x: torch.Tensor):
    """(Rc [3, 3], tc [3]) of twist x: R = rz ry rx as K19 forms it, each
    entry from the rz ry product's rows (a0, a1, a2) as (a0, a1 cx + a2 sx,
    a2 cx - a1 sx)."""
    cx, cy, cz = torch.cos(x[:3])
    sx, sy, sz = torch.sin(x[:3])
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
                                     num_iters: int = NUM_ITERS):
    """K19's reformulation of `est_quad_linear_robust_plain` in plain
    torch: per problem of pts0 / pts1 [B, N, 3], mask [B, N], the valid rows
    in index order; round 0's sums at weight 1; each round halves par at 5,
    10, 15, solves (`_k19_solve`), composes T = Tc T, warps the rows and,
    but in the last round, takes the next round's sums at w = par / (|p -
    q| + par). Returns [B, 4, 4]."""
    pts0, pts1 = pts0.float(), pts1.float()
    if mask is None:
        mask = torch.ones(pts0.shape[:-1], dtype=torch.bool,
                          device=pts0.device)
    out = []
    for b in range(pts0.shape[0]):
        p, q = pts0[b][mask[b]], pts1[b][mask[b]]
        S = _k19_block_sums(_k19_terms(torch.ones_like(p[:, 0]), p, q))
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
            norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                              + d[:, 2] * d[:, 2])
            S = _k19_block_sums(_k19_terms(par / (norm + par), p, q))
        T = torch.eye(4, dtype=torch.float32, device=p.device)
        T[:3, :3], T[:3, 3] = R, t
        out.append(T)
    return torch.stack(out)


_K19_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)


def _k19_spill(B: int, N: int, device):
    """K19's global copy of the valid rows, [B, 6, N] f32, for problems
    whose rows shared memory cannot hold."""
    return torch.empty((B, 6, N), dtype=torch.float32, device=device)


def est_quad_linear_robust(pts0, pts1, mask=None,
                           num_iters: int = NUM_ITERS):
    """K19: the IRLS pose of `est_quad_linear_robust_plain` at unit initial
    weights. pts0 / pts1 [N, 3] or [B, N, 3] f32, mask [N] / [B, N] bool
    (None: every row) -> [4, 4] / [B, 4, 4] f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one block a problem, every round in the one launch) or raises."""
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
    spill = _k19_spill(B, N, pts0.device) if N > K19_MAX_ROWS else None
    p = kernels.ptr
    err = fn(p(pts0), p(pts1), p(mask), B, N, int(num_iters), p(spill),
             p(out), kernels.stream_handle(dev))
    kernels.check_launch("est_quad_linear_robust", err)
    return out
