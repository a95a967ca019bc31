"""Weighted Kabsch through Horn's quaternion method (counterpart of
eyoc_tpu/geometry/svd3.py), with two solvers of the 4x4 eigenproblem:

- `kabsch`: the leading eigenvector by `jacobi_eigh`, 8 cyclic sweeps of
  Givens rotations (RANSAC's hypotheses and polish, ICP);
- `kabsch_qcp`: Newton on the closed-form characteristic quartic
  (Theobald 2005), then the largest column of the adjugate, polished by two
  shifted power iterations (SC2-PCR).

Everything is batched elementwise arithmetic. A Givens rotation updates the
two rows, then the two columns it touches, each entry as c * x - s * y or
s * x + c * y: the value of the JAX package's G^T A G product without its
zero terms, and what the kernels of csrc/ransac.cu compute.
"""

from __future__ import annotations

import torch

from eyoc_tpu_torch.geometry.se3 import integrate_trans


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]; a zero
    quaternion maps to the identity."""
    n2 = torch.sum(q * q, -1, keepdim=True)
    unit = torch.zeros_like(q)
    unit[..., 0] = 1.0
    q = torch.where(n2 > 1e-24, q * torch.rsqrt(torch.clamp(n2, min=1e-24)),
                    unit)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


_JACOBI_SWEEPS = 8


def _cyclic_pairs(n: int):
    return [(p, q) for p in range(n - 1) for q in range(p + 1, n)]


def jacobi_eigh(A: torch.Tensor, sweeps: int = _JACOBI_SWEEPS):
    """Eigendecomposition of symmetric [..., n, n] matrices (n small) by
    cyclic Jacobi: `sweeps` passes over the pairs (0, 1), (0, 2), ...,
    (n-2, n-1). Returns (eigenvalues [..., n], eigenvectors [..., n, n] in
    columns), not sorted.

    The rotation angle is branchless, as in the JAX package: no rotation
    where |a_pq| < 1e-30, and t = sign(tau) / (|tau| + sqrt(1 + tau^2)),
    so tau = 0 (a_pp = a_qq) rotates by nothing either."""
    n = A.shape[-1]
    A = A.float().clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for p, q in _cyclic_pairs(n) * sweeps:
        apq, app, aqq = A[..., p, q], A[..., p, p], A[..., q, q]
        small = apq.abs() < 1e-30
        tau = (aqq - app) / torch.where(small, torch.ones_like(apq),
                                        2.0 * apq)
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(small, torch.zeros_like(t), t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        c1, s1 = c[..., None], s[..., None]
        rp, rq = A[..., p, :], A[..., q, :]           # G^T A: rows p and q
        A[..., p, :], A[..., q, :] = c1 * rp - s1 * rq, s1 * rp + c1 * rq
        for M in (A, V):                              # (.) G: columns
            cp, cq = M[..., :, p], M[..., :, q]
            M[..., :, p], M[..., :, q] = c1 * cp - s1 * cq, s1 * cp + c1 * cq
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def _entries(H):
    return [[H[..., r, c] for c in range(3)] for r in range(3)]


def horn_profile_matrix(H: torch.Tensor) -> torch.Tensor:
    """4x4 symmetric profile matrix of the 3x3 cross-covariance H."""
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = _entries(H)
    r0 = [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]
    r1 = [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz]
    r2 = [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy]
    r3 = [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]
    return torch.stack([torch.stack(r, -1) for r in (r0, r1, r2, r3)], -2)


def qcp_quartic_coeffs(H: torch.Tensor):
    """(c2, c1, c0) of the depressed characteristic quartic of the profile
    matrix, in closed form from H (elementwise, no matmul)."""
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = _entries(H)
    Sxx2, Syy2, Szz2 = Sxx * Sxx, Syy * Syy, Szz * Szz
    Sxy2, Syz2, Sxz2 = Sxy * Sxy, Syz * Syz, Sxz * Sxz
    Syx2, Szy2, Szx2 = Syx * Syx, Szy * Szy, Szx * Szx

    c2 = -2.0 * (Sxx2 + Syy2 + Szz2 + Sxy2 + Syx2 + Sxz2 + Szx2 + Syz2 + Szy2)
    c1 = 8.0 * (
        Sxx * Syz * Szy + Syy * Szx * Sxz + Szz * Sxy * Syx
        - Sxx * Syy * Szz - Syz * Szx * Sxy - Szy * Syx * Sxz
    )
    SxzpSzx, SyzpSzy, SxypSyx = Sxz + Szx, Syz + Szy, Sxy + Syx
    SyzmSzy, SxzmSzx, SxymSyx = Syz - Szy, Sxz - Szx, Sxy - Syx
    SxxpSyy, SxxmSyy = Sxx + Syy, Sxx - Syy
    t0 = Sxy2 + Sxz2 - Syx2 - Szx2
    t1 = Syy2 + Szz2 - Sxx2 + Syz2 + Szy2
    t2 = 2.0 * (Syz * Szy - Syy * Szz)
    c0 = (
        t0 * t0
        + (t1 + t2) * (t1 - t2)
        + (-SxzpSzx * SyzmSzy + SxymSyx * (SxxmSyy - Szz))
        * (-SxzmSzx * SyzpSzy + SxymSyx * (SxxmSyy + Szz))
        + (-SxzpSzx * SyzpSzy - SxypSyx * (SxxpSyy - Szz))
        * (-SxzmSzx * SyzmSzy - SxypSyx * (SxxpSyy + Szz))
        + (SxypSyx * SyzpSzy + SxzpSzx * (SxxmSyy + Szz))
        * (-SxymSyx * SyzmSzy + SxzpSzx * (SxxpSyy + Szz))
        + (SxypSyx * SyzmSzy + SxzmSzx * (SxxmSyy - Szz))
        * (-SxymSyx * SyzpSzy + SxzmSzx * (SxxpSyy - Szz))
    )
    return c2, c1, c0


def _det3(a, b, c, d, e, f, g, h, i):
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _adjugate4_sym(A: torch.Tensor) -> torch.Tensor:
    """Adjugate of a symmetric [..., 4, 4] matrix (elementwise cofactors)."""
    a = [[A[..., r, c] for c in range(4)] for r in range(4)]

    def minor(r, c):
        rows = [x for x in range(4) if x != r]
        cols = [x for x in range(4) if x != c]
        return _det3(*[a[rr][cc] for rr in rows for cc in cols])

    cof = [[((-1.0) ** (r + c)) * minor(r, c) for c in range(4)]
           for r in range(4)]
    return torch.stack(
        [torch.stack([cof[c][r] for c in range(4)], -1) for r in range(4)], -2)


def qcp_leading_quaternion(N4, c2, c1, c0, lam_upper, newton_iters: int = 12,
                           polish_iters: int = 2) -> torch.Tensor:
    """Leading eigenvector [..., 4] of the Horn matrix N4 [..., 4, 4]."""
    N4 = N4.float()
    x = lam_upper.float()
    for _ in range(newton_iters):
        x2 = x * x
        P = x2 * x2 + c2 * x2 + c1 * x + c0
        dP = 4.0 * x2 * x + 2.0 * c2 * x + c1
        x = x - P / torch.where(dP.abs() < 1e-12,
                                torch.full_like(dP, 1e-12), dP)
    eye = torch.eye(4, dtype=N4.dtype, device=N4.device)
    adj = _adjugate4_sym(N4 - x[..., None, None] * eye)
    nrm = torch.sum(adj * adj, dim=-2)
    col = torch.argmax(nrm, dim=-1)
    q = torch.gather(adj, -1, col[..., None, None].expand(
        adj.shape[:-1] + (1,)))[..., 0]
    qn = torch.sqrt(torch.sum(q * q, -1, keepdim=True))
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    q = torch.where(qn > 1e-12, q / (qn + 1e-30), ident)
    M = N4 + lam_upper.float()[..., None, None] * eye
    for _ in range(polish_iters):
        nq = torch.einsum("...ij,...j->...i", M, q)
        n2 = torch.sum(nq * nq, -1, keepdim=True)
        q = torch.where(n2 > 1e-24,
                        nq * torch.rsqrt(torch.clamp(n2, min=1e-24)), q)
    return q


def kabsch_qcp(A: torch.Tensor, B: torch.Tensor,
               weights: torch.Tensor | None = None,
               weight_threshold: float = 0.0) -> torch.Tensor:
    """Weighted rigid alignment: trans [..., 4, 4] with B ~ trans(A).

    A, B: [..., N, 3]; weights: [..., N] (pad rows -> weight 0)."""
    weights, cA, cB, Am, Bm, H, scale = _weighted_moments(
        A, B, weights, weight_threshold)
    Hn = H / scale
    GA = torch.sum(weights * torch.sum(Am * Am, -1), -1)
    GB = torch.sum(weights * torch.sum(Bm * Bm, -1), -1)
    lam_upper = (GA + GB) / (2.0 * scale[..., 0, 0])
    N4 = horn_profile_matrix(Hn)
    c2, c1, c0 = qcp_quartic_coeffs(Hn)
    q = qcp_leading_quaternion(N4, c2, c1, c0, lam_upper)
    R = quat_to_rotmat(q)
    t = cB - torch.einsum("...ij,...j->...i", R, cA)
    return integrate_trans(R, t)


def _weighted_moments(A, B, weights, weight_threshold):
    """(weights, centroids cA, cB, centred A and B, the cross-covariance H
    and max(max|H|, 1e-12)) of a weighted Kabsch."""
    A = A.float()
    B = B.float()
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=torch.float32,
                             device=A.device)
    weights = torch.where(weights < weight_threshold,
                          torch.zeros_like(weights), weights)
    wsum = torch.sum(weights, -1, keepdim=True) + 1e-6
    cA = torch.sum(A * weights[..., None], -2) / wsum
    cB = torch.sum(B * weights[..., None], -2) / wsum
    Am, Bm = A - cA[..., None, :], B - cB[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", Am * weights[..., None], Bm)
    scale = torch.clamp(H.abs().amax(dim=(-1, -2), keepdim=True), min=1e-12)
    return weights, cA, cB, Am, Bm, H, scale


def kabsch(A: torch.Tensor, B: torch.Tensor,
           weights: torch.Tensor | None = None,
           weight_threshold: float = 0.0) -> torch.Tensor:
    """Weighted rigid alignment by the Jacobi eigensolver: trans [..., 4, 4]
    with B ~ trans(A). A, B: [..., N, 3]; weights: [..., N] (pad rows ->
    weight 0), those under `weight_threshold` taken as 0.

    The centroids divide by sum(w) + 1e-6; the Horn matrix of H / max|H|
    (H the centred cross-covariance, max|H| at least 1e-12); the quaternion
    is the eigenvector of the first largest eigenvalue; t = cB - R cA. All
    weights 0 give the identity."""
    _, cA, cB, _, _, H, scale = _weighted_moments(A, B, weights,
                                                  weight_threshold)
    evals, evecs = jacobi_eigh(horn_profile_matrix(H / scale))
    idx = torch.argmax(evals, dim=-1)
    q = torch.gather(evecs, -1, idx[..., None, None].expand(
        evecs.shape[:-1] + (1,)))[..., 0]
    R = quat_to_rotmat(q)
    t = cB - torch.einsum("...ij,...j->...i", R, cA)
    return integrate_trans(R, t)
