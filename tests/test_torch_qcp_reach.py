"""The f32 QCP solve's own rounding reach in the SC2-PCR pose checks
(chip_smoke.py:_qcp_reach), against the f32 plain solve
(geometry/svd3.kabsch_qcp):

- on weighted sets whose Horn gap runs from about 1e-2 to 1 of max|H|
  (near-collinear rows in random directions, so that the two leading
  eigenvalues close up; each a random pose, numpy seeds), the f32 solve's
  rotation stays within the reach of the moments' rounding (2^-24 E / gap)
  plus the QCP term, at a ratio of at most QCP_RATIO, while the moments'
  reach alone is exceeded by a factor that grows as the gap shrinks;
- analytic cases: a diagonal H under the identity (a diagonal Horn matrix:
  every off-diagonal minor is 0, so the term is exactly 0 and the f32 solve
  gives the identity bit for bit), and the root's reach carried into the
  adjugate and the polish, which to first order turns the quaternion by
  d_lam |sum_j rho_j v_j[col] v_j / (v1[col] (lam_1 - lam_j))|, rho_j =
  ((lam_j + lam_upper) / (lam_1 + lam_upper))^2, a rotation of 2 sqrt(2)
  times that (|dR|_F)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from eyoc_tpu_torch.geometry import svd3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only wait on each other, and
    stall when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


K = 12                # rows a set, as a consensus set of k2 rows
SETS = 300            # sets a spread
# the f32 solve's rotation error over the new reach (the QCP term summed
# over its sources at unit constants: a first-order reach, not a proof)
QCP_RATIO = 2.0


def rotation(rng, n, scale):
    """n rotation matrices exp([v]x), v ~ N(0, scale^2 I)."""
    v = rng.normal(0.0, scale, (n, 3))
    th = np.linalg.norm(v, axis=-1)[:, None, None]
    k = v / np.maximum(th[..., 0], 1e-12)
    Kx = np.zeros((n, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    Kx = Kx - Kx.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def sets(seed, spread):
    """SETS weighted sets of K rows: a segment of 20 m with a spread of
    `spread` times that across it, turned to a random direction, moved by
    a random pose, 5% of the spread of noise; f32 rows and weights."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-10, 10, (SETS, K, 3)) * np.array([1.0, spread, spread])
    a = np.einsum("nij,nkj->nki", rotation(rng, SETS, 2.0), a)
    b = (np.einsum("nij,nkj->nki", rotation(rng, SETS, 0.6), a)
         + rng.normal(0, 0.05 * spread, (SETS, K, 3))
         + rng.uniform(-5, 5, (SETS, 1, 3)))
    w = rng.uniform(0.2, 1.0, (SETS, K))
    w = w / (w.sum(-1, keepdims=True) + 1e-6)
    return (torch.tensor(a, dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32),
            torch.tensor(w, dtype=torch.float32))


def ratios(a, b, w):
    """(Horn gap, the f32 solve's |dR|_F from the f64 solve over the
    moments' reach, over the moments' reach plus the QCP term) for the sets
    that pin a pose."""
    a64, b64, w64 = a.double(), b.double(), w.double()
    T64, unit, _, pinned = cs._solve64(a64, b64, w64)
    T32 = svd3.kabsch_qcp(a, b, w).double()
    err = (T32[:, :3, :3] - T64[:, :3, :3]).flatten(-2).norm(dim=-1)
    moments = cs.U32 * unit
    full = moments + cs._qcp_reach(a64, b64, w64)
    Hn = cs._moments64(a64, b64, w64)[5]
    ev = torch.linalg.eigvalsh(svd3.horn_profile_matrix(Hn))
    gap = ev[:, 3] - ev[:, 2]
    p = pinned
    return gap[p], (err / moments)[p], (err / full)[p]


@pytest.mark.parametrize("spread,seed", [(1.0, 0), (0.1, 1), (0.05, 2)])
def test_qcp_term_bounds_the_f32_solve(spread, seed):
    gap, old, new = ratios(*sets(seed, spread))
    assert gap.numel() >= 100
    assert float(new.max()) <= QCP_RATIO, float(new.max())


def test_moments_reach_alone_falls_short_as_the_gap_shrinks():
    """Without the QCP term the largest ratio grows about as 1 / gap: at
    gaps of 1e-2 to 3e-2 the f32 solve lies far past the moments' reach,
    at gaps near 1 only a few times past it."""
    gap_w, old_w, _ = ratios(*sets(0, 1.0))
    gap_n, old_n, new_n = ratios(*sets(2, 0.05))
    small = gap_n < 3e-2
    assert int(small.sum()) >= 50 and float(gap_w.min()) > 0.3
    wide, narrow = float(old_w.max()), float(old_n[small].max())
    assert wide < 20.0
    assert narrow > 100.0 and narrow > 10.0 * wide
    assert float(new_n[small].max()) <= QCP_RATIO


def test_diagonal_horn_matrix_has_no_qcp_term():
    """16 rows on the axes at integer coordinates in +- pairs, weights
    1/16, b = a: every sum is exact, the centroids are 0 and H is diagonal;
    so is the Horn matrix, every cofactor off its column is 0 in any
    rounding, the term is exactly 0 and the f32 solve gives the identity."""
    rng = np.random.default_rng(3)
    a = np.zeros((4, 16, 3))
    for i in range(3):
        a[:, i:8:3, i] = rng.integers(1, 6, (4, len(range(i, 8, 3))))
    a[:, 8:] = -a[:, :8]
    a64 = torch.tensor(a)
    w = torch.full((4, 16), 1.0 / 16, dtype=torch.float64)
    Hn = cs._moments64(a64, a64, w)[5]
    assert torch.equal(Hn, torch.diag_embed(torch.diagonal(Hn, dim1=-2,
                                                           dim2=-1)))
    assert torch.equal(cs._qcp_reach(a64, a64, w),
                       torch.zeros(4, dtype=torch.float64))
    T32 = svd3.kabsch_qcp(a64.float(), a64.float(), w.float())
    assert torch.equal(T32[:, :3, :3], torch.eye(3).expand(4, 3, 3))


def test_root_reach_carried_into_the_eigenvector_in_closed_form():
    rng = np.random.default_rng(4)
    a, b, w = (x.double() for x in sets(5, 0.3))
    Hn, lam = cs._moments64(a, b, w)[5:]
    N4 = svd3.horn_profile_matrix(Hn)
    x = cs._newton64(Hn, lam)
    q0, col, _ = cs._qcp_tail64(N4, lam, x)
    ev, V = torch.linalg.eigh(N4)
    keep = (ev[:, 3] - ev[:, 2]) > 0.1
    d = 1e-9 * torch.from_numpy(rng.uniform(0.5, 2.0, x.shape))
    q = cs._qcp_tail64(N4, lam, x + d, col)[0]
    got = (svd3.quat_to_rotmat(q) - svd3.quat_to_rotmat(q0)).flatten(
        -2).norm(dim=-1)
    v1 = V[..., 3]
    c1 = torch.gather(v1, -1, col[:, None])[:, 0]
    turn = torch.zeros_like(V[..., 0])
    for j in range(3):
        rho = ((ev[:, j] + lam) / (ev[:, 3] + lam)) ** 2
        vj = V[..., j]
        cj = torch.gather(vj, -1, col[:, None])[:, 0]
        turn = turn + (rho * cj / (c1 * (ev[:, 3] - ev[:, j])))[:, None] * vj
    want = 2.0 * np.sqrt(2.0) * d * turn.norm(dim=-1)
    assert int(keep.sum()) >= 100
    assert torch.allclose(got[keep], want[keep], rtol=2e-3, atol=0)
