"""The valid step's solver: eyoc_tpu_torch.geometry.robust (and se3's axis
rotations, metrics.corr_dist) against eyoc_tpu, on the same numpy inputs.

- rot_x / rot_y / rot_z, _small_angle_trans, _normal_equations and
  corr_dist against the JAX functions (f32; the normal equations within
  1e-5 relative, each a sum of 500 rows);
- est_quad_linear_robust_plain against the jitted JAX function on
  tests/test_geometry.py's three IRLS cases (seeds 8, 9, 10: clean, 20%
  outliers, garbage rows masked), a KITTI-scale case (N = 5000 over +-50 m,
  30% inliers, 10% of the rows masked) and a problem with no valid row
  (the identity), batched in one call; each valid source row moves at
  most POSE_TOL between the two poses (20 f32 rounds in two sum orders);
  and against a numpy f64 IRLS of the same rounds within F64_TOL;
- K19's reformulation (`est_quad_linear_robust_k19_plain`: its row
  ownership, sum tree, elimination and pose arithmetic) against the plain
  version on the same problems, within POSE_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry import metrics as jmetrics
from eyoc_tpu.geometry import robust as jrobust
from eyoc_tpu.geometry import se3 as jse3
from eyoc_tpu_torch.geometry import metrics, robust, se3
from test_geometry import random_trans


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


POSE_TOL = 2e-5       # m, f32 against f32 (two sum orders, two solves)
F64_TOL = 5e-5        # m, f32 against the f64 rounds


def irls_cases():
    """[5, 5000, 3] x 2 and [5, 5000] bool: the three IRLS cases of
    tests/test_geometry.py in the first 500 rows (the rest masked), the
    KITTI-scale case, and a problem with no valid row."""
    n = 5000
    src = np.zeros((5, n, 3), np.float32)
    tgt = np.zeros((5, n, 3), np.float32)
    mask = np.zeros((5, n), bool)
    for b, seed in enumerate((8, 9, 10)):
        rng = np.random.default_rng(seed)
        T = random_trans(rng, magnitude=0.2, tmax=1.0)
        A = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
        B = A @ T[:3, :3].T + T[:3, 3]
        m = np.ones(500, bool)
        if seed == 9:
            B[:100] += rng.uniform(-10, 10, (100, 3))
        if seed == 10:
            A[400:] = 1e3
            B[400:] = -1e3
            m[400:] = False
        src[b, :500], tgt[b, :500], mask[b, :500] = A, B, m
    rng = np.random.default_rng(12)
    T = random_trans(rng, magnitude=0.2, tmax=1.0)
    A = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    B = A @ T[:3, :3].T + T[:3, 3]
    k = int(0.7 * n)
    B[:k] = rng.uniform(-50, 50, (k, 3))
    B[k:] += rng.normal(0, 0.02, (n - k, 3))
    src[3], tgt[3], mask[3] = A, B, rng.random(n) >= 0.1
    src[4] = rng.uniform(-50, 50, (n, 3))
    tgt[4] = rng.uniform(-50, 50, (n, 3))
    return src, tgt, mask


@pytest.fixture(scope="module")
def cases():
    src, tgt, mask = irls_cases()
    jfn = jax.jit(jax.vmap(lambda a, b, m: jrobust.est_quad_linear_robust(
        a, b, mask=m)))
    want = np.asarray(jfn(jnp.asarray(src), jnp.asarray(tgt),
                          jnp.asarray(mask)))
    return src, tgt, mask, want


def displacement(Ta, Tb, src, mask):
    """[B] largest distance between a valid source row warped by Ta and by
    Tb, in f64 (0 where no row is valid)."""
    out = np.zeros(len(src))
    for b in range(len(src)):
        p = np.asarray(src[b], np.float64)[mask[b]]
        if len(p):
            Ta_, Tb_ = np.asarray(Ta[b], np.float64), np.asarray(Tb[b],
                                                                 np.float64)
            d = p @ (Ta_[:3, :3] - Tb_[:3, :3]).T + (Ta_[:3, 3] - Tb_[:3, 3])
            out[b] = np.linalg.norm(d, axis=1).max()
    return out


def irls_f64(src, tgt, mask, num_iters=20):
    """The same rounds in numpy f64, over the valid rows."""
    p = np.asarray(src, np.float64)[mask]
    q = np.asarray(tgt, np.float64)[mask]
    w = np.ones(len(p))
    T, par = np.eye(4), 1.0
    for i in range(num_iters):
        if i > 0 and i % 5 == 0:
            par /= 2.0
        x, y, z = p.T
        zero, one = np.zeros_like(x), np.ones_like(x)
        J = np.stack([np.stack([zero, z, -y, one, zero, zero], -1),
                      np.stack([-z, zero, x, zero, one, zero], -1),
                      np.stack([y, -x, zero, zero, zero, one], -1)], 1)
        Jw = J * (w * w)[:, None, None]
        M = np.einsum("nki,nkj->ij", Jw, J) + 1e-6 * np.eye(6)
        v = np.einsum("nki,nk->i", Jw, q - p)
        t = np.linalg.solve(M, v)
        c, s = np.cos(t[:3]), np.sin(t[:3])
        rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
        ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
        rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        Ti = np.eye(4)
        Ti[:3, :3], Ti[:3, 3] = rz @ ry @ rx, t[3:]
        p = p @ Ti[:3, :3].T + Ti[:3, 3]
        w = par / (np.linalg.norm(p - q, axis=1) + par)
        T = Ti @ T
    return T


def test_axis_rotations_match_jax():
    theta = np.random.default_rng(0).uniform(-3, 3, 7).astype(np.float32)
    for jf, tf in ((jse3.rot_x, se3.rot_x), (jse3.rot_y, se3.rot_y),
                   (jse3.rot_z, se3.rot_z)):
        np.testing.assert_allclose(tf(torch.from_numpy(theta)).numpy(),
                                   np.asarray(jf(jnp.asarray(theta))),
                                   rtol=0, atol=1e-6)


def test_small_angle_trans_and_normal_equations_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.1, (4, 6)).astype(np.float32)
    want = np.asarray(jax.vmap(jrobust._small_angle_trans)(jnp.asarray(x)))
    got = robust._small_angle_trans(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    p = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    q = (p + rng.normal(0, 0.5, p.shape)).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    M_j, v_j = jax.jit(jrobust._normal_equations)(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    M, v = robust._normal_equations(torch.from_numpy(p), torch.from_numpy(q),
                                    torch.from_numpy(w))
    for got, want in ((M, M_j), (v, v_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_corr_dist_matches_jax():
    rng = np.random.default_rng(2)
    T_est = random_trans(rng, magnitude=0.3, tmax=2.0)
    T_gt = random_trans(rng, magnitude=0.3, tmax=2.0)
    xyz0 = rng.uniform(-30, 30, (300, 3)).astype(np.float32)
    xyz1 = rng.uniform(-30, 30, (300, 3)).astype(np.float32)
    mask = rng.random(300) < 0.6
    t = [torch.from_numpy(a) for a in (T_est, T_gt, xyz0, xyz1, mask)]
    j = [jnp.asarray(a) for a in (T_est, T_gt, xyz0, xyz1, mask)]
    for m in (True, False):
        got = metrics.corr_dist(*t[:3], mask=t[4] if m else None)
        want = jmetrics.corr_dist(*j[:4], mask=j[4] if m else None)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = metrics.corr_dist(*t[:3], mask=torch.zeros(300, dtype=torch.bool))
    assert float(empty) == 0.0


def test_irls_plain_matches_jax_and_f64(cases):
    src, tgt, mask, want = cases
    got = robust.est_quad_linear_robust_plain(
        torch.from_numpy(src), torch.from_numpy(tgt),
        mask=torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[4], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(want[4], np.eye(4, dtype=np.float32))
    assert displacement(got, want, src, mask).max() <= POSE_TOL
    f64 = np.stack([irls_f64(src[b], tgt[b], mask[b]) for b in range(5)])
    assert displacement(got, f64, src, mask).max() <= F64_TOL
    # the three cases recover their poses as tests/test_geometry.py asks
    for b, seed in enumerate((8, 9, 10)):
        T = random_trans(np.random.default_rng(seed), magnitude=0.2,
                         tmax=1.0)
        err = np.linalg.norm(got[b, :3, 3] - T[:3, 3])
        assert err < (0.2 if seed == 9 else 0.05)


def test_k19_reformulation_matches_plain(cases):
    src, tgt, mask, _ = cases
    s, t, m = (torch.from_numpy(a) for a in (src, tgt, mask))
    got = robust.est_quad_linear_robust_k19_plain(s, t, m).numpy()
    plain = robust.est_quad_linear_robust_plain(s, t, mask=m).numpy()
    np.testing.assert_array_equal(got[4], np.eye(4, dtype=np.float32))
    assert displacement(got, plain, src, mask).max() <= POSE_TOL


def test_irls_wrapper_on_cpu_is_the_plain_version(cases):
    src, tgt, mask, _ = cases
    s, t, m = (torch.from_numpy(a[:2]) for a in (src, tgt, mask))
    assert torch.equal(robust.est_quad_linear_robust(s, t, m),
                       robust.est_quad_linear_robust_plain(s, t, mask=m))
    one = robust.est_quad_linear_robust(s[0], t[0], m[0])
    assert one.shape == (4, 4)
