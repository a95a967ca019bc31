"""eyoc_tpu_torch.geometry against eyoc_tpu.geometry on the same numpy
inputs (CPU, f32, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.geometry import metrics as jmetrics
from eyoc_tpu.geometry import se3 as jse3
from eyoc_tpu.geometry import svd3 as jsvd3
from eyoc_tpu_torch.geometry import metrics, se3, svd3


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


ATOL = 1e-5


def random_pose(rng, angle=0.5, trans=3.0):
    axis = rng.normal(size=3)
    R = np.asarray(jse3.rotation_from_axis_angle(
        jnp.asarray(axis, jnp.float32), jnp.float32(rng.uniform(-angle, angle))))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.uniform(-trans, trans, 3)
    return T


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_points(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (3, 50, 3)).astype(np.float32)
    T = np.stack([random_pose(rng) for _ in range(3)])
    close(jse3.transform_points(jnp.asarray(pts), jnp.asarray(T)),
          se3.transform_points(torch.from_numpy(pts), torch.from_numpy(T)))


def test_integrate_trans():
    rng = np.random.default_rng(3)
    R = np.stack([random_pose(rng)[:3, :3] for _ in range(4)])
    t = rng.normal(size=(4, 3)).astype(np.float32)
    close(jse3.integrate_trans(jnp.asarray(R), jnp.asarray(t)),
          se3.integrate_trans(torch.from_numpy(R), torch.from_numpy(t)))


@pytest.mark.parametrize("dim", [3, 32])
def test_pdist2(dim):
    rng = np.random.default_rng(dim)
    a = rng.uniform(-1, 1, (40, dim)).astype(np.float32)
    b = rng.uniform(-1, 1, (60, dim)).astype(np.float32)
    close(jmetrics.pdist2(jnp.asarray(a), jnp.asarray(b)),
          metrics.pdist2(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("seed", [0, 1])
def test_rte_rre_success(seed):
    rng = np.random.default_rng(seed)
    T0 = np.stack([random_pose(rng) for _ in range(6)])
    T1 = np.stack([random_pose(rng, angle=0.2, trans=1.0) @ T for T in T0])
    j0, j1 = jnp.asarray(T0), jnp.asarray(T1)
    t0, t1 = torch.from_numpy(T0), torch.from_numpy(T1)
    close(jmetrics.rte(j0, j1), metrics.rte(t0, t1))
    close(jmetrics.rre_deg(j0, j1), metrics.rre_deg(t0, t1), atol=1e-3)
    ok_j, _, _ = jmetrics.registration_success(j0, j1, 2.0, 5.0)
    ok_t, _, _ = metrics.registration_success(t0, t1, 2.0, 5.0)
    assert np.array_equal(np.asarray(ok_j), ok_t.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kabsch_qcp(seed):
    rng = np.random.default_rng(seed)
    S, N = 5, 40
    A = rng.uniform(-5, 5, (S, N, 3)).astype(np.float32)
    T = np.stack([random_pose(rng) for _ in range(S)])
    B = np.einsum("sij,snj->sni", T[:, :3, :3], A) + T[:, None, :3, 3]
    B = (B + rng.normal(0, 0.01, B.shape)).astype(np.float32)
    w = rng.uniform(0, 1, (S, N)).astype(np.float32)
    w[:, :5] = 0.0
    want = jsvd3.kabsch_qcp(jnp.asarray(A), jnp.asarray(B), jnp.asarray(w))
    got = svd3.kabsch_qcp(torch.from_numpy(A), torch.from_numpy(B),
                          torch.from_numpy(w))
    close(want, got)
    # and it recovers the pose it was given
    np.testing.assert_allclose(got.numpy(), T, atol=0.02)


def test_quaternion_helpers():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q[0] = 0.0                      # degenerate -> identity
    close(jsvd3.quat_to_rotmat(jnp.asarray(q)),
          svd3.quat_to_rotmat(torch.from_numpy(q)))
