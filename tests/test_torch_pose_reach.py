"""The consensus weights' rounding reach of the SC2-PCR pose checks
(chip_smoke.py:_weight_reach), on known perturbations, for both f64 solves
(`_solve64`: the QCP Kabsch and the Jacobi one):

- under a pure translation (b = a + t) every weighting gives R = I and
  the translation t W / (W + 1e-6), W = sum w: the reach is that
  fraction's, |t| 1e-6 sum_j d_j / (W + 1e-6)^2 (d below);
- with every source point at the origin the Horn matrix is 0, R stays I
  and t = sum w b / (sum w + 1e-6): moving weight j by d_j moves the pose
  by d_j (b_j - t) / (sum w + 1e-6), so the reach is sum_j d_j |b_j - t| /
  (sum w + 1e-6), d_j = 2^-24 iters k2 |w_j|;
- on a generic problem the reach bounds, to first order, the move of every
  row under the weights moved by d in any combination of signs."""

import numpy as np
import pytest
import torch

import chip_smoke as cs


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


ITERS, K2 = 20, 12


def reach(a, b, w, jacobi):
    solved = cs._solve64(a, b, w, jacobi=jacobi)
    return cs._weight_reach(a, b, w, jacobi, ITERS, K2, solved), solved


def weights(rng, shape):
    w = rng.uniform(0.2, 1.0, shape)
    return torch.from_numpy(w / (w.sum(-1, keepdims=True) + 1e-6))


@pytest.mark.parametrize("jacobi", [False, True])
def test_pure_translation_moves_only_by_the_regularizer(jacobi):
    """b = a + t: R = I for every weighting and the translation is t W /
    (W + 1e-6), W = sum w, which moves by d_j t 1e-6 / (W + 1e-6)^2."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(-10, 10, (3, K2, 3)))
    t = torch.tensor([1.5, -2.0, 0.25], dtype=torch.float64)
    w = weights(rng, (3, K2))
    (rot, off), _ = reach(a, a + t, w, jacobi)
    assert float(rot.max()) < 1e-12
    W = w.sum(-1) + 1e-6
    d = 2.0 ** -24 * ITERS * K2 * w
    want = float(t.norm()) * 1e-6 * d.sum(-1) / W ** 2
    assert torch.allclose(off, want, rtol=1e-3, atol=0)


@pytest.mark.parametrize("jacobi", [False, True])
def test_translation_only_poses_move_by_their_derivative(jacobi):
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.uniform(-10, 10, (3, K2, 3)))
    a = torch.zeros_like(b)
    w = weights(rng, (3, K2))
    (rot, off), (T, _, _, _) = reach(a, b, w, jacobi)
    assert float(rot.max()) == 0.0
    W = w.sum(-1, keepdim=True) + 1e-6
    t = (w[..., None] * b).sum(-2) / W
    assert torch.equal(T[..., :3, :3], torch.eye(3, dtype=torch.float64)
                       .expand(3, 3, 3))
    assert torch.allclose(T[..., :3, 3], t, rtol=0, atol=1e-12)
    d = 2.0 ** -24 * ITERS * K2 * w
    want = (d * (b - t[:, None]).norm(dim=-1) / W).sum(-1)
    assert torch.allclose(off, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("jacobi", [False, True])
def test_bounds_every_sign_of_the_weights_rounding(jacobi):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(-20, 20, (K2, 3)))
    ang = 0.3
    R = torch.tensor([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    b = a @ R.T + torch.tensor([2.0, -1.0, 0.5]) \
        + torch.from_numpy(rng.normal(0, 0.3, (K2, 3)))
    w = weights(rng, K2)
    (rot, off), (T, _, cA, _) = reach(a, b, w, jacobi)
    rows = torch.from_numpy(rng.uniform(-40, 40, (200, 3)))
    lever = float((rows - cA).norm(dim=-1).max())
    bound = float(rot) * lever + float(off)
    d = 2.0 ** -24 * ITERS * K2 * w
    moved = []
    for _ in range(32):
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], K2))
        Tm = cs._solve64(a, b, w + sign * d, jacobi=jacobi)[0]
        D = Tm - T
        moved.append(float((rows @ D[:3, :3].T + D[:3, 3]).norm(dim=-1)
                           .max()))
    assert 0 < max(moved) <= bound * 1.001
    # the bound is first order in d, not loose by orders of magnitude
    assert max(moved) > 0.05 * bound
