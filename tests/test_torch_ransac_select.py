"""K16's two-stage selection on the CPU: the top `full_verify_top` coarse
counts that `ransac_hypotheses_topk` keeps, against the JAX package.

- `ransac_select_plain`, the kernel's selection step for step (the
  survivors' histogram, the threshold count, the ties at it in index order,
  the lowest-index failing hypotheses where fewer than k survive, one sort
  of the composite keys), is bit-equal to `topk` and to `lax.top_k` (JAX,
  jitted) on the same counts: more than k survivors with ties at the
  threshold, fewer than k, none, every count equal, k = H, and H not a
  multiple of the kernel's 1024-hypothesis tile;
- `ransac_hypotheses_topk` on the CPU is `ransac_hypotheses_plain`, then
  `topk`, then the gathers, bit for bit, and its keep is
  `ransac_select_plain`'s;
- `ransac_registration` on the CPU, on the JAX package's own uniforms, in
  both routes, is bit-equal to the composition it replaced (every
  hypothesis's pose, `topk`, then K17 through `keep`), and its pose within
  1e-4 m and 1e-3 deg of `eyoc_tpu.registration.ransac`'s, its inlier count
  equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.registration import ransac as jransac
from eyoc_tpu_torch.registration import ransac
from test_torch_ransac import correspondences, pose_gap


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


S = 64


def counts_case(kind, seed):
    """(coarse [H] f32: counts 0..S, -1 where the edge check failed, k)."""
    rng = np.random.default_rng(seed)
    H, k = {"ties": (5000, 256), "few": (3000, 512), "none": (2000, 64),
            "equal": (2500, 300), "all": (1537, 1537),
            "ragged": (1537, 1000)}[kind]
    c = rng.binomial(S, 0.1, H).astype(np.float32)
    fail = rng.random(H) < 0.6
    if kind == "few":
        fail = rng.random(H) < 0.97
    elif kind == "none":
        fail[:] = True
    elif kind == "equal":
        c[:] = 7.0
    c[fail] = -1.0
    return c, k


@functools.lru_cache(maxsize=None)
def _jax_top_k(k):
    return jax.jit(lambda x: jax.lax.top_k(x, k)[1])


@pytest.mark.parametrize("kind", ["ties", "few", "none", "equal", "all",
                                  "ragged"])
def test_select_plain_matches_top_k(kind):
    coarse, k = counts_case(kind, len(kind))
    surv = int((coarse >= 0).sum())
    c = torch.from_numpy(coarse)
    got = ransac.ransac_select_plain(c, k, S)
    assert got.dtype == torch.int32 and got.shape == (k,)
    assert torch.equal(got, ransac.topk(c, k)[1].int())
    assert np.array_equal(got.numpy(), np.asarray(_jax_top_k(k)(coarse)))
    if kind == "ties":                 # the threshold count splits its ties
        thr = coarse[got.numpy()].min()
        assert (coarse == thr).sum() > (coarse[got.numpy()] == thr).sum()
        assert surv > k
    elif kind in ("few", "none"):      # failing hypotheses fill the rest
        assert surv < k and (coarse[got.numpy()] < 0).sum() == k - surv
    if kind in ("all", "ragged"):
        assert len(coarse) % 1024 != 0


@pytest.mark.parametrize("k", [32, 200])
def test_hypotheses_topk_cpu_is_plain_topk(k):
    src, tgt, valid, _ = correspondences(3, 256, 0.5, 200)
    rng = np.random.default_rng(3)
    u_tri = torch.from_numpy(rng.random((1500, 3)).astype(np.float32))
    u_sub = torch.from_numpy(rng.random(S).astype(np.float32))
    args = (*map(torch.from_numpy, (src, tgt, valid)), u_tri, u_sub, 0.3,
            0.9)
    trans, kept_c, keep, coarse = ransac.ransac_hypotheses_topk(*args, k)
    all_t, all_c = ransac.ransac_hypotheses_plain(*args)
    want = ransac.topk(all_c, k)[1]
    assert torch.equal(coarse, all_c)
    assert torch.equal(keep, want.int())
    assert torch.equal(kept_c, all_c[want])
    assert torch.equal(trans, all_t[want])
    assert torch.equal(keep, ransac.ransac_select_plain(coarse, k, S))


TWO = jransac.RansacConfig(num_hypotheses=2048, coarse_subset=64,
                           full_verify_top=128)
ONE = jransac.RansacConfig(num_hypotheses=512, coarse_subset=0)


@functools.partial(jax.jit, static_argnames=("H", "S"))
def jax_draws(key, H, S):
    """ransac_registration's uniforms (ransac.py:111-125)."""
    k_tri, k_sub = jax.random.split(key)
    return (jax.random.uniform(k_tri, (H, 3)),
            jax.random.uniform(k_sub, (max(S, 0),)))


def replaced_composition(src, tgt, valid, cfg, u_tri, u_sub):
    """The two routes as they ran before the two-stage entry: every
    hypothesis's pose, the top k by `topk`, K17 through `keep`."""
    staged = ransac.two_stage(cfg, src.shape[0])
    thr = cfg.distance_threshold
    trans, coarse = ransac.ransac_hypotheses_plain(
        src, tgt, valid, u_tri, u_sub if staged else None, thr,
        cfg.edge_length_ratio)
    keep = ransac.topk(coarse, cfg.full_verify_top)[1] if staged else None
    _, best = ransac.ransac_verify_plain(trans, coarse, keep, src, tgt,
                                         valid, thr)
    return ransac.ransac_polish_plain(trans, best, src, tgt, valid, thr,
                                      cfg.polish_iters)


@pytest.mark.parametrize("route", ["two", "one"])
@pytest.mark.parametrize("inlier,nv", [(0.5, 512), (0.1, 300)])
def test_registration_unchanged(route, inlier, nv):
    cfg = TWO if route == "two" else ONE
    src, tgt, valid, _ = correspondences(nv + int(inlier * 10), 512, inlier,
                                         nv)
    key = jax.random.PRNGKey(nv)
    u_tri, u_sub = (torch.from_numpy(np.array(x)) for x in jax_draws(
        key, cfg.num_hypotheses, cfg.coarse_subset))
    tcfg = ransac.RansacConfig(**vars(cfg))
    assert ransac.two_stage(tcfg, 512) == (route == "two")
    ts, tt, tv = map(torch.from_numpy, (src, tgt, valid))
    T, inl = ransac.ransac_registration(ts, tt, tv, tcfg, (u_tri, u_sub))
    T_old, inl_old = replaced_composition(ts, tt, tv, tcfg, u_tri, u_sub)
    assert torch.equal(T, T_old) and int(inl) == int(inl_old)
    T_j, inl_j = jransac.ransac_registration(
        *map(jnp.asarray, (src, tgt, valid)), key, cfg)
    te, re = pose_gap(T.numpy(), np.asarray(T_j))
    assert te < 1e-4 and re < 1e-3, (te, re)
    assert int(inl) == int(inl_j)
