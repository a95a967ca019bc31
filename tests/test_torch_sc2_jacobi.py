"""SC2-PCR's TPU switches in the port's plain path against
eyoc_tpu.registration.sc2pcr on the CPU, on synthetic correspondences
(numpy seeds 0-2, N = 300 with 10 invalid rows, seed_cap 60, 30%
inliers):

- SC2PCRConfig: every field of the JAX config, with its default;
- stage by stage on JAX's own inputs: `_seed_transforms` with the Jacobi
  solve (fitness equal, the best pose within 1e-5), `_post_refine` with
  the Jacobi solve and with refine_unroll = 3 (within 1e-5), and
  `_power_iteration(bf16=True)` on the same SC matrix (within 1e-5 of max
  |v|; the f32 vector lies further off);
- whole `sc2_pcr` calls with each option: test_torch_sc2_jacobi_pcr.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.registration import sc2pcr as J
from eyoc_tpu_torch.registration import sc2pcr as T
from test_torch_sc2pcr import correspondences, tt

N, SEEDS = 300, 60
@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    common = dict(max_points=N, seed_cap=SEEDS, **kw)
    return J.SC2PCRConfig(**common), T.SC2PCRConfig(**common)


def problem(seed):
    return correspondences(seed, n=N)


def true_pose(seed):
    """The pose of `problem(seed)` (correspondences' draws, in order)."""
    rng = np.random.default_rng(seed)
    rng.uniform(-20, 20, (N, 3))
    a = rng.uniform(-0.5, 0.5)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.uniform(-3, 3, 3)
    return T


def test_config_fields_and_defaults_match_jax():
    j, t = J.SC2PCRConfig(), T.SC2PCRConfig()
    jf = {f.name: f.default for f in dataclasses.fields(j)}
    tf = {f.name: f.default for f in dataclasses.fields(t)}
    assert jf == tf
    assert j.num_seeds == t.num_seeds


def jax_upstream(cfg, src, tgt, valid):
    """JAX sc2_pcr's stages up to `_seed_transforms` (sc2pcr.py:272-306),
    jitted: (seeds, seed_ok, SC2)."""
    def run(s, t, v):
        pair_ok = v[:, None] & v[None, :]
        sd = jnp.linalg.norm(s[:, None] - s[None, :], axis=-1)
        td = jnp.linalg.norm(t[:, None] - t[None, :], axis=-1)
        cross = jnp.abs(sd - td)
        sc = jnp.clip(1.0 - cross ** 2 / cfg.d_thre ** 2, 0.0, None) * pair_ok
        hard = ((cross < cfg.d_thre) & pair_ok).astype(jnp.bfloat16)
        tight = ((cross < cfg.d_thre / 2) & pair_ok).astype(jnp.bfloat16)
        conf = J._power_iteration(sc, cfg.num_iterations) * v
        seeds, ok = J._pick_seeds(jnp.where(pair_ok, sd, jnp.inf), conf,
                                  cfg.nms_radius, cfg.num_seeds)
        SC2 = jax.lax.dot(jnp.take(tight, seeds, axis=0), tight,
                          preferred_element_type=jnp.float32)
        return seeds, ok, SC2 * jnp.take(hard, seeds, axis=0).astype(
            jnp.float32)
    return jax.jit(run)(jnp.asarray(src), jnp.asarray(tgt),
                        jnp.asarray(valid))


@pytest.mark.parametrize("seed", [0])
def test_seed_transforms_jacobi_matches_jax(seed):
    jc, tc = configs(qcp_kabsch=False)
    src, tgt, valid = problem(seed)
    seeds, ok, SC2 = jax_upstream(jc, src, tgt, valid)
    Tj, fj = jax.jit(lambda *a: J._seed_transforms(jc, *a))(
        seeds, ok, SC2, jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(valid))
    # the port's k1 columns: its plain K4 selection on JAX's seeds
    s, t, v = tt(src, tgt, valid)
    knn = T.sc2_seed_topk_plain(s, t, v, torch.from_numpy(
        np.array(seeds)), tc.d_thre, tc.k1)
    Tt, ft = T._seed_transforms(tc, torch.from_numpy(np.array(ok)), knn,
                                s, t, v)
    assert np.array_equal(np.asarray(fj), ft.numpy())
    assert float(np.abs(np.asarray(Tj) - Tt.numpy()).max()) < 1e-5


@pytest.mark.parametrize("unroll", [0, 3])
def test_post_refine_jacobi_matches_jax(unroll):
    jc, tc = configs(qcp_kabsch=False, refine_unroll=unroll)
    src, tgt, valid = problem(2)
    # a start 0.3 m and ~1.7 deg off the true pose, so the rounds move it
    a = 0.03
    turn = np.eye(4, dtype=np.float32)
    turn[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    start = (turn @ true_pose(2)).astype(np.float32)
    start[:3, 3] += 0.3
    Tj = jax.jit(lambda *x: J._post_refine(jc, *x))(
        jnp.asarray(start), jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(valid))
    Tt = T._post_refine(tc, *tt(start, src, tgt, valid))
    assert float(np.abs(np.asarray(Tj) - Tt.numpy()).max()) < 1e-5
    assert not np.allclose(np.asarray(Tj), start, atol=1e-3)


@pytest.mark.parametrize("seed", [1])
def test_bf16_power_iteration_matches_jax(seed):
    src, tgt, valid = problem(seed)
    pair_ok = valid[:, None] & valid[None, :]
    cross = np.asarray(jax.jit(lambda s, t: jnp.abs(
        jnp.linalg.norm(s[:, None] - s[None, :], axis=-1)
        - jnp.linalg.norm(t[:, None] - t[None, :], axis=-1)))(
            jnp.asarray(src), jnp.asarray(tgt)))
    sc = (np.clip(1.0 - cross ** 2 / 0.01, 0.0, None) * pair_ok).astype(
        np.float32)
    vj = np.asarray(jax.jit(lambda m: J._power_iteration(m, 20, bf16=True))(
        jnp.asarray(sc)))
    vt = T._power_iteration(torch.from_numpy(sc), 20, bf16=True).numpy()
    f32 = T._power_iteration(torch.from_numpy(sc), 20).numpy()
    err = float(np.abs(vj - vt).max())
    assert err <= 1e-5 * float(np.abs(vj).max())
    assert float(np.abs(f32 - vj).max()) > 4 * err
