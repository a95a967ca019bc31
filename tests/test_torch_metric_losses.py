"""The three other metric losses and Adam / AdamW against the JAX package,
on the CPU.

(a) random_negative_contrastive_loss, triplet_loss and hardest_triplet_loss
    (eyoc_tpu/training/loss.py:193, :216, :242) on the JAX losses' own
    uniforms (their key splits): every returned value (rtol 1e-5, atol
    1e-6) and the gradient of a weighted sum of them with respect to both
    feature tables (autograd against jax.grad; rtol 1e-4, atol 1e-6: the
    hardest triplet's mined distance is recomputed from the gathered rows
    in the port and read off the Gram form in JAX). Three inputs: random
    features; one with invalid rows and invalid positives; and one of 12
    valid rows a cloud whose positives are near copies, where sampled and
    mined negatives are positive pairs (the masks must drop them).
(b) optim.adam / optim.adamw (torch.optim.Adam / AdamW) against
    adam_update / adamw_update over 3 steps with weight decay 1e-2 (rtol
    1e-5, atol 1e-7); an unknown optimizer name raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.training import loss as jloss
from eyoc_tpu.training.optim import adam_init, adam_update, adamw_update
from eyoc_tpu_torch.training import loss as tloss
from eyoc_tpu_torch.training.optim import adam, adamw, make_optimizer

D = 32
NEG_THRESH = 1.4


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


def features(rng, n, valid):
    f = rng.normal(size=(n, D)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return f * valid[:, None]


N, P = 300, 200       # every case has these shapes: one JAX compile a loss


def make_case(name):
    """(F0, m0, F1, m1, pos_i, pos_j, pos_valid) as numpy arrays."""
    rng = np.random.default_rng({"random": 0, "invalid": 1, "collide": 2}[name])
    m0 = np.ones(N, bool)
    m1 = np.ones(N, bool)
    if name == "collide":
        # 12 valid rows a cloud, cloud 1's row perm[i] a near copy of cloud
        # 0's row i; 24 valid positives (i, perm[i]), (i, perm[i - 1])
        n = 12
        m0[n:] = m1[n:] = False
        F0 = features(rng, N, m0)
        perm = rng.permutation(n)
        F1 = np.zeros_like(F0)
        F1[perm] = F0[:n] + 0.05 * rng.normal(size=(n, D)).astype(np.float32)
        pos_i = np.zeros(P, np.int32)
        pos_j = np.zeros(P, np.int32)
        pos_i[:2 * n] = np.concatenate([np.arange(n), np.arange(n)])
        pos_j[:2 * n] = np.concatenate([perm, np.roll(perm, 1)])
        pos_valid = np.arange(P) < 2 * n
        return F0, m0, F1, m1, pos_i, pos_j, pos_valid
    if name == "invalid":
        m0[rng.choice(N, 120, replace=False)] = False
        m1[rng.choice(N, 90, replace=False)] = False
    F0, F1 = features(rng, N, m0), features(rng, N, m1)
    pos_i = rng.choice(np.flatnonzero(m0), P).astype(np.int32)
    pos_j = rng.choice(np.flatnonzero(m1), P).astype(np.int32)
    pos_valid = np.ones(P, bool)
    if name == "invalid":
        pos_valid[rng.choice(P, 70, replace=False)] = False
    return F0, m0, F1, m1, pos_i, pos_j, pos_valid


NUM_NEG, NUM_POS, NUM_RAND, NUM_HN = 96, 64, 80, 48


def _u(k, n):
    return jax.random.uniform(k, (n,))


def _draws_contrastive(key):
    k0, k1 = jax.random.split(key)
    return (_u(k0, NUM_NEG), _u(k1, NUM_NEG), None, None, None)


def _draws_triplet(key):
    k_pos, k_rand, k_neg = jax.random.split(key, 3)
    return (None, None, _u(k_pos, NUM_POS), _u(k_rand, NUM_RAND),
            _u(k_neg, NUM_RAND))


def _draws_hardest_triplet(key):
    k0, k1, k_pos, k_rand, k_neg = jax.random.split(key, 5)
    return (_u(k0, NUM_HN), _u(k1, NUM_HN), _u(k_pos, NUM_POS),
            _u(k_rand, NUM_RAND), _u(k_neg, NUM_RAND))


# kind: (the JAX loss at the sizes above, the port's loss, the weights of the
# differentiated sum of its values, the JAX loss's uniforms from its key)
LOSSES = {
    "contrastive": (
        functools.partial(jloss.random_negative_contrastive_loss,
                          num_neg=NUM_NEG, neg_thresh=NEG_THRESH),
        tloss.random_negative_contrastive_loss, (1.0, 0.37),
        _draws_contrastive),
    "triplet": (
        functools.partial(jloss.triplet_loss, num_pos=NUM_POS,
                          num_rand_triplet=NUM_RAND, neg_thresh=NEG_THRESH),
        tloss.triplet_loss, (1.0, 0.37, 0.61), _draws_triplet),
    "hardest_triplet": (
        functools.partial(jloss.hardest_triplet_loss, num_pos=NUM_POS,
                          num_hn_samples=NUM_HN, num_rand_triplet=NUM_RAND,
                          neg_thresh=NEG_THRESH),
        tloss.hardest_triplet_loss, (1.0, 0.37, 0.61),
        _draws_hardest_triplet),
}


@functools.lru_cache(maxsize=None)
def value_and_grads(kind):
    """The JAX loss's values and its weighted sum's grads in F0 and F1,
    jitted once a loss kind."""
    jfn, _, weights, _ = LOSSES[kind]

    @jax.jit
    def run(F0, F1, m0, m1, pi, pj, pv, key):
        def f(F0, F1):
            vals = jfn(F0, m0, F1, m1, pi, pj, pv, key)
            return sum(w * v for w, v in zip(weights, vals)), vals
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(F0, F1)
    return run


@pytest.mark.parametrize("case", ["random", "invalid", "collide"])
@pytest.mark.parametrize("kind", sorted(LOSSES))
def test_loss_matches_jax(kind, case):
    _, tfn, weights, draws_of = LOSSES[kind]
    F0, m0, F1, m1, pi, pj, pv = make_case(case)
    key = jax.random.PRNGKey(7)
    (_, jvals), (jg0, jg1) = value_and_grads(kind)(
        *map(jnp.asarray, (F0, F1, m0, m1, pi, pj, pv)), key)
    u = [None if a is None else torch.from_numpy(np.array(a))
         for a in jax.jit(draws_of)(key)]

    tF0 = torch.from_numpy(F0).requires_grad_(True)
    tF1 = torch.from_numpy(F1).requires_grad_(True)
    *tvals, aux = tfn(tF0, torch.from_numpy(m0), tF1, torch.from_numpy(m1),
                      torch.from_numpy(pi), torch.from_numpy(pj),
                      torch.from_numpy(pv), tloss.LossDraws(*u),
                      neg_thresh=NEG_THRESH)
    assert len(tvals) == len(jvals) == len(weights)
    sum(w * v for w, v in zip(weights, tvals)).backward()
    for i, (t, j) in enumerate(zip(tvals, jvals)):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-5,
                                   atol=1e-6, err_msg=f"value {i}")
    np.testing.assert_allclose(tF0.grad.numpy(), np.asarray(jg0), rtol=1e-4,
                               atol=1e-6, err_msg="dF0")
    np.testing.assert_allclose(tF1.grad.numpy(), np.asarray(jg1), rtol=1e-4,
                               atol=1e-6, err_msg="dF1")
    assert float(tF0.grad.abs().sum()) > 0 and float(tF1.grad.abs().sum()) > 0
    if case == "collide":
        # some sampled or mined negatives are positive pairs, and dropped
        assert not bool(aux["keep"].all())
    if case == "invalid":
        # invalid rows are never sampled and get no gradient
        for g, m in ((tF0.grad, m0), (tF1.grad, m1)):
            assert float(g[torch.from_numpy(~m)].abs().sum()) == 0.0


# -------------------------------------------------------------------- (b)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_adam_matches_jax(name):
    rng = np.random.default_rng(3)
    shapes = {"a": (27, 4, 6), "b": (6,), "c": {"w": (5, 3), "b": (3,)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves]
    kw = dict(lr=0.01, betas=(0.9, 0.99), weight_decay=1e-2)
    opt = (adam if name == "Adam" else adamw)(tparams, **kw)
    assert type(opt) is type(make_optimizer(
        [torch.nn.Parameter(torch.zeros(1))], name, 0.01))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = adam_init(jp)
    update = jax.jit(functools.partial(
        adam_update if name == "Adam" else adamw_update, **kw))
    for _ in range(3):
        grads = [rng.normal(size=x.shape).astype(np.float32) for x in leaves]
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        jp, state = update(jp, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g) for g in grads]), state)
        for p, w in zip(tparams, jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-7)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer 'RMSprop'"):
        make_optimizer([torch.nn.Parameter(torch.zeros(1))], "RMSprop", 0.1)
