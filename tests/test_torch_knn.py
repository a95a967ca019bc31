"""eyoc_tpu_torch.ops.knn.masked_argmin (plain version of kernel K2) against
eyoc_tpu.ops.knn.masked_argmin: indices bit-equal, squared distances within
1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eyoc_tpu.ops.knn import masked_argmin as jargmin
from eyoc_tpu_torch.ops.knn import masked_argmin


def separated(rng, nq, nr, dim, gap=1e-3):
    """Queries whose first and second nearest valid refs differ by > gap."""
    q = rng.normal(size=(nq, dim)).astype(np.float32)
    r = rng.normal(size=(nr, dim)).astype(np.float32)
    qm = rng.random(nq) < 0.9
    rm = rng.random(nr) < 0.9
    d2 = ((q[:, None] - r[None]) ** 2).sum(-1) + np.where(rm, 0.0, 1e30)
    two = np.sort(d2, axis=1)[:, :2]
    qm &= (two[:, 1] - two[:, 0]) > gap * np.maximum(two[:, 0], 1.0)
    return q, qm, r, rm


@pytest.mark.parametrize("nq,nr,dim", [
    (700, 900, 32),      # Nq not a multiple of the 512-row tile
    (512, 300, 32),
    (1000, 1200, 3),     # the GT-pair path's coordinates
    (33, 65, 16),
])
def test_masked_argmin_matches_jax(nq, nr, dim):
    rng = np.random.default_rng(nq + nr + dim)
    q, qm, r, rm = separated(rng, nq, nr, dim)
    assert (~qm).any() and (~rm).any()
    dj, ij = jargmin(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                     jnp.asarray(rm))
    dt, it = masked_argmin(torch.from_numpy(q), torch.from_numpy(qm),
                           torch.from_numpy(r), torch.from_numpy(rm))
    assert it.dtype == torch.int32
    assert np.array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    assert (it.numpy()[~qm] == 0).all() and (dt.numpy()[~qm] == 1e30).all()
    assert rm[it.numpy()[qm]].all()


def test_all_refs_masked_picks_first_nearest_like_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    r = rng.normal(size=(30, 32)).astype(np.float32)
    qm = np.ones(20, bool)
    rm = np.zeros(30, bool)
    _, ij = jargmin(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                    jnp.asarray(rm))
    _, it = masked_argmin(torch.from_numpy(q), torch.from_numpy(qm),
                          torch.from_numpy(r), torch.from_numpy(rm))
    assert np.array_equal(np.asarray(ij), it.numpy())
