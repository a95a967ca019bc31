"""Sync-BN (sparse/norm.py: the batch norm's sums all_reduce'd over a
process group, the backward's K21 in its two-launch form around a second
all_reduce) at world size 2 over gloo on the CPU, against eyoc_tpu's
masked_batch_norm_fb under shard_map on 2 of conftest's virtual CPU
devices, its statistics psum'd over `dp` and jax.grad taken through the
psum (which transposes to a psum: each rank's dX sees every rank's loss).

Each rank holds 700 rows of 32 channels (a mask keeps ~70%); loss = sum(y
* w) on each rank. Compared, bare and with the ReLU tail: y (atol 1e-5),
the new running mean and variance (rtol 1e-5, atol 1e-6: the global n,
unbiased), dX (atol 1e-5) and each rank's dscale and dbias (rtol 1e-4,
atol 1e-5; JAX's per-device grads of the replicated parameters). The
workers run tests/ddp_worker.py through torchrun and import no JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from eyoc_tpu.sparse.norm import BatchNormState, masked_batch_norm_fb
from ddp_worker import run_ranks

M, C = 704, 32


def jax_reference(x, mask, scale, bias, mean, var, w, relu):
    """[2, M, C] per device: (y, dx, dscale, dbias) and the new state."""
    mesh = Mesh(jax.devices()[:2], ("dp",))

    def per_device(x, mask, w, scale, bias):
        x, mask, w = x[0], mask[0], w[0]

        def loss(x, scale, bias):
            fb = x.reshape(M // 8, 8 * C)
            y, st = masked_batch_norm_fb(
                fb, mask.reshape(M // 8, 8), scale, bias,
                BatchNormState(mean, var), momentum=0.05, axis_name="dp")
            y = y.reshape(M, C)
            if relu:
                y = jax.nn.relu(y)
            return jnp.sum(y * w), (y, st)

        (_, (y, st)), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(x, scale, bias)
        return (y[None], g[0][None], g[1][None], g[2][None],
                st.mean[None], st.var[None])

    f = jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P(), P()),
        out_specs=(P("dp"),) * 6, check_vma=False))
    return [np.asarray(a) for a in f(x, mask, w, scale, bias)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (2, M, C)).astype(np.float32)
    x[1] += 0.5                      # the two ranks' rows differ in mean
    mask = rng.uniform(size=(2, M)) < 0.7
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    mean = rng.normal(0, 0.1, C).astype(np.float32)
    var = rng.uniform(0.5, 1.5, C).astype(np.float32)
    w = rng.normal(size=(2, M, C)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(
        x=x, mask=mask, scale=scale, bias=bias, mean=mean, var=var,
        w=w).items()}
    outs = run_ranks("sync_bn", t, tmp_path_factory.mktemp("sync_bn"))
    return (x, mask, scale, bias, mean, var, w), outs


@pytest.mark.parametrize("tail", ["bare", "relu"])
def test_sync_bn_matches_psum(case, tail):
    args, outs = case
    y, dx, dscale, dbias, new_mean, new_var = jax_reference(
        *args, relu=tail == "relu")
    for r, out in enumerate(outs):
        got = out[tail]
        np.testing.assert_allclose(got["y"].numpy(), y[r], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["mean"].numpy(), new_mean[r],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["var"].numpy(), new_var[r],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dx"].numpy(), dx[r], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dscale"].numpy(), dscale[r],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["dbias"].numpy(), dbias[r],
                                   rtol=1e-4, atol=1e-5)
    # the statistics are global: both ranks' running statistics agree
    assert torch.equal(outs[0][tail]["var"], outs[1][tail]["var"])
