"""Whole `sc2_pcr` calls with SC2-PCR's TPU switches, the port's plain
path against eyoc_tpu.registration.sc2pcr.sc2_pcr on the CPU (the
problems of test_torch_sc2_jacobi.py: N = 300, seed_cap 60, 30% inliers):
qcp_kabsch=False; with it, refine_unroll = 3, bf16_power and approx_topk;
and with chunk_topk = 100 (three chunks: the two-level top-k). The fitness
equal and the pose within 1e-4 m and 1e-3 deg (every final pose here is
pinned by ~90 inliers)."""

import jax.numpy as jnp
import numpy as np
import pytest

from eyoc_tpu.geometry.metrics import rte
from eyoc_tpu.registration import sc2pcr as J
from eyoc_tpu_torch.registration import sc2pcr as T
from test_torch_sc2_jacobi import _one_torch_thread  # noqa: F401
from test_torch_sc2_jacobi import configs, problem
from test_torch_sc2pcr import rotation_gap_deg, tt

# option -> (its config fields, the numpy seed of its problem)
OPTIONS = {
    "jacobi": (dict(qcp_kabsch=False), 0),
    "jacobi_unroll_bf16_approx": (dict(qcp_kabsch=False, refine_unroll=3,
                                       bf16_power=True, approx_topk=True), 1),
    "chunked": (dict(qcp_kabsch=False, chunk_topk=100), 2),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_sc2_pcr_options_match_jax(option):
    fields, seed = OPTIONS[option]
    jc, tc = configs(**fields)
    src, tgt, valid = problem(seed)
    Tj, fj = J.sc2_pcr(jnp.asarray(src), jnp.asarray(tgt),
                       jnp.asarray(valid), jc)
    Tt, ft = T.sc2_pcr(*tt(src, tgt, valid), tc)
    assert np.array_equal(np.asarray(fj), ft.numpy())
    Tt = jnp.asarray(Tt.numpy())
    assert float(rte(Tj, Tt)) < 1e-4
    assert rotation_gap_deg(Tj, Tt) < 1e-3
    assert int((np.asarray(fj) > 0).sum()) > 0
