"""SC2-PCR's Jacobi kernels and options from their own CUDA sources (K23
and K24 in csrc/sc2_refine.cu, the IRLS's `refine_unroll` form of K15 and
K24, K3's bf16 form in csrc/sc2_power_iteration.cu) built for the host
with g++ against tests/cuda_host/ and run through the wrappers' launch code
on CPU tensors, against their plain versions on the four problems of
test_torch_sc2_emulated.py (N = 256, 64 seeds: 30% and 10% inliers, all but
3 rows invalid, no valid row):

- K23: the consensus sets, the fitness and the best seed bit-equal, each
  seed's pose within 1e-4 (rotation entries, and metres); and on a draw of
  3 problems x 150 seeds where most seeds are heads, with a seed that
  repeats the one before every 7 (its head's pose, bit for bit): the
  Jacobi solves run a thread a head over windows of 128 seeds that cross
  the problems, the heads compacted in each;
- K24: the rounds equal, the pose within 1e-5; a problem that runs all 20
  rounds;
- K15 and K24 at refine_unroll = 3: exactly 3 rounds for every problem, the
  pose within 1e-5, a problem with no valid row keeping its start pose;
- K3 (a one-block grid: the stand-in's grid barrier is the block's) f32
  within 1e-5 and bf16 within 1e-4 of max |v| of their plain versions, at
  N = 256 and a ragged N = 300.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.registration import sc2pcr as T
from eyoc_tpu_torch.utils import kernels
from test_torch_sc2_emulated import (CFG, HOST_HEADERS, N, creep, host_source,
                                     problems, upstream)

JACOBI = dataclasses.replace(CFG, qcp_kabsch=False)
# the sources and the flags of their host builds: K3's persistent grid is
# cut to one block
BUILDS = {"sc2_refine": [],
          "sc2_power_iteration": ["-DEYOC_K3_MAX_BLOCKS=1"]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{source: ctypes library} built by g++ from the CUDA sources."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' sources")
    out = tmp_path_factory.mktemp("host_jacobi")
    procs = {}
    for name, flags in BUILDS.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(host_source((kernels.CSRC / f"{name}.cu").read_text()))
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *flags, "-I",
             str(HOST_HEADERS), "-I", str(kernels.CSRC), "-o", str(lib),
             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' launch code calls the host build (as
    test_torch_sc2_emulated.py's fixture does)."""
    tickets = torch.zeros(256, dtype=torch.int32)
    monkeypatch.setattr(kernels, "ticket", lambda dev, count=1: tickets)

    def load(name, argtypes, symbol=None):
        fn = getattr(host_libs[name], f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)


def test_k23_k24_sources_match_plain(on_host):
    src, tgt, valid = problems(0)
    _, _, seed_ok, knn = upstream(src, tgt, valid)
    before = dict(kernels.launches)
    got = T._launch_k14(JACOBI, seed_ok, knn, src, tgt, valid)
    want = T.seed_transforms_batched_plain(JACOBI, seed_ok, knn, src, tgt,
                                           valid)
    trans_k, fit_k, best_k, fine_k = got
    trans_p, fit_p, best_p, fine_p = want
    assert torch.equal(fine_k, fine_p)
    assert torch.equal(fit_k, fit_p)
    assert torch.equal(best_k, best_p)
    assert float((trans_k - trans_p).abs().max()) < 1e-4
    assert float(fit_k[0].max()) > 20 and bool((fit_k[3] == -1).all())
    # the Jacobi solve, not the QCP one: the QCP kernel's poses differ
    qcp = T._launch_k14(CFG, seed_ok, knn, src, tgt, valid)[0]
    assert not torch.equal(qcp, trans_k)

    out_k, it_k = T._launch_k15(JACOBI, trans_p, best_p, src, tgt, valid, 20)
    out_p, it_p = T.sc2_irls_plain(JACOBI, trans_p, best_p, src, tgt, valid)
    assert torch.equal(it_k, it_p)
    assert float((out_k - out_p).abs().max()) < 1e-5
    assert int(it_k[3]) == 1
    assert torch.equal(out_k[3], trans_p[3, int(best_p[3])])
    counted = {k: kernels.launches[k] - before[k] for k in before}
    assert counted["sc2_seed_transforms_jacobi"] == 1
    assert counted["sc2_irls_jacobi"] == 1
    assert counted["sc2_seed_transforms"] == 1 and counted["sc2_irls"] == 0


def test_k23_where_most_seeds_are_heads(on_host):
    """150 seeds a problem of three, each a valid row of its own (its k1 columns
    from the plain top-k), every 7th repeating the seed before: at least
    80% of the seeds are heads, and head_poses' windows of 128 seeds
    straddle the problems."""
    # three problems at 30% inliers (all but 10 rows valid), whose seeds'
    # sets pin their poses
    src, tgt, valid = (torch.cat(x) for x in zip(*(
        [t[:1] for t in problems(seed)] for seed in range(3))))
    S = 150
    seeds = torch.stack([torch.nonzero(valid[b])[:S, 0] for b in range(3)])
    knn = torch.stack([T.sc2_seed_topk_plain(src[b], tgt[b], valid[b],
                                             seeds[b].int(), CFG.d_thre,
                                             CFG.k1) for b in range(3)])
    knn[:, 7::7] = knn[:, 6:-1:7]
    seed_ok = torch.ones((3, S), dtype=torch.bool)
    args = (JACOBI, seed_ok, knn.contiguous(), src, tgt, valid)
    trans_k, fit_k, best_k, fine_k = T._launch_k14(*args)
    trans_p, fit_p, best_p, fine_p = T.seed_transforms_batched_plain(*args)
    heads = torch.ones((3, S), dtype=torch.bool)
    heads[:, 1:] = (knn[:, 1:] != knn[:, :-1]).any(-1)
    assert int(heads.sum()) >= 0.8 * 3 * S
    assert not bool(heads[:, 7::7].any())
    assert torch.equal(fine_k, fine_p)
    assert torch.equal(fit_k, fit_p)
    assert torch.equal(best_k, best_p)
    assert float((trans_k - trans_p).abs().max()) < 1e-4
    assert torch.equal(trans_k[:, 7::7], trans_k[:, 6:-1:7])


def test_k24_source_runs_all_iterations(on_host):
    (s0, t0), (s1, t1) = creep(), creep(0, 1.0)
    src = torch.stack([s0, s1, s1])
    tgt = torch.stack([t0, t1, t1])
    valid = torch.ones((3, N), dtype=torch.bool)
    valid[2] = False
    trans = torch.eye(4).expand(3, 1, 4, 4).contiguous()
    best = torch.zeros(3, dtype=torch.int32)
    out_k, it_k = T._launch_k15(JACOBI, trans, best, src, tgt, valid, 20)
    out_p, it_p = T.sc2_irls_plain(JACOBI, trans, best, src, tgt, valid)
    assert it_p[0] == 20 and 1 < it_p[1] < 20 and it_p[2] == 1
    assert torch.equal(it_k, it_p)
    assert float((out_k - out_p).abs().max()) < 1e-5


@pytest.mark.parametrize("qcp", [True, False])
def test_unroll_sources_match_plain(on_host, qcp):
    """refine_unroll = 3: exactly 3 rounds for every problem, whatever its
    counts, from the best seeds' poses and from the identity (the creeping
    problem would run 20 rounds with the stop)."""
    cfg = dataclasses.replace(CFG, qcp_kabsch=qcp, refine_unroll=3)
    src, tgt, valid = problems(0)
    _, _, seed_ok, knn = upstream(src, tgt, valid)
    trans, _, best, _ = T.seed_transforms_batched_plain(cfg, seed_ok, knn,
                                                        src, tgt, valid)
    out_k, it_k = T._launch_k15(cfg, trans, best, src, tgt, valid, 20)
    out_p, it_p = T.sc2_irls_plain(cfg, trans, best, src, tgt, valid)
    assert it_k.tolist() == [3, 3, 3, 3] and torch.equal(it_k, it_p)
    assert float((out_k - out_p).abs().max()) < 1e-5
    assert torch.equal(out_k[3], trans[3, int(best[3])])

    s0, t0 = creep()
    eye = torch.eye(4).expand(1, 1, 4, 4).contiguous()
    zero = torch.zeros(1, dtype=torch.int32)
    ok = torch.ones((1, N), dtype=torch.bool)
    out_k, it_k = T._launch_k15(cfg, eye, zero, s0[None], t0[None], ok, 20)
    out_p, it_p = T.sc2_irls_plain(cfg, eye, zero, s0[None], t0[None], ok)
    assert int(it_k[0]) == 3 == int(it_p[0])
    assert float((out_k - out_p).abs().max()) < 1e-5
    # the per-pair plain version (the one held to JAX) runs the same rounds
    one = T._post_refine(cfg, eye[0, 0], s0, t0, ok[0])
    assert float((one - out_p[0]).abs().max()) < 1e-5


@pytest.mark.parametrize("n", [N, 300])
@pytest.mark.parametrize("bf16", [False, True])
def test_k3_source_matches_plain(on_host, n, bf16):
    """K3 and its bf16 form on a one-block grid against the plain
    compositions (SC materialized; with bf16, SC and each iterate rounded
    to bf16 before the product)."""
    rng = np.random.default_rng(n)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    out = rng.random(n) < 0.6
    tgt[out] = rng.uniform(-20, 20, (int(out.sum()), 3))
    valid = rng.random(n) > 0.1
    src, tgt, valid = map(torch.from_numpy, (src, tgt, valid))
    before = kernels.launches["sc2_power_iteration_bf16"]
    got = T._launch_k3(src, tgt, valid, 0.1, 20, bf16)
    want = T.sc2_power_iteration_plain(src, tgt, valid, 0.1, 20, bf16)
    err = float((got - want).abs().max())
    assert err <= (1e-4 if bf16 else 1e-5) * float(want.abs().max())
    assert kernels.launches["sc2_power_iteration_bf16"] - before == int(bf16)
    if bf16:
        # the rounding shows: the f32 vector lies several times further
        # from the bf16 plain version than the kernel does
        f32 = T.sc2_power_iteration_plain(src, tgt, valid, 0.1, 20)
        assert float((f32 - want).abs().max()) > 4 * err
