"""SC2-PCR's kernels' own CUDA sources (K13 csrc/sc2_nms.cu, K14 and K15
csrc/sc2_refine.cu) built for the host with g++ against
tests/cuda_host/cuda_runtime.h and run through the wrappers' launch code
on CPU tensors, against the plain versions on four problems (N = 256, 64
seeds: 30% and 10% inliers, all but 3 rows invalid, no valid row):

- K13: seeds and seed_ok bit-equal (to `sc2_nms_plain` and to its plain
  mirror `sc2_nms_rank_plain`), on those problems and on tie-heavy cases:
  5 score levels, all zero, fewer local maxima than seeds, S = N, negative
  and -0.0 scores, a partial tile, B = 260 (several rank groups a block);
  a second call on the same flag words; the wrapper's error past its row
  cap;
- K14: the consensus sets (fine_sel), the fitness and the best seed
  bit-equal, each seed's pose within 1e-4 (rotation entries, and metres);
- K15: the iteration counts equal, the pose within 1e-5.

This checks the kernels' indexing, ranks, reductions and the QCP solve on
the CPU; what only the card can show (that nvcc takes the sources, the
real thread interleaving) is `chip_smoke.py`'s."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.registration import sc2pcr as T
from eyoc_tpu_torch.utils import kernels


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


HOST_HEADERS = Path(__file__).resolve().parent / "cuda_host"
SOURCES = ("sc2_nms", "sc2_refine")
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),.*?>>>\(", re.S)
DYNAMIC = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) "
                     r"(\w+)\[\];")


def host_source(text: str) -> str:
    """A CUDA source made buildable by g++ against cuda_host/: each launch
    `k<<<grid, block, smem, stream>>>(` becomes a HostLaunch call, and each
    `extern __shared__ T name[];` a pointer to the stand-in's dynamic
    shared memory."""
    text = DYNAMIC.sub(r"\1* const \2 = "
                       r"reinterpret_cast<\1*>(host_cuda::dynamic_shared);",
                       text)
    return LAUNCH.sub(r"HostLaunch{(unsigned)(\2), (unsigned)(\3)}(\1, ",
                      text)
N, SEEDS = 256, 64
CFG = T.SC2PCRConfig(max_points=N, seed_cap=SEEDS)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{source: ctypes library} built by g++ from the CUDA sources."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' sources")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for name in SOURCES:
        src = (kernels.CSRC / f"{name}.cu").read_text()
        cpp = out / f"{name}.cpp"
        cpp.write_text(host_source(src))
        lib = out / f"lib{name}.so"
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                               "-I", str(HOST_HEADERS), "-I",
                               str(kernels.CSRC), "-o", str(lib), str(cpp)],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' launch code calls the host build: kernels.load gives
    its entry points, the CUDA-only checks pass CPU tensors through, and
    the ticket words (K14's) are one zeroed CPU array."""
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


def problems(seed=0):
    """Four problems of N rows: 30% and 10% inliers under a known pose,
    all but 3 rows invalid, and no valid row."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (4, N, 3)).astype(np.float32)
    tgt = np.empty_like(src)
    valid = np.ones((4, N), bool)
    for b, inlier in enumerate((0.3, 0.1, 0.3, 0.3)):
        a = rng.uniform(-0.5, 0.5)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], np.float32)
        tgt[b] = src[b] @ R.T + rng.uniform(-3, 3, 3) \
            + rng.normal(0, 0.01, (N, 3))
        out = rng.random(N) >= inlier
        tgt[b, out] = rng.uniform(-20, 20, (int(out.sum()), 3))
    valid[:2, -10:] = False
    valid[2, 3:] = False
    valid[3] = False
    return tuple(torch.from_numpy(x) for x in (src, tgt, valid))


def upstream(src, tgt, valid):
    """The plain path up to K14's inputs: (confidence, seeds, seed_ok,
    knn_idx)."""
    conf = torch.stack([T.sc2_power_iteration_plain(src[b], tgt[b], valid[b],
                                                    CFG.d_thre, 20)
                        for b in range(src.shape[0])]) * valid.float()
    seeds, seed_ok = T.sc2_nms_plain(src, valid, conf, CFG.nms_radius, SEEDS)
    knn = torch.stack([T.sc2_seed_topk_plain(src[b], tgt[b], valid[b],
                                             seeds[b], CFG.d_thre, CFG.k1)
                       for b in range(src.shape[0])])
    return conf, seeds, seed_ok, knn


def test_k13_source_matches_plain(on_host):
    src, tgt, valid = problems(0)
    conf, seeds, seed_ok, _ = upstream(src, tgt, valid)
    got = T._launch_k13(src, valid, conf, CFG.nms_radius, SEEDS)
    assert torch.equal(got[0], seeds) and torch.equal(got[1], seed_ok)
    # a tied zero tail: 3 valid rows, then none
    assert int(seed_ok[2].sum()) == 3 and not bool(seed_ok[3].any())
    # scores with ties, on a grid whose spacing is the radius: every radius
    # test at the edge agrees bit for bit
    g = torch.arange(N, dtype=torch.float32)
    grid = torch.stack([g % 16, g // 16, torch.zeros_like(g)], -1) * 0.6
    grid = grid[None].expand(2, N, 3).contiguous()
    scores = torch.from_numpy(np.random.default_rng(1).integers(
        0, 5, (2, N)).astype(np.float32))
    v = valid[:2].contiguous()
    for radius in (0.6, 0.61, 1.2):
        got = T._launch_k13(grid, v, scores * v, radius, SEEDS)
        want = T.sc2_nms_plain(grid, v, scores * v, radius, SEEDS)
        assert torch.equal(got[0], want[0]), radius
        assert torch.equal(got[1], want[1]), radius


def nms_case(case, seed=0):
    """(src, valid, scores, radius, num_seeds) of a K13 case, B problems
    of N rows (B = 3 with 256, 40 and 3 valid rows, scattered, unless
    named): "ties" (5 score levels), "zeros" (every score 0), "few" (a
    radius that leaves fewer local maxima than seeds), "all_rows" (S = N),
    "signed" (negative and -0.0 scores), "ragged" (N = 301, a partial
    tile), "many" (B = 260 and a 2 m radius: one rank block a problem,
    which takes each group of 128 of its ~200 nonzero scores in turn)."""
    rng = np.random.default_rng(seed)
    n = 301 if case == "ragged" else N
    B = 260 if case == "many" else 3
    src = rng.uniform(-20, 20, (B, n, 3)).astype(np.float32)
    valid = np.zeros((B, n), bool)
    for b in range(B):
        nv = (n, 40, 3)[b % 3]
        valid[b, rng.permutation(n)[:nv]] = True
    levels = 20 if case in ("few", "all_rows") else 5
    scores = np.round(rng.random((B, n)) * levels) / levels
    if case == "zeros":
        scores[:] = 0
    if case == "signed":
        scores = scores - 0.4
        scores[:, ::7] = -0.0
    scores = (scores * valid).astype(np.float32)
    radius = {"few": 30.0, "many": 2.0}.get(case, 8.0)
    S = n if case == "all_rows" else SEEDS
    return (*map(torch.from_numpy, (src, valid, scores)), radius, S)


@pytest.mark.parametrize("case", ["ties", "zeros", "few", "all_rows",
                                  "signed", "ragged", "many"])
def test_k13_source_cases(on_host, case):
    """K13's seeds and seed_ok bit-equal to the sort it replaced
    (`sc2_nms_plain`) and to its plain mirror (`sc2_nms_rank_plain`)."""
    args = nms_case(case)
    got = T._launch_k13(*args)
    want = T.sc2_nms_plain(*args)
    mirror = T.sc2_nms_rank_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(mirror[0], want[0]) and torch.equal(mirror[1], want[1])
    maxima = got[1].sum(1)
    if case == "zeros":
        assert int(maxima.sum()) == 0
    elif case == "few":
        assert 0 < int(maxima[0]) < args[4]
    # a second call on the same flag words (a new epoch): the same seeds
    again = T._launch_k13(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_k13_raises_past_the_row_cap(on_host):
    n = T.K13_MAX_ROWS + 1
    src = torch.zeros((1, n, 3))
    with pytest.raises(ValueError, match=f"{n} rows"):
        T._launch_k13(src, torch.ones((1, n), dtype=torch.bool),
                      torch.zeros((1, n)), 0.6, 10)


def test_k14_k15_sources_match_plain(on_host):
    src, tgt, valid = problems(0)
    _, _, seed_ok, knn = upstream(src, tgt, valid)
    got = T._launch_k14(CFG, seed_ok, knn, src, tgt, valid)
    want = T.seed_transforms_batched_plain(CFG, seed_ok, knn, src, tgt, valid)
    trans_k, fit_k, best_k, fine_k = got
    trans_p, fit_p, best_p, fine_p = want
    assert torch.equal(fine_k, fine_p)
    assert torch.equal(fit_k, fit_p)
    assert torch.equal(best_k, best_p)
    assert float((trans_k - trans_p).abs().max()) < 1e-4
    assert float(fit_k[0].max()) > 20 and bool((fit_k[3] == -1).all())

    out_k, it_k = T._launch_k15(CFG, trans_p, best_p, src, tgt, valid, 20)
    out_p, it_p = T.sc2_irls(CFG, trans_p, best_p, src, tgt, valid)
    assert torch.equal(it_k, it_p)
    assert float((out_k - out_p).abs().max()) < 1e-5
    # the problem with no valid row keeps its start pose after one round
    assert int(it_k[3]) == 1
    assert torch.equal(out_k[3], trans_p[3, int(best_p[3])])


def creep(seed=77, spread=3.0):
    """One problem whose rows each move by their own offset in [0,
    spread)^3: from the identity the IRLS inlier set changes a little
    every round (all 20 rounds at seed 77 and spread 3)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    tgt = (src + rng.uniform(0, spread, (N, 3))).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(tgt)


def test_k15_source_runs_all_iterations(on_host):
    """From the identity: a problem that runs all 20 rounds, one that stops
    early and one with no valid row."""
    (s0, t0), (s1, t1) = creep(), creep(0, 1.0)
    src = torch.stack([s0, s1, s1])
    tgt = torch.stack([t0, t1, t1])
    valid = torch.ones((3, N), dtype=torch.bool)
    valid[2] = False
    trans = torch.eye(4).expand(3, 1, 4, 4).contiguous()
    best = torch.zeros(3, dtype=torch.int32)
    out_k, it_k = T._launch_k15(CFG, trans, best, src, tgt, valid, 20)
    out_p, it_p = T.sc2_irls(CFG, trans, best, src, tgt, valid)
    assert it_p[0] == 20 and 1 < it_p[1] < 20 and it_p[2] == 1
    assert torch.equal(it_k, it_p)
    assert float((out_k - out_p).abs().max()) < 1e-5
