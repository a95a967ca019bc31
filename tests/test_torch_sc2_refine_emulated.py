"""K14 `sc2_seed_transforms` and K15 `sc2_irls` (csrc/sc2_refine.cu) built
for the host with g++ against tests/cuda_host/cuda_runtime.h and run
through the wrappers' launch code on CPU tensors, against
`seed_transforms_batched_plain` and `sc2_irls_plain`:

- K14 (`compact_rows`, a block a chunk of 1024 rows placed by the counts
  of the chunks before, tagged with the call's epoch; `seed_consensus`, a
  warp a seed, the chain only for a head, a seed whose k1 columns differ
  from the seed before's; `seed_fitness`, a block a group of 32 seeds and
  a part of the rows, the argmax by each problem's last block at a ticket
  word): valid rows scattered over 2500 (3 chunks), not a prefix;
  labeling-like problems (N = 2048 with 10 and 123 valid rows first, more
  seeds than valid rows: runs of seeds with the same columns, rows split
  into parts); a problem with no valid row; B = 3 with other valid counts.
  The consensus sets (fine_sel), the fitness and best bit-equal, each
  seed's pose within 1e-4 (rotation entries, and metres), as
  `test_torch_sc2_emulated.py` holds them; the head flags and each seed's
  head as the columns give them;
- K15 (`irls`, the valid rows in shared memory): on those problems the
  iteration counts equal, the pose within 1e-5 where the final inliers pin
  one (3 rows or more), else the same inlier rows fitted as well; past its
  shared-memory row cap (a host build with -DEYOC_K15_MAX_ROWS=64, so that
  problems of 700 and 200 valid rows read theirs from the global copy) the
  same, and the same bits as the build whose cap holds every problem;
- every scratch word allocated poisoned (each is written before it is
  read); a second call on the same ticket words and scratch gives the same
  bits, and the ticket words are back at 0 after each call.

Blocks run here in index order, one fiber a thread: the real interleaving
of the blocks at the ticket and at the chunks' counts is the card's
(`chip_smoke.py`)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.registration import sc2pcr as T
from eyoc_tpu_torch.utils import kernels
from test_torch_sc2_emulated import HOST_HEADERS, host_source


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


POSE_TOL, IRLS_TOL = 1e-4, 1e-5
SMALL_CAP = 64                 # K15's row cap in the over-cap host build
POISON = 0x7FC00000            # a NaN as f32, a wild place as int32


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{cap: ctypes library} built by g++ from csrc/sc2_refine.cu: the
    source's own K15 row cap (None), or one set by EYOC_K15_MAX_ROWS."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' source")
    out = tmp_path_factory.mktemp("host_sc2_refine")
    cpp = out / "sc2_refine.cpp"
    cpp.write_text(host_source((kernels.CSRC / "sc2_refine.cu").read_text()))
    libs = {}

    def lib(cap):
        if cap not in libs:
            so = out / f"libsc2_refine_{cap}.so"
            define = [] if cap is None else [f"-DEYOC_K15_MAX_ROWS={cap}"]
            proc = subprocess.run(
                [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *define,
                 "-I", str(HOST_HEADERS), "-I", str(kernels.CSRC), "-o",
                 str(so), str(cpp)],
                capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr
            libs[cap] = ctypes.CDLL(str(so))
        return libs[cap]
    return lib


@pytest.fixture
def tickets():
    return torch.zeros(256, dtype=torch.int32)


@pytest.fixture
def on_host(host_libs, monkeypatch, tickets):
    """on_host(cap): the wrappers' launch code calls the host build of that
    K15 row cap; scratch and spill come poisoned, the tickets are one
    zeroed array kept across calls."""
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "ticket", lambda dev, count=1: tickets)
    monkeypatch.setattr(T, "_k14_scratch", lambda B, N, S, device:
                        torch.full((9 * B * N + B + 3 * B * S,), POISON,
                                   dtype=torch.int32))
    monkeypatch.setattr(T, "_k15_spill", lambda B, N, device: torch.full(
        (B, 6, N), float("nan")))

    def use(cap=None):
        lib = host_libs(cap)

        def load(name, argtypes, symbol=None):
            fn = getattr(lib, f"eyoc_{symbol or name}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        monkeypatch.setattr(kernels, "load", load)
        if cap is not None:
            monkeypatch.setattr(T, "K15_MAX_ROWS", cap)
    return use


def problem_set(n, spec, seed):
    """B problems of n rows, one for each (inlier share, valid rows,
    scattered) of `spec`: tgt = R src + t with noise on the inliers,
    uniform elsewhere; the valid rows scattered over the n, or first (as
    compact_matches leaves them)."""
    rng = np.random.default_rng(seed)
    B = len(spec)
    src = rng.uniform(-20, 20, (B, n, 3)).astype(np.float32)
    tgt = np.empty_like(src)
    valid = np.zeros((B, n), bool)
    for b, (inlier, nv, scattered) in enumerate(spec):
        a = rng.uniform(-0.5, 0.5)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], np.float32)
        tgt[b] = src[b] @ R.T + rng.uniform(-3, 3, 3) \
            + rng.normal(0, 0.01, (n, 3))
        out = rng.random(n) >= inlier
        tgt[b, out] = rng.uniform(-20, 20, (int(out.sum()), 3))
        rows = rng.permutation(n)[:nv] if scattered else np.arange(nv)
        valid[b, rows] = True
    return tuple(torch.from_numpy(x) for x in (src, tgt, valid))


# name: (rows a problem, seeds, [(inlier share, valid rows, scattered)])
CASES = {
    "scattered": (2500, 48, [(0.3, 1800, True), (0.5, 600, True)]),
    "labeling": (2048, 100, [(0.3, 10, False), (0.3, 123, False)]),
    "no_valid_row": (256, 32, [(0.3, 0, True), (0.3, 256, False)]),
    "batch_of_3": (300, 40, [(0.3, 300, False), (0.2, 37, True),
                             (0.5, 3, True)]),
}


def case_inputs(name):
    """(cfg, seed_ok, knn, src, tgt, valid) of a K14 call from the plain
    path before it."""
    n, seeds, spec = CASES[name]
    src, tgt, valid = problem_set(n, spec, len(name))
    cfg = T.SC2PCRConfig(max_points=n, seed_cap=seeds)
    conf = torch.stack([T.sc2_power_iteration_plain(
        src[b], tgt[b], valid[b], cfg.d_thre, cfg.num_iterations)
        for b in range(len(spec))]) * valid.float()
    seed_rows, seed_ok = T.sc2_nms_plain(src, valid, conf, cfg.nms_radius,
                                         seeds)
    knn = torch.stack([T.sc2_seed_topk_plain(
        src[b], tgt[b], valid[b], seed_rows[b], cfg.d_thre, cfg.k1)
        for b in range(len(spec))])
    return cfg, seed_ok, knn, src, tgt, valid


@pytest.mark.parametrize("case", sorted(CASES))
def test_k14_k15_sources_match_plain(on_host, tickets, case):
    on_host()
    args = case_inputs(case)
    cfg, seed_ok, _, src, tgt, valid = args
    got = T._launch_k14(*args)
    assert torch.equal(tickets, torch.zeros_like(tickets))
    again = T._launch_k14(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert torch.equal(tickets, torch.zeros_like(tickets))
    trans_k, fit_k, best_k, fine_k = got
    trans_p, fit_p, best_p, fine_p = T.seed_transforms_batched_plain(*args)
    assert torch.equal(fine_k, fine_p)
    assert torch.equal(fit_k, fit_p)
    assert torch.equal(best_k, best_p)
    assert float((trans_k - trans_p).abs().max()) < POSE_TOL
    nv = valid.sum(1)
    assert torch.equal(fit_k.amax(1) > 0, (nv > 0) & seed_ok.any(1))

    out_k, it_k = T._launch_k15(cfg, trans_p, best_p, src, tgt, valid, 20)
    out_2, it_2 = T._launch_k15(cfg, trans_p, best_p, src, tgt, valid, 20)
    assert torch.equal(out_k, out_2) and torch.equal(it_k, it_2)
    out_p, it_p = T.sc2_irls_plain(cfg, trans_p, best_p, src, tgt, valid)
    assert torch.equal(it_k, it_p)
    # the pose within IRLS_TOL where the final inliers pin one (3 rows or
    # more); with fewer, f32 rounding picks one of the poses that fit them
    # (PERF.md, the known differences): there the kernel's fits the same
    # rows as well, within 1e-4 m
    res_k, res_p = residuals(out_k, src, tgt), residuals(out_p, src, tgt)
    inlier = (res_p < T._irls_threshold(cfg)) & valid
    pinned = inlier.sum(1) >= 3
    assert largest((out_k - out_p)[pinned]) < IRLS_TOL
    assert largest((res_k - res_p)[inlier & ~pinned[:, None]]) < 1e-4
    if case == "batch_of_3":
        assert not bool(pinned[2])            # 2 inliers of its 3 rows
    # a problem with no valid row keeps its start pose after one round
    for b in torch.nonzero(nv == 0)[:, 0].tolist():
        assert int(it_k[b]) == 1
        assert torch.equal(out_k[b], trans_p[b, int(best_p[b])])


def largest(x):
    """max |x|, 0 for an empty x."""
    return float(x.abs().max()) if x.numel() else 0.0


def residuals(trans, src, tgt):
    """|R s + t - t'| [B, N] of each problem's pose trans [B, 4, 4]."""
    pred = torch.einsum("bij,bnj->bni", trans[:, :3, :3], src) \
        + trans[:, None, :3, 3]
    return (pred - tgt).norm(dim=-1)


def test_k14_labeling_seeds_past_the_valid_rows(on_host, monkeypatch):
    """More seeds than valid rows: the seeds past them are not ok (fitness
    -1), and every seed still gets a finite pose. They share their k1
    columns (the problem's first valid rows), so only the first of each run
    of equal columns is a head and makes a chain: the head flags and heads
    in the scratch, each seed's head the last head at or before it, with
    the seed's columns."""
    on_host()
    made = []
    scratch = T._k14_scratch
    monkeypatch.setattr(T, "_k14_scratch", lambda *a: made.append(
        scratch(*a)) or made[-1])
    args = case_inputs("labeling")
    seed_ok, knn, valid = args[1], args[2], args[5]
    trans, fit, _, fine = T._launch_k14(*args)
    assert bool((seed_ok.sum(1) <= valid.sum(1)).all())
    assert bool((~seed_ok[0]).any())
    assert bool((fit[~seed_ok] == -1).all())
    assert bool(torch.isfinite(trans).all())
    B, S = seed_ok.shape
    N = valid.shape[1]
    words = made[0][9 * B * N + B + B * S:].view(2, B, S)
    head, head_of = words[0].bool(), words[1].long()
    want = torch.ones((B, S), dtype=torch.bool)
    want[:, 1:] = (knn[:, 1:] != knn[:, :-1]).any(-1)
    assert torch.equal(head, want)
    assert int(head[0].sum()) < S // 2        # 10 valid rows, 100 seeds
    s = torch.arange(S)
    last = torch.cummax(torch.where(head, s, torch.zeros_like(s)), 1).values
    assert torch.equal(head_of, last)
    ref = torch.gather(knn, 1, head_of[..., None].expand_as(knn))
    assert torch.equal(ref, knn)
    assert torch.equal(torch.gather(fine, 1, head_of[..., None].expand_as(
        fine)), fine)


def creep(n, seed, spread):
    """Rows that each move by their own offset in [0, spread)^3: from the
    identity the IRLS inlier set changes a little every round."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = (src + rng.uniform(0, spread, (n, 3))).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(tgt)


def test_k15_past_its_row_cap(on_host):
    """A host build whose shared memory holds 64 rows: a problem of 700 and
    one of 200 valid rows read theirs from the global copy (past 512 rows a
    thread's weights are made again in the second pass), one of exactly 64
    and one of 30 from shared memory; the rounds and poses as the plain
    version's, and the same bits as the build whose cap holds them all."""
    n = 700
    (s0, t0), (s1, t1) = creep(n, 77, 3.0), creep(n, 0, 1.0)
    src = torch.stack([s0, s1, s1, s0]).contiguous()
    tgt = torch.stack([t0, t1, t1, t0]).contiguous()
    valid = torch.zeros((4, n), dtype=torch.bool)
    valid[0] = True
    valid[1, np.random.default_rng(1).permutation(n)[:200]] = True
    valid[2, :SMALL_CAP] = True
    valid[3, 7:37] = True
    trans = torch.eye(4).expand(4, 1, 4, 4).contiguous()
    best = torch.zeros(4, dtype=torch.int32)
    cfg = T.SC2PCRConfig(max_points=n)
    on_host()
    full_k, full_it = T._launch_k15(cfg, trans, best, src, tgt, valid, 20)
    on_host(SMALL_CAP)
    out_k, it_k = T._launch_k15(cfg, trans, best, src, tgt, valid, 20)
    out_p, it_p = T.sc2_irls_plain(cfg, trans, best, src, tgt, valid)
    assert int(it_p[0]) >= 10           # many rounds on the global copy
    assert torch.equal(it_k, it_p)
    assert float((out_k - out_p).abs().max()) < IRLS_TOL
    assert torch.equal(out_k, full_k) and torch.equal(it_k, full_it)
