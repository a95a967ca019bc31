"""K24 sc2_irls_jacobi in its cluster form (csrc/sc2_refine.cu:
irls_cluster) and the branch-free Jacobi solve (csrc/jacobi_pose.cuh),
from their own CUDA sources built for the host with g++ against
tests/cuda_host/ (a cluster launch runs each cluster as a grid of its
blocks, map_shared_rank maps into another block's dynamic shared memory):

- K24 through the wrapper at clusters of 2, 4 and 8 CTAs on the four
  problems of test_torch_sc2_emulated.py: the rounds equal to
  sc2_irls_plain's and the pose within 1e-5 of it, and within K24_F64_TOL
  of the f64 IRLS (chip_smoke._irls64) where its rounds pin a pose;
- a build with 64-thread CTAs of at most 64 rows (-DEYOC_IRLS_THREADS=64
  -DEYOC_K15_MAX_ROWS=64): N = 256 over 8 CTAs (past one CTA's cap, within
  the cluster's) and over 2 (past the cluster's: the rows from the global
  copy), the same checks;
- problems with 0, 1, 2 and 3 inlier rows (every other row invalid), and
  refine_unroll = 4;
- csrc/probes/jacobi_forms.cu: jacobi_pose (the branch-free forms, the
  IEEE solve again where an operand leaves their range) bit for bit equal
  to jacobi_pose_ieee on random sets, 3-point sets (K16's), H = 0, a
  diagonal H, repeated eigenvalues, an a_pq that overflows tau^2 and an H
  entry below the quotient's range (which takes the rerun, counted); once
  with the stand-in's approximate reciprocal and root rounded to nearest
  and once moved within the PTX ISA's stated bounds
  (-DEYOC_HOST_APPROX_SKEW), so that the corrections do work; and the
  forms themselves over 2^20 operands each way and (rounded to nearest)
  every exponent boundary pair of the quotient: no difference rounded to
  nearest, and under the moved approximations at most FORM_MISS of the
  operands. The stated bounds alone do not make every operand exact: for
  b just below a power of two a reciprocal a whole ulp off leaves the
  corrections a tie that rounds to even, and about 6% of the boundary
  pairs then differ; the card's reciprocal gives them exactly, which
  chip_smoke.py sweeps."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from eyoc_tpu_torch.registration import sc2pcr as T
from eyoc_tpu_torch.utils import kernels
from test_torch_sc2_emulated import (CFG, HOST_HEADERS, N, host_source,
                                     problems, upstream)

JACOBI = dataclasses.replace(CFG, qcp_kabsch=False)
# the host builds: (source, flags)
BUILDS = {"refine": ("sc2_refine", []),
          "refine_cut": ("sc2_refine", ["-DEYOC_IRLS_THREADS=64",
                                        "-DEYOC_K15_MAX_ROWS=64"]),
          "forms": ("probes/jacobi_forms", []),
          "forms_skew": ("probes/jacobi_forms", ["-DEYOC_HOST_APPROX_SKEW"])}
K24_F64_TOL = 1e-4           # m, a valid row's move from the f64 IRLS
FORM_MISS = 1e-5             # the moved approximations' share of misses


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{build: ctypes library} built by g++ from the CUDA sources."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' sources")
    out = tmp_path_factory.mktemp("host_k24")
    procs = {}
    for key, (name, flags) in BUILDS.items():
        src = kernels.CSRC / f"{name}.cu"
        cpp = out / f"{key}.cpp"
        cpp.write_text(host_source(src.read_text()))
        lib = out / f"lib{key}.so"
        procs[key] = (lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *flags, "-I",
             str(HOST_HEADERS), "-I", str(src.parent), "-o", str(lib),
             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def wrapper_on(host_libs, monkeypatch, build):
    """sc2pcr's launch code calls the host build `build`."""
    def load(name, argtypes, symbol=None):
        fn = getattr(host_libs[build], f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)


def starts(src, tgt, valid):
    """The plain path's seed poses and best seeds of the problems."""
    _, _, seed_ok, knn = upstream(src, tgt, valid)
    trans, _, best, _ = T.seed_transforms_batched_plain(
        JACOBI, seed_ok, knn, src, tgt, valid)
    return trans, best


def check_k24(cfg, trans, best, src, tgt, valid):
    """K24 (the wrapper, one launch) against the plain IRLS and the f64
    one: the rounds equal to both, and where every f64 round's set pins a
    pose (chip_smoke._irls64: 3 rows of weight or more, a Horn gap of at
    least 1e-2) the pose within 1e-5 of the plain version's and within
    K24_F64_TOL of the f64 run's (elsewhere, as with 2 inliers whose line
    leaves the turn about it free, rounding picks the pose). Returns the
    rounds and the problems that pin a pose."""
    before = kernels.launches["sc2_irls_jacobi"]
    out_k, it_k = T._launch_k15(cfg, trans, best, src, tgt, valid, 20)
    assert kernels.launches["sc2_irls_jacobi"] - before == 1
    out_p, it_p = T.sc2_irls_plain(cfg, trans, best, src, tgt, valid)
    assert torch.equal(it_k, it_p)
    assert bool(torch.isfinite(out_k).all())
    pinned = []
    for b in range(valid.shape[0]):
        T64, it64, rounds = cs._irls64(cfg, trans[b, int(best[b])], src[b],
                                       tgt[b], valid[b])
        assert int(it_k[b]) == it64
        if all(r[4] for r in rounds):
            pinned.append(b)
            assert float((out_k[b] - out_p[b]).abs().max()) < 1e-5, b
            s = src[b][valid[b]].double()
            disp = float(cs._pose_disp(out_k[b:b + 1], T64[None], s)[0])
            assert disp <= K24_F64_TOL, (b, disp)
    return it_k, pinned


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_k24_cluster_matches_plain_and_f64(host_libs, monkeypatch, cluster):
    wrapper_on(host_libs, monkeypatch, "refine")
    monkeypatch.setattr(T, "K24_CLUSTER", cluster)
    src, tgt, valid = problems(0)
    trans, best = starts(src, tgt, valid)
    it, pinned = check_k24(JACOBI, trans, best, src, tgt, valid)
    assert int(it[3]) == 1 and pinned == [0, 1, 2, 3]
    out, _ = T._launch_k15(JACOBI, trans, best, src, tgt, valid, 20)
    assert torch.equal(out[3], trans[3, int(best[3])])


@pytest.mark.parametrize("cluster", [8, 2])
def test_k24_past_a_cta_and_past_the_cluster(host_libs, monkeypatch,
                                             cluster):
    """CTAs of at most 64 rows: N = 256 over 8 CTAs (past one CTA's cap)
    holds 32 rows a CTA in shared memory; over 2 CTAs, 128 rows a CTA, past
    the cluster's cap: the rows come from the global copy."""
    wrapper_on(host_libs, monkeypatch, "refine_cut")
    monkeypatch.setattr(T, "K24_CLUSTER", cluster)
    monkeypatch.setattr(T, "K15_MAX_ROWS", 64)
    spilled = []
    real = T._k15_spill
    monkeypatch.setattr(T, "_k15_spill", lambda B, n, d: spilled.append(n)
                        or real(B, n, d))
    src, tgt, valid = problems(1)
    trans, best = starts(src, tgt, valid)
    _, pinned = check_k24(JACOBI, trans, best, src, tgt, valid)
    assert spilled == ([N] if cluster == 2 else [])
    assert pinned == [0, 1, 3]


@pytest.mark.parametrize("inliers", [0, 1, 2, 3])
def test_k24_few_rows(host_libs, monkeypatch, inliers):
    """A problem whose only valid rows are `inliers` inliers of a known
    pose, from that pose, at clusters of 4 (most CTAs hold no row): 0 keeps
    the start, 1 and 2 pin no pose, 3 do."""
    wrapper_on(host_libs, monkeypatch, "refine")
    monkeypatch.setattr(T, "K24_CLUSTER", 4)
    rng = np.random.default_rng(inliers)
    s = torch.from_numpy(rng.uniform(-20, 20, (1, N, 3)).astype(np.float32))
    a = 0.3
    R = torch.tensor([[np.cos(a), -np.sin(a), 0.0],
                      [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    t = s @ R.T + torch.tensor([1.0, -2.0, 0.5])
    v = torch.zeros((1, N), dtype=torch.bool)
    v[0, torch.from_numpy(rng.choice(N, inliers, replace=False))] = True
    # the IRLS starts at the true pose: the rows are its inliers
    start = torch.eye(4).expand(1, 1, 4, 4).contiguous()
    start[0, 0, :3, :3] = R
    start[0, 0, :3, 3] = torch.tensor([1.0, -2.0, 0.5])
    zero = torch.zeros(1, dtype=torch.int32)
    _, pinned = check_k24(JACOBI, start, zero, s, t, v)
    assert pinned == ([0] if inliers in (0, 3) else [])


def test_k24_unroll(host_libs, monkeypatch):
    wrapper_on(host_libs, monkeypatch, "refine")
    cfg = dataclasses.replace(JACOBI, refine_unroll=4)
    src, tgt, valid = problems(0)
    trans, best = starts(src, tgt, valid)
    it, pinned = check_k24(cfg, trans, best, src, tgt, valid)
    assert it.tolist() == [4, 4, 4, 4] and pinned == [0, 1, 2, 3]


def horn_sets():
    """(name, [n, 15] f32: H, cA, cB) cases for the solves."""
    rng = np.random.default_rng(7)
    out = []
    # random weighted sets and their moments
    a = rng.uniform(-20, 20, (400, 12, 3))
    ang = rng.normal(0, 0.5, (400, 3))
    b = a + np.cross(ang[:, None], a) + rng.normal(0, 0.2, (400, 12, 3))
    w = rng.uniform(0, 1, (400, 12))
    cA = (a * w[..., None]).sum(1) / w.sum(1, keepdims=True)
    cB = (b * w[..., None]).sum(1) / w.sum(1, keepdims=True)
    H = np.einsum("nki,nkj->nij", (a - cA[:, None]) * w[..., None],
                  b - cB[:, None])
    out.append(("random", H, cA, cB))
    # K16's 3-point sets, unit weights
    a3, b3 = a[:, :3], b[:, :3]
    c3a, c3b = a3.mean(1), b3.mean(1)
    out.append(("3-point", np.einsum("nki,nkj->nij", a3 - c3a[:, None],
                                     b3 - c3b[:, None]), c3a, c3b))
    eye = np.eye(3)
    special = [np.zeros((3, 3)), np.diag([3.0, 2.0, 1.0]),
               np.diag([1.0, -2.0, 0.5]), eye, np.diag([1.0, 1.0, 0.0]),
               -eye, np.diag([2.0, 2.0, -1.0]),
               # a_pq = 1e-25 against diagonal differences of ~1: tau^2 = inf
               np.array([[1.0, 0.0, 0.0], [0.0, 0.5, 1e-25],
                         [0.0, 0.0, 0.2]]),
               np.array([[1.0, 1e-25, 0.0], [0.0, -0.5, 0.0],
                         [0.0, 0.0, 0.2]])]
    Hs = np.stack(special)
    z = np.zeros((len(special), 3))
    out.append(("special", Hs, z, z + 1.0))
    # an entry below 2^-100 of max|H|: the quotient's range is left
    out.append(("rerun", np.array([[[1.0, 1e-35, 0.0], [0.0, 0.5, 0.0],
                                    [0.0, 0.0, 0.2]]]), np.zeros((1, 3)),
                np.ones((1, 3))))
    return [(name, torch.from_numpy(np.concatenate(
        [h.reshape(-1, 9), ca, cb], 1).astype(np.float32)).contiguous())
        for name, h, ca, cb in out]


def reruns(lib):
    n = ctypes.c_ulonglong(0)
    assert lib.eyoc_jacobi_forms_reruns(ctypes.byref(n)) == 0
    return n.value


@pytest.mark.parametrize("build", ["forms", "forms_skew"])
def test_branch_free_solve_keeps_the_ieee_bits(host_libs, build):
    lib = host_libs[build]
    P = ctypes.c_void_p
    lib.eyoc_jacobi_forms_solves.argtypes = [P, ctypes.c_int, P, P, P]
    for name, sets in horn_sets():
        n = sets.shape[0]
        fast = torch.full((n, 16), float("nan"))
        ieee = torch.full((n, 16), float("nan"))
        before = reruns(lib)
        assert lib.eyoc_jacobi_forms_solves(
            sets.data_ptr(), n, fast.data_ptr(), ieee.data_ptr(), None) == 0
        assert torch.equal(fast.view(torch.int32), ieee.view(torch.int32)), \
            name
        assert bool(torch.isfinite(fast).all())
        assert (reruns(lib) - before > 0) == (name == "rerun"), name


def form_misses(lib, kind, first, n, boundaries=False):
    out = torch.zeros(3, dtype=torch.int64)
    if kind == "quotients":
        assert lib.eyoc_jacobi_forms_quotients(
            ctypes.c_ulonglong(first), ctypes.c_uint(n), int(boundaries),
            ctypes.c_void_p(out.data_ptr()), None) == 0
    else:
        assert lib.eyoc_jacobi_forms_sweep(
            ("roots", "reciprocals", "reciprocal roots").index(kind),
            ctypes.c_uint(first),
            ctypes.c_uint(n), ctypes.c_void_p(out.data_ptr()), None) == 0
    return out.tolist()


@pytest.mark.parametrize("build", ["forms", "forms_skew"])
def test_forms_against_the_ieee_intrinsics(host_libs, build):
    lib = host_libs[build]
    n = 1 << 20
    allowed = 0 if build == "forms" else int(FORM_MISS * n)
    # roots from 1 up, reciprocals up to 2^126 (the top 2^20 floats below),
    # reciprocal roots from 1 (2^20 of the 2^23 + 1 floats of [1, 2]),
    # quotients from seed 3 (rounded to nearest, with every boundary pair)
    for kind, first in (("roots", 0x3F800000), ("roots", 0x7F7FFFFF - n + 1),
                        ("reciprocals", 0x3F800000),
                        ("reciprocals", 0x7E800000 - n + 1),
                        ("reciprocal roots", 0x3F800000),
                        ("quotients", 3)):
        bad, seen, skipped = form_misses(lib, kind, first, n,
                                         build == "forms")
        assert seen >= (n if kind != "quotients" else n // 2), kind
        assert bad <= allowed, (kind, first, bad)
    if build == "forms_skew":
        bad, seen, _ = form_misses(lib, "quotients", 3, 0, True)
        assert 0.01 * seen < bad < 0.1 * seen
