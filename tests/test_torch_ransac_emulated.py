"""RANSAC's and ICP's kernels' own CUDA source (csrc/ransac.cu: K16
`ransac_hypotheses`, K17 `ransac_verify`, K18 `ransac_polish` and
`icp_solve`) built for the host with g++ against
tests/cuda_host/cuda_runtime.h and run through the wrappers' launch code on
CPU tensors, against the plain versions, on N = 256 correspondences (50%
and 10% inliers, 200 valid rows) and H = 512 hypotheses:

- K16: edge flags and coarse counts (a 64-row subset, and none) bit-equal,
  each hypothesis's pose within 1e-4 where its triplet pins one (a Horn
  gap of at least 1% of the largest eigenvalue; most of the others are
  repeated or collinear points);
- K17: the full counts over the kept hypotheses and every one, and the best
  row, bit-equal;
- K18: `ransac_polish`'s pose within 1e-5 and its inlier count equal;
  `icp_solve`'s pose and warped source within 1e-5 (the warped source
  against the plain pose's, 1e-5 of the coordinates' reach).

This checks the kernels' indexing, edge test, Jacobi solve and reductions
on the CPU; what only the card can show (that nvcc takes the source, the
real thread interleaving) is `chip_smoke.py`'s."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.ops.knn import masked_argmin_plain
from eyoc_tpu_torch.registration import icp, ransac
from eyoc_tpu_torch.utils import kernels
from test_torch_ransac import GAP, correspondences, horn_gap, random_pose
from test_torch_sc2_emulated import HOST_HEADERS, LAUNCH

N, H, SUB = 256, 512, 64
THR, RATIO = 0.3, 0.9


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ctypes library built by g++ from csrc/ransac.cu."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' source")
    out = tmp_path_factory.mktemp("host_ransac")
    cpp = out / "ransac.cpp"
    cpp.write_text(LAUNCH.sub(r"HostLaunch{(unsigned)(\2), (unsigned)(\3)}"
                              r"(\1, ", (kernels.CSRC / "ransac.cu")
                              .read_text()))
    lib = out / "libransac.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-o", str(lib), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers' launch code calls the host build: kernels.load gives
    its entry points, and the CUDA-only checks pass CPU tensors through."""
    def load(name, argtypes, symbol=None):
        fn = getattr(host_lib, f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)


def problem(inlier, nv, seed):
    src, tgt, valid, _ = correspondences(seed, N, inlier, nv)
    rng = np.random.default_rng(seed)
    u_tri = rng.random((H, 3)).astype(np.float32)
    u_sub = rng.random(SUB).astype(np.float32)
    return tuple(map(torch.from_numpy, (src, tgt, valid, u_tri, u_sub)))


def pinned(src, valid, tgt, u_tri):
    """The hypotheses whose triplet's Horn gap pins a pose."""
    count = max(int(valid.sum()), 1)
    tri = (u_tri.numpy() * np.float32(count)).astype(np.int32)
    s, t = src.numpy()[tri], tgt.numpy()[tri]
    return torch.from_numpy(horn_gap(s, t, np.ones(tri.shape)) >= GAP)


@pytest.mark.parametrize("subset", [True, False])
@pytest.mark.parametrize("inlier,nv,seed", [(0.5, 256, 1), (0.1, 256, 2),
                                            (0.5, 200, 3)])
def test_k16_k17_source_matches_plain(on_host, subset, inlier, nv, seed):
    src, tgt, valid, u_tri, u_sub = problem(inlier, nv, seed)
    u = u_sub if subset else None
    trans_k, coarse_k = ransac._launch_k16(src, tgt, valid, u_tri, u, THR,
                                           RATIO)
    trans_p, coarse_p = ransac.ransac_hypotheses_plain(src, tgt, valid,
                                                       u_tri, u, THR, RATIO)
    assert torch.equal(coarse_k >= 0, coarse_p >= 0)
    assert torch.equal(coarse_k, coarse_p)
    pin = pinned(src, valid, tgt, u_tri)
    assert float(pin.float().mean()) > 0.9
    assert float((trans_k - trans_p)[pin].abs().max()) < 1e-4
    assert bool(torch.isfinite(trans_k).all())
    if subset and inlier == 0.5:           # all-inlier triplets are found
        assert float(coarse_k.max()) >= SUB * inlier * 0.5
    # K17 on the plain kept set, and on every hypothesis
    for keep in ((ransac.topk(coarse_p, 64)[1] if subset else None),
                 torch.arange(0, H, 3)):
        counts_k, best_k = ransac._launch_k17(trans_p, coarse_p, keep, src,
                                              tgt, valid, THR)
        counts_p, best_p = ransac.ransac_verify_plain(trans_p, coarse_p,
                                                      keep, src, tgt, valid,
                                                      THR)
        assert torch.equal(counts_k, counts_p)
        assert int(best_k) == int(best_p)


@pytest.mark.parametrize("inlier,nv,seed", [(0.5, 256, 1), (0.5, 200, 3)])
def test_k18_polish_source_matches_plain(on_host, inlier, nv, seed):
    src, tgt, valid, u_tri, u_sub = problem(inlier, nv, seed)
    trans, coarse = ransac.ransac_hypotheses_plain(src, tgt, valid, u_tri,
                                                   u_sub, THR, RATIO)
    _, best = ransac.ransac_verify_plain(trans, coarse, None, src, tgt, valid,
                                         THR)
    T_k, inl_k = ransac._launch_k18(trans, best, src, tgt, valid, THR, 5)
    T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                            THR, 5)
    assert float((T_k - T_p).abs().max()) < 1e-5
    assert int(inl_k) == int(inl_p) > nv * inlier * 0.8
    # fewer than 3 inliers: the start pose is kept
    none = torch.zeros_like(valid)
    T_k, inl_k = ransac._launch_k18(trans, best, src, tgt, none, THR, 5)
    assert torch.equal(T_k, trans[int(best)]) and int(inl_k) == 0


def test_k18_icp_source_matches_plain(on_host):
    rng = np.random.default_rng(4)
    s = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    T = random_pose(rng, angle=0.05, trans=0.1)
    t = (s @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, s.shape))
    src, tgt = torch.from_numpy(s), torch.from_numpy(t.astype(np.float32))
    sm = torch.from_numpy(rng.random(N) > 0.2)
    tm = torch.from_numpy(rng.random(N) > 0.2)
    d2, nn = masked_argmin_plain(src, sm, tgt, tm)
    for r2 in (0.25, 0.0):                  # 0: no correspondence, identity
        T_k, w_k = icp._launch_icp_solve(src, sm, tgt, nn, d2, r2)
        T_p, w_p = icp.icp_solve_plain(src, sm, tgt, nn, d2, r2)
        assert float((T_k - T_p).abs().max()) < 1e-5
        assert float((w_k - w_p).abs().max()) < 1e-5 * 8
    assert torch.equal(T_k, torch.eye(4))
