"""RANSAC's and ICP's kernels' own CUDA source (csrc/ransac.cu: K16
`ransac_hypotheses`, K17 `ransac_verify`, K18 `ransac_polish` and
`icp_solve`) built for the host with g++ against
tests/cuda_host/cuda_runtime.h and run through the wrappers' launch code on
CPU tensors, against the plain versions, on N = 256 correspondences (50%
and 10% inliers, 200 valid rows) and H = 512 hypotheses:

- K16's single-stage entry: edge flags and coarse counts (a 64-row subset,
  and none) bit-equal, each hypothesis's pose within 1e-4 where its
  triplet pins one (a Horn gap of at least 1% of the largest eigenvalue;
  most of the others are repeated or collinear points);
- K16's two-stage entry (`ransac_hypotheses_topk`, H = 3000: three edge
  tiles, and 8000 with a looser edge ratio: several survivor tiles, ties at
  the threshold count; k below and above the survivor count; no survivor):
  coarse, keep and the kept counts bit-equal to the plain version's, the
  kept poses the single-stage entry's bit for bit and, where the triplet
  pins one, held to the plain version's as test_torch_ransac holds them to
  JAX's (rotation within 2e-6 / gap, translation within 60 m times 1e-5
  plus that: over 8000 triplets a fixed 1e-4 is not a bound, three pinned
  ones at a 2.3% gap reach 1.7e-4); RANSAC through K16-K18 within 1e-5 of
  the plain path, its inlier count equal; kept poses past the pose cache
  (none, or 100 rows) solved again to the same bits;
- the decoupled look-back that K16's two-stage entry and K10's compaction
  share, on a status array that the in-order blocks here never leave
  (aggregates only over three 32-word windows, then an inclusive prefix):
  the exclusive prefix and the published inclusive one;
- K17: the full counts over the kept hypotheses and every one, and the best
  row, bit-equal;
- K18: `ransac_polish`'s pose within 1e-5 and its inlier count equal
  (the rows above; `valid` with holes at N = 300 and at the kernel's row
  cap; 2 and 3 inliers, the old pose kept below 3; 1 to 12 rounds, which
  end at the fixed point with its bits), and the wrapper's
  error past the cap; `icp_solve`'s pose and warped source within 1e-5
  (the warped source against the plain pose's, 1e-5 of the coordinates'
  reach);
- the K18 probe's warp form of the Jacobi solve (csrc/probes/
  polish_split.cu) against `jacobi_pose`, bit for bit in every lane.

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
from test_torch_ransac import (EXTENT, GAP, HYP_ROT, correspondences,
                               horn_gap, random_pose)
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
    cpp.write_text(host_source((kernels.CSRC / "ransac.cu").read_text()))
    lib = out / "libransac.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-I", str(kernels.CSRC),
                           "-o", str(lib), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


# A one-block kernel that runs the source's look_back for one tile.
LOOK_BACK = """
namespace {
__global__ void look_back_probe(unsigned* status, int tile, int agg,
                                int* out) {
  __shared__ unsigned win[kWindow];
  __shared__ int st[2];
  const int excl = look_back(status, tile, agg, win, st);
  if (threadIdx.x == 0) out[0] = excl;
}
}  // namespace
extern "C" int eyoc_look_back(unsigned* status, int tile, int agg,
                              int* out) {
  look_back_probe<<<1, 256, 0, nullptr>>>(status, tile, agg, out);
  return 0;
}
"""


@pytest.mark.parametrize("source", ["ransac", "voxelize"])
def test_look_back_walks_windows(tmp_path, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' source")
    cpp = tmp_path / f"{source}.cpp"
    text = (kernels.CSRC / f"{source}.cu").read_text() + LOOK_BACK
    cpp.write_text(host_source(text))
    lib = tmp_path / "lib.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-I", str(kernels.CSRC),
                           "-o", str(lib), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(lib)).eyoc_look_back
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    agg = np.random.default_rng(0).integers(0, 1000, 100).astype(np.int64)
    status = np.zeros(100, np.uint32)
    status[:10] = (2 << 30) | np.cumsum(agg[:10])      # inclusive prefixes
    status[10:80] = (1 << 30) | agg[10:80]             # aggregates only
    out = np.zeros(1, np.int32)
    fn(status.ctypes.data, 80, 7, out.ctypes.data)
    want = int(agg[:80].sum())
    assert int(out[0]) == want
    assert int(status[80]) == (2 << 30) | (want + 7)
    assert np.array_equal(status[10:80], (1 << 30) | agg[10:80])


# A kernel that solves each of n Kabsch inputs (H [9], cA [3], cB [3]) by
# jacobi_pose (csrc/jacobi_pose.cuh) on lane 0 and by the K18 probe's warp form
# jacobi_pose_warp (csrc/probes/polish_split.cu) on the 32 lanes of the
# block (each lane's T kept).
JACOBI_FORMS = """
namespace {
__global__ void jacobi_forms(const float* in, float* thread, float* warp) {
  const float* h = in + 15 * blockIdx.x;
  float T[16];
  jacobi_pose_warp(h, h + 9, h + 12, T);
  for (int k = 0; k < 16; ++k)
    warp[(32 * blockIdx.x + threadIdx.x) * 16 + k] = T[k];
  if (threadIdx.x == 0) {
    jacobi_pose(h, h + 9, h + 12, T);
    for (int k = 0; k < 16; ++k) thread[16 * blockIdx.x + k] = T[k];
  }
}
}  // namespace
extern "C" int eyoc_jacobi_forms(const float* in, int n, float* thread,
                                 float* warp) {
  jacobi_forms<<<n, 32, 0, nullptr>>>(in, thread, warp);
  return 0;
}
"""


def test_jacobi_warp_form_is_the_thread_form(tmp_path):
    """The K18 probe's warp form of the Jacobi solve (its time is
    profile_k18_polish.py's "solve, warp") gives jacobi_pose's bits in
    every lane: random moments, rank 1 and 2 ones, a zero one, and ones
    with an exactly diagonal Horn matrix (every |a_pq| < 1e-30: no
    rotation)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' source")
    cpp = tmp_path / "jacobi.cpp"
    probe = (kernels.CSRC / "probes" / "polish_split.cu").read_text()
    cpp.write_text(host_source((kernels.CSRC / "ransac.cu").read_text()
                               + probe.replace('#include "../ransac.cu"', "")
                               + JACOBI_FORMS))
    lib = tmp_path / "lib.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-I", str(kernels.CSRC),
                           "-o", str(lib), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(lib)).eyoc_jacobi_forms
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    rng = np.random.default_rng(9)
    H = rng.normal(0, 50, (64, 3, 3))
    u, v = rng.normal(size=(2, 8, 3))
    H[:8] = u[:, :, None] * v[:, None, :]                     # rank 1
    H[8:16] = H[8:16] - H[8:16] @ np.outer(v[0], v[0]) / (v[0] @ v[0])
    H[16] = 0
    H[17:20] = np.diag([3.0, 2.0, 1.0])                       # diagonal Horn
    c = rng.uniform(-40, 40, (64, 6))
    inp = np.concatenate([H.reshape(64, 9), c], 1).astype(np.float32)
    thread = np.zeros((64, 16), np.float32)
    warp = np.zeros((64, 32, 16), np.float32)
    fn(inp.ctypes.data, 64, thread.ctypes.data, warp.ctypes.data)
    assert np.isfinite(thread).all()
    assert np.array_equal(warp.view(np.int32),
                          np.broadcast_to(thread[:, None], warp.shape)
                          .view(np.int32))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers' launch code calls the host build: kernels.load gives
    its entry points, the CUDA-only checks pass CPU tensors through, and
    the ticket words (icp_solve's) are a zeroed CPU array."""
    def load(name, argtypes, symbol=None):
        fn = getattr(host_lib, f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    tickets = torch.zeros(256, dtype=torch.int32)
    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "ticket", lambda dev, count=1: tickets)


def problem(inlier, nv, seed):
    src, tgt, valid, _ = correspondences(seed, N, inlier, nv)
    rng = np.random.default_rng(seed)
    u_tri = rng.random((H, 3)).astype(np.float32)
    u_sub = rng.random(SUB).astype(np.float32)
    return tuple(map(torch.from_numpy, (src, tgt, valid, u_tri, u_sub)))


def triplet_gap(src, valid, tgt, u_tri):
    """Each hypothesis's triplet's Horn gap (f64)."""
    count = max(int(valid.sum()), 1)
    tri = (u_tri.numpy() * np.float32(count)).astype(np.int32)
    s, t = src.numpy()[tri], tgt.numpy()[tri]
    return torch.from_numpy(horn_gap(s, t, np.ones(tri.shape)))


def pinned(src, valid, tgt, u_tri):
    """The hypotheses whose triplet's Horn gap pins a pose."""
    return triplet_gap(src, valid, tgt, u_tri) >= GAP


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


@pytest.mark.parametrize("H,k,ratio", [(3000, 64, 0.9), (3000, 2048, 0.9),
                                       (8000, 1500, 0.2),
                                       (3000, 256, 0.99999999)])
@pytest.mark.parametrize("inlier,nv,seed", [(0.5, 256, 1), (0.1, 200, 2)])
def test_k16_topk_source_matches_plain(on_host, H, k, ratio, inlier, nv,
                                       seed):
    src, tgt, valid, _, u_sub = problem(inlier, nv, seed)
    u_tri = torch.from_numpy(np.random.default_rng(seed).random(
        (H, 3)).astype(np.float32))
    args = (src, tgt, valid, u_tri, u_sub, THR, ratio)
    trans_k, kept_k, keep_k, coarse_k = ransac._launch_k16_topk(*args, k)
    trans_p, kept_p, keep_p, coarse_p = ransac.ransac_hypotheses_topk_plain(
        *args, k)
    assert torch.equal(coarse_k, coarse_p)
    assert torch.equal(keep_k, keep_p) and torch.equal(kept_k, kept_p)
    survivors = int((coarse_p >= 0).sum())
    if ratio > 0.999:
        assert survivors == 0 and torch.equal(keep_k, torch.arange(k).int())
    elif k > survivors:
        assert int((kept_k < 0).sum()) == k - survivors
    else:                                  # the threshold count splits ties
        thr = float(kept_k.min())
        assert int((coarse_p == thr).sum()) > int((kept_k == thr).sum())
    trans_1, _ = ransac._launch_k16(*args)
    assert torch.equal(trans_k, trans_1[keep_k.long()])
    gap = triplet_gap(src, valid, tgt, u_tri)[keep_k.long()]
    pin = gap >= GAP
    rot = HYP_ROT / gap[pin]
    d = (trans_k - trans_p)[pin].abs().double()
    assert bool((d[:, :3, :3].amax((1, 2)) <= rot).all())
    assert bool((d[:, :3, 3].amax(1) <= EXTENT * (1e-5 + rot)).all())
    cfg = ransac.RansacConfig(num_hypotheses=H, coarse_subset=SUB,
                              full_verify_top=k, edge_length_ratio=ratio)
    T_k, inl_k = ransac._ransac(ransac._launch_k16, ransac._launch_k16_topk,
                                ransac._launch_k17, ransac._launch_k18, src,
                                tgt, valid, cfg, (u_tri, u_sub))
    T_p, inl_p = ransac.ransac_registration_plain(src, tgt, valid, cfg,
                                                  (u_tri, u_sub))
    assert float((T_k - T_p).abs().max()) < 1e-5
    assert int(inl_k) == int(inl_p)


@pytest.mark.parametrize("cache", [0, 100])
def test_k16_topk_source_past_the_pose_cache(on_host, monkeypatch, cache):
    """Kept survivors past the first K16_POSE_CACHE are solved again: the
    same bits as the single-stage entry's poses."""
    src, tgt, valid, _, u_sub = problem(0.5, 256, 1)
    u_tri = torch.from_numpy(np.random.default_rng(1).random(
        (8000, 3)).astype(np.float32))
    args = (src, tgt, valid, u_tri, u_sub, THR, 0.2)
    monkeypatch.setattr(ransac, "K16_POSE_CACHE", cache)
    trans_k, _, keep_k, coarse_k = ransac._launch_k16_topk(*args, 1500)
    trans_1, coarse_1 = ransac._launch_k16(*args)
    assert torch.equal(coarse_k, coarse_1)
    assert torch.equal(trans_k, trans_1[keep_k.long()])


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


def start_pose(T, seed):
    """The true pose moved by a small rotation and translation: a polish
    start that most true inliers pass."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((random_pose(rng, angle=0.01, trans=0.05)
                             @ T).astype(np.float32))[None]


@pytest.mark.parametrize("n,hole,seed", [(300, 0.3, 5), (ransac.K18_MAX_ROWS,
                                                          0.1, 6)])
def test_k18_polish_source_holes_and_row_cap(on_host, n, hole, seed):
    """`valid` with holes anywhere (the kernel copies the valid rows in
    index order), up to the kernel's row cap."""
    src, tgt, _, T = correspondences(seed, n, 0.5, n)
    valid = np.random.default_rng(seed).random(n) >= hole
    src, tgt, valid = map(torch.from_numpy, (src, tgt, valid))
    trans, best = start_pose(T, seed), torch.zeros((), dtype=torch.int32)
    T_k, inl_k = ransac._launch_k18(trans, best, src, tgt, valid, THR, 5)
    T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                            THR, 5)
    assert float((T_k - T_p).abs().max()) < 1e-5
    assert int(inl_k) == int(inl_p) > int(valid.sum()) * 0.4


@pytest.mark.parametrize("nv", [2, 3])
def test_k18_polish_source_fewer_than_3_inliers(on_host, nv):
    """A round with fewer than 3 inliers keeps the old pose; 3 solve."""
    src, tgt, valid, T = map(torch.from_numpy,
                             correspondences(7, 64, 1.0, nv))
    trans, best = start_pose(T.numpy(), 7), torch.zeros((), dtype=torch.int32)
    T_k, inl_k = ransac._launch_k18(trans, best, src, tgt, valid, THR, 5)
    T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                            THR, 5)
    assert int(inl_k) == int(inl_p) == nv
    if nv < 3:
        assert torch.equal(T_k, trans[0])
    else:
        assert not torch.equal(T_k, trans[0])
        assert float((T_k - T_p).abs().max()) < 1e-5


@pytest.mark.parametrize("inlier,seed", [(0.5, 1), (0.1, 2)])
def test_k18_polish_source_stops_at_its_fixed_point(on_host, inlier, seed):
    """Rounds end once a round's inliers are the last round's: 1 to 12
    rounds within 1e-5 of the plain version, inlier counts equal, and 12
    rounds the same bits as the rounds that reached the fixed point."""
    src, tgt, valid, u_tri, u_sub = problem(inlier, 256, seed)
    trans, coarse = ransac.ransac_hypotheses_plain(src, tgt, valid, u_tri,
                                                   u_sub, THR, RATIO)
    _, best = ransac.ransac_verify_plain(trans, coarse, None, src, tgt, valid,
                                         THR)
    got = {}
    for iters in (1, 2, 3, 5, 12):
        got[iters] = ransac._launch_k18(trans, best, src, tgt, valid, THR,
                                        iters)
        T_p, inl_p = ransac.ransac_polish_plain(trans, best, src, tgt, valid,
                                                THR, iters)
        assert float((got[iters][0] - T_p).abs().max()) < 1e-5
        assert int(got[iters][1]) == int(inl_p)
    assert torch.equal(got[5][0], got[12][0])
    assert int(got[5][1]) == int(got[12][1])


def test_k18_polish_raises_past_the_row_cap(on_host):
    n = ransac.K18_MAX_ROWS + 1
    src, tgt, valid, T = correspondences(8, n, 0.5, n)
    args = (start_pose(T, 8), torch.zeros((), dtype=torch.int32),
            *map(torch.from_numpy, (src, tgt, valid)))
    with pytest.raises(ValueError, match=f"{n} rows"):
        ransac._launch_k18(*args, THR, 5)


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
