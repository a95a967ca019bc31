"""K19 `est_quad_linear_robust` (csrc/robust_irls.cu) built for the host
with g++ against tests/cuda_host/cuda_runtime.h and run through the
wrapper's launch code on CPU tensors, against `est_quad_linear_robust_plain`
and the kernel's plain mirror `est_quad_linear_robust_k19_plain`:

- a batch of problems (B = 4): the clean and 20%-outlier cases of
  tests/test_geometry.py's IRLS tests, masked garbage rows (NaN and 1e3:
  the kernel skips masked rows, so NaN padding is harmless there), and a
  problem with no valid row (the identity);
- a KITTI-scale problem (N = 5000 over +-50 m, 30% inliers) and the same
  rows past the shared-memory row cap (a host build with
  -DEYOC_K19_MAX_ROWS=64 reads them from the global copy, poisoned with
  NaN before the call): the same bits as the build whose cap holds them;
- a second call gives the same bits.

The pose is held to the plain version and to the mirror: each valid
source row moves at most POSE_TOL (m) between the two poses (20 f32 rounds
in two sum orders; host sinf / cosf against torch's). Blocks run here in
index order, one fiber a thread; what only the card can show (that nvcc
takes the source, the real interleaving) is `chip_smoke.py`'s."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.geometry import robust as R
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


POSE_TOL = 2e-5           # m, largest row displacement between two poses
MIRROR_TOL = 1e-5         # m, against the kernel's own plain mirror
SMALL_CAP = 64


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """{cap: ctypes library} built by g++ from csrc/robust_irls.cu: the
    source's row cap (None), or one set by EYOC_K19_MAX_ROWS."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernel's source")
    out = tmp_path_factory.mktemp("host_robust_irls")
    cpp = out / "robust_irls.cpp"
    cpp.write_text(host_source((kernels.CSRC / "robust_irls.cu").read_text()))
    libs = {}

    def lib(cap):
        if cap not in libs:
            so = out / f"librobust_irls_{cap}.so"
            define = [] if cap is None else [f"-DEYOC_K19_MAX_ROWS={cap}"]
            proc = subprocess.run(
                [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *define,
                 "-I", str(HOST_HEADERS), "-o", str(so), str(cpp)],
                capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr
            libs[cap] = ctypes.CDLL(str(so))
        return libs[cap]
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """on_host(cap) -> the wrapper's launch code run on the host build of
    that row cap, on CPU tensors; the spill comes poisoned with NaN."""
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(R, "_k19_spill", lambda B, N, device: torch.full(
        (B, 6, N), float("nan")))

    def use(cap=None):
        lib = host_lib(cap)

        def load(name, argtypes, symbol=None):
            fn = getattr(lib, f"eyoc_{symbol or name}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        monkeypatch.setattr(kernels, "load", load)
        if cap is not None:
            monkeypatch.setattr(R, "K19_MAX_ROWS", cap)

        # the wrapper's launch code (its CPU branch takes the plain version)
        return lambda p, q, m: R._launch_k19(p, q, m, R.NUM_ITERS)
    return use


def random_trans(rng, magnitude=0.2, tmax=1.0):
    """A rotation about a random axis by up to `magnitude` rad and a
    translation within +-tmax (the sizes of tests/test_geometry.py's IRLS
    cases)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-magnitude, magnitude)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    Rm = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rm
    T[:3, 3] = rng.uniform(-tmax, tmax, 3)
    return T


def problems():
    """[4, 500, 3] x 2 and [4, 500]: clean, 20% outliers, garbage rows
    masked (rows 400-449 NaN, 450-499 +-1e3), no valid row."""
    n = 500
    src, tgt, mask = [], [], []
    for seed, case in ((8, "clean"), (9, "outliers"), (10, "masked"),
                       (11, "empty")):
        rng = np.random.default_rng(seed)
        T = random_trans(rng)
        A = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        B = (A @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        m = np.ones(n, bool)
        if case == "outliers":
            B[:100] += rng.uniform(-10, 10, (100, 3)).astype(np.float32)
        if case == "masked":
            A[400:450], B[400:450] = np.nan, np.nan
            A[450:], B[450:] = 1e3, -1e3
            m[400:] = False
        if case == "empty":
            m[:] = False
        src.append(A)
        tgt.append(B)
        mask.append(m)
    return (torch.from_numpy(np.stack(src)), torch.from_numpy(np.stack(tgt)),
            torch.from_numpy(np.stack(mask)))


def kitti_problem(seed=12, n=5000, inlier=0.3):
    rng = np.random.default_rng(seed)
    T = random_trans(rng)
    A = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    B = (A @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    k = int(n * (1 - inlier))
    B[:k] = rng.uniform(-50, 50, (k, 3)).astype(np.float32)
    B[k:] += rng.normal(0, 0.02, (n - k, 3)).astype(np.float32)
    m = np.ones(n, bool)
    m[rng.random(n) < 0.1] = False
    return (torch.from_numpy(A[None]), torch.from_numpy(B[None]),
            torch.from_numpy(m[None]))


def displacement(Ta, Tb, src, mask):
    """Largest distance between a valid source row warped by Ta and by Tb
    (0 for a problem with no valid row)."""
    out = []
    for b in range(src.shape[0]):
        p = src[b][mask[b]].double()
        if p.shape[0] == 0:
            out.append(0.0)
            continue
        d = (p @ (Ta[b, :3, :3].double() - Tb[b, :3, :3].double()).T
             + (Ta[b, :3, 3] - Tb[b, :3, 3]).double())
        out.append(float(d.norm(dim=1).max()))
    return np.array(out)


def plain_masked(src, tgt, mask):
    """The plain version with the masked rows zeroed (in it a masked row
    still enters the sums, times a zero weight: NaN would poison them)."""
    z = torch.zeros_like(src)
    keep = mask[..., None]
    return R.est_quad_linear_robust_plain(torch.where(keep, src, z),
                                          torch.where(keep, tgt, z),
                                          mask=mask)


def test_batch_against_plain_and_mirror(on_host):
    src, tgt, mask = problems()
    run = on_host()
    got = run(src, tgt, mask)
    assert got.shape == (4, 4, 4)
    assert torch.isfinite(got).all()
    assert torch.equal(got[3], torch.eye(4))                  # no valid row
    want = plain_masked(src, tgt, mask)
    mirror = R.est_quad_linear_robust_k19_plain(src, tgt, mask)
    assert displacement(got, want, src, mask).max() <= POSE_TOL
    assert displacement(got, mirror, src, mask).max() <= MIRROR_TOL
    assert torch.equal(run(src, tgt, mask), got)              # same bits


def test_kitti_scale_and_past_the_row_cap(on_host):
    src, tgt, mask = kitti_problem()
    got = on_host()(src, tgt, mask)
    over = on_host(SMALL_CAP)(src, tgt, mask)
    assert torch.equal(over, got)
    want = R.est_quad_linear_robust_plain(src, tgt, mask=mask)
    assert displacement(got, want, src, mask).max() <= POSE_TOL
    mirror = R.est_quad_linear_robust_k19_plain(src, tgt, mask)
    assert displacement(got, mirror, src, mask).max() <= MIRROR_TOL
