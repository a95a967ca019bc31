"""K19 `est_quad_linear_robust` (csrc/robust_irls.cu, one thread-block
cluster a problem) built for the host with g++ against tests/cuda_host/
and run through the wrapper's launch code on CPU tensors, against
`est_quad_linear_robust_plain`, the kernel's plain mirror
`est_quad_linear_robust_k19_plain` (bit for bit) and the same rounds in
f64 (chip_smoke.py's `_quad64`, within its K19_TOL):

- the stand-in's cluster launch itself (tests/cuda_host/cluster_sum.cu:
  sums read through `map_shared_rank` after the cluster barrier, over 2, 4
  and 8 blocks a cluster);
- a batch of problems (B = 4): the clean and 20%-outlier cases of
  tests/test_geometry.py's IRLS tests, masked garbage rows (NaN and 1e3:
  the kernel skips masked rows, so NaN padding is harmless there), and a
  problem with no valid row (the identity), over clusters of 2 CTAs of
  64 threads;
- clusters of 2, 4 and 8 CTAs (a host build of 64 threads a CTA) on
  problems of 0, 3 (inliers) and all 1000 valid rows, with the build's row
  cap and past a cut one (-DEYOC_K19_MAX_ROWS=64: each CTA's rows read from
  the global copy, poisoned with NaN before the call);
- a KITTI-scale problem (N = 5000 over +-50 m, 30% inliers) at the default
  cluster and past the cut row cap: the same bits; and on the source's own
  640 threads a CTA;
- a second call gives the same bits.

The stand-in's sincosf rounds the f64 sine and cosine, as the mirror does,
so the host build and the mirror agree bit for bit; the pose is held to
the plain version within POSE_TOL (m: each valid source row's largest move
between the two poses; 20 f32 rounds in two sum orders). CTAs run here one
cluster at a time, each thread a fiber; what only the card can show (that
nvcc takes the source, a cluster placed on the SMs, the real
interleaving) is `chip_smoke.py`'s."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
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
SMALL_CAP = 64
NARROW = 64               # threads a CTA of the cluster-size builds
# the host builds: (row cap, threads a CTA); None is the source's own
BUILDS = ((None, None), (None, NARROW), (SMALL_CAP, NARROW))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """{(cap, threads): ctypes library} built by g++ from
    csrc/robust_irls.cu, all at once: the source's row cap and threads
    (None), or those set by EYOC_K19_MAX_ROWS and EYOC_K19_THREADS."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernel's source")
    out = tmp_path_factory.mktemp("host_robust_irls")
    cpp = out / "robust_irls.cpp"
    cpp.write_text(host_source((kernels.CSRC / "robust_irls.cu").read_text()))
    procs = {}
    for cap, threads in BUILDS:
        so = out / f"librobust_irls_{cap}_{threads}.so"
        define = [] if cap is None else [f"-DEYOC_K19_MAX_ROWS={cap}"]
        if threads is not None:
            define.append(f"-DEYOC_K19_THREADS={threads}")
        procs[cap, threads] = (so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *define, "-I",
             str(HOST_HEADERS), "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        libs[key] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """on_host(cap, threads, cluster) -> the wrapper's launch code run on
    the host build of that row cap and CTA size, at that cluster size, on
    CPU tensors; the spill comes poisoned with NaN."""
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(R, "_k19_spill", lambda B, N, device: torch.full(
        (B, 6, N), float("nan")))

    def use(cap=None, threads=None, cluster=R.K19_CLUSTER):
        lib = host_lib[cap, threads]

        def load(name, argtypes, symbol=None):
            fn = getattr(lib, f"eyoc_{symbol or name}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        monkeypatch.setattr(kernels, "load", load)
        monkeypatch.setattr(R, "K19_MAX_ROWS",
                            R.K19_MAX_ROWS if cap is None else cap)
        monkeypatch.setattr(R, "K19_CLUSTER", cluster)

        # the wrapper's launch code (its CPU branch takes the plain version)
        return lambda p, q, m: R._launch_k19(p, q, m, R.NUM_ITERS)
    return use


def mirror(src, tgt, mask, threads=None, cluster=R.K19_CLUSTER):
    return R.est_quad_linear_robust_k19_plain(src, tgt, mask,
                                              cluster=cluster,
                                              threads=threads)


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


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_stand_in_cluster_sums_through_distributed_shared_memory(
        tmp_path, cluster):
    """tests/cuda_host/cluster_sum.cu on the stand-in: 3 clusters, each
    block's part of x summed in its shared memory, then every block of a
    cluster reads all of its cluster's sums through map_shared_rank."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the source")
    cpp, so = tmp_path / "cluster_sum.cpp", tmp_path / "libcluster_sum.so"
    cpp.write_text(host_source((HOST_HEADERS / "cluster_sum.cu").read_text()))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(so)).eyoc_cluster_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, clusters = 1000, 3
    x = np.arange(n, dtype=np.float32)          # sums exact in f32
    grid = clusters * cluster
    out = np.zeros(grid, np.float32)
    rank = np.full(grid, -1, np.int32)
    assert fn(x.ctypes.data, n, clusters, cluster, out.ctypes.data,
              rank.ctypes.data) == 0
    per = -(-n // grid)
    want = [x[c * cluster * per:(c + 1) * cluster * per].sum()
            for c in range(clusters)]
    assert out.tolist() == np.repeat(want, cluster).tolist()
    assert rank.tolist() == list(range(cluster)) * clusters
    # a cluster past the stand-in's 8 blocks, or one that does not divide
    # the grid, is refused
    bad = fn(x.ctypes.data, n, 1, 16, out.ctypes.data, rank.ctypes.data)
    assert bad != 0


def test_batch_against_plain_and_mirror(on_host):
    src, tgt, mask = problems()
    run = on_host(None, NARROW, 2)
    got = run(src, tgt, mask)
    assert got.shape == (4, 4, 4)
    assert torch.isfinite(got).all()
    assert torch.equal(got[3], torch.eye(4))                  # no valid row
    want = plain_masked(src, tgt, mask)
    assert displacement(got, want, src, mask).max() <= POSE_TOL
    assert torch.equal(got, mirror(src, tgt, mask, NARROW, 2))
    assert torch.equal(run(src, tgt, mask), got)              # same bits


def few_rows_problems(n=1000):
    """[3, n, 3] x 2 and [3, n]: no valid row, 3 valid rows (exact
    inliers: they pin the pose), all n valid (30% inliers over +-50 m)."""
    src, tgt, _ = kitti_problem(seed=13, n=n)
    rng = np.random.default_rng(14)
    T = random_trans(rng)
    A = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    B = (A @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    m3 = np.zeros(n, bool)
    m3[rng.choice(n, 3, replace=False)] = True
    src = torch.cat([src, torch.from_numpy(A[None]), src])
    tgt = torch.cat([tgt, torch.from_numpy(B[None]), tgt])
    mask = torch.stack([torch.zeros(n, dtype=torch.bool),
                        torch.from_numpy(m3), torch.ones(n, dtype=torch.bool)])
    return src, tgt, mask


@pytest.mark.parametrize("cap", [None, SMALL_CAP])
@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_cluster_sizes_match_mirror_and_f64(on_host, cluster, cap):
    """Clusters of 2-8 CTAs of NARROW threads, with the build's row cap (the
    rows in shared memory) and past a cut one (in the global copy): the
    mirror's bits, the f64 rounds within K19_TOL, the identity where no
    row is valid."""
    src, tgt, mask = few_rows_problems()
    got = on_host(cap, NARROW, cluster)(src, tgt, mask)
    assert torch.equal(got, mirror(src, tgt, mask, NARROW, cluster))
    assert torch.equal(got[0], torch.eye(4))
    T64 = chip_smoke._quad64(src, tgt, mask)
    assert max(chip_smoke._row_disp(got, T64, src, mask)) <= \
        chip_smoke.K19_TOL


def test_kitti_scale_and_past_the_row_cap(on_host):
    """N = 5000 at the default cluster (CTAs of NARROW threads): the rows in
    shared memory and, past a cut row cap, in the global copy give the same
    bits, the mirror's; within POSE_TOL of the plain version and K19_TOL of
    the f64 rounds. The source's own CTA size (a cluster of 2 here, to keep
    the fibers few) gives the mirror's bits too."""
    src, tgt, mask = kitti_problem()
    assert -(-int(mask.sum()) // R.K19_CLUSTER) > SMALL_CAP
    got = on_host(None, NARROW)(src, tgt, mask)
    over = on_host(SMALL_CAP, NARROW)(src, tgt, mask)
    assert torch.equal(over, got)
    assert torch.equal(got, mirror(src, tgt, mask, NARROW))
    wide = on_host(None, None, 2)(src, tgt, mask)
    assert torch.equal(wide, mirror(src, tgt, mask, cluster=2))
    want = R.est_quad_linear_robust_plain(src, tgt, mask=mask)
    assert displacement(got, want, src, mask).max() <= POSE_TOL
    T64 = chip_smoke._quad64(src, tgt, mask)
    assert max(chip_smoke._row_disp(got, T64, src, mask)) <= \
        chip_smoke.K19_TOL
