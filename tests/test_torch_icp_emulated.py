"""ICP's solve K18 `icp_solve` (csrc/ransac.cu: `icp_moments`, `icp_cross`,
`icp_warp`, chained on the stream behind two ticket words) built for the
host with g++ against tests/cuda_host/cuda_runtime.h and run through the
wrapper's launch code on CPU tensors, and its plain mirror
`icp_solve_chunked_plain` (the kernel's order of sums), against
`icp_solve_plain`:

- N not a multiple of the chunk (blocks with a short chunk and blocks with
  none), threads with two rows of a chunk (a host build of 7 blocks of 256
  threads), a chunk with no valid row, r^2 = 0 (no correspondence: the
  identity);
- the scratch (partial rows and centroids) poisoned with NaN before each
  call: every word is written before it is read;
- two calls in a row give the same bits, and leave both ticket words at 0;
- the pose within 1e-5 of the plain version's, the warped source within
  8e-5 (1e-5 of the coordinates' reach), and the kernel's pose the mirror's
  bits.

The chained launches run here in block order; the real interleaving of
the blocks at the tickets is the card's (`chip_smoke.py`)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.ops.knn import masked_argmin_plain
from eyoc_tpu_torch.registration import icp
from eyoc_tpu_torch.utils import kernels
from test_torch_ransac import random_pose
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


POSE_TOL, WARP_TOL = 1e-5, 8e-5


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{grid: ctypes library} built by g++ from csrc/ransac.cu, on demand:
    the source's own grid (icp.ICP_BLOCKS), or a smaller one set by
    defining EYOC_ICP_BLOCKS."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' source")
    out = tmp_path_factory.mktemp("host_icp")
    cpp = out / "ransac.cpp"
    cpp.write_text(host_source((kernels.CSRC / "ransac.cu").read_text()))
    libs = {}

    def lib(blocks):
        if blocks not in libs:
            so = out / f"libransac_{blocks}.so"
            grid = [] if blocks == icp.ICP_BLOCKS else \
                [f"-DEYOC_ICP_BLOCKS={blocks}"]
            proc = subprocess.run(
                [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *grid, "-I",
                 str(HOST_HEADERS), "-I", str(kernels.CSRC), "-o", str(so),
                 str(cpp)],
                capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr
            libs[blocks] = ctypes.CDLL(str(so))
        return libs[blocks]
    return lib


@pytest.fixture
def tickets():
    return torch.zeros(256, dtype=torch.int32)


@pytest.fixture
def on_host(host_libs, monkeypatch, tickets):
    """on_host(blocks): the wrapper's launch code calls the host build of
    that grid; its scratch comes poisoned, its tickets are one zeroed
    array kept across calls."""
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "ticket", lambda dev, count=1: tickets)
    monkeypatch.setattr(icp, "_scratch", lambda n, device: torch.full(
        (n,), float("nan")))

    def use(blocks):
        lib = host_libs(blocks)

        def load(name, argtypes, symbol=None):
            fn = getattr(lib, f"eyoc_{symbol or name}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        monkeypatch.setattr(kernels, "load", load)
    return use


def icp_round(n, seed, hole=None):
    """A round's inputs: a cloud, its copy under a small pose with noise,
    both with invalid rows (and the source's rows `hole` invalid), and the
    nearest valid targets of the source."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    T = random_pose(rng, angle=0.05, trans=0.1)
    t = (s @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, s.shape))
    sm = rng.random(n) > 0.2
    if hole is not None:
        sm[hole] = False
    src, tgt = torch.from_numpy(s), torch.from_numpy(t.astype(np.float32))
    sm, tm = torch.from_numpy(sm), torch.from_numpy(rng.random(n) > 0.2)
    d2, nn = masked_argmin_plain(src, sm, tgt, tm)
    return src, sm, tgt, nn, d2


CASES = {
    # N not a multiple of the chunk: chunks of 8, the last of 1, 2 empty
    "ragged": (1001, 128, None),
    # two rows a thread (chunks of 429 rows), the last chunk short
    "two_rows_a_thread": (3000, 7, None),
    # the first two chunks (16 rows each) without a valid row
    "empty_chunk": (2000, 128, slice(0, 32)),
    # more blocks than rows: chunks of one row, most blocks empty
    "tiny": (40, 128, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_icp_source_chained_launches(on_host, tickets, case):
    n, blocks, hole = CASES[case]
    on_host(blocks)
    args = icp_round(n, len(case), hole)
    for r2 in (0.25, 0.0):                  # 0: no correspondence
        T_k, w_k = icp._launch_icp_solve(*args, r2)
        assert torch.equal(tickets, torch.zeros_like(tickets))
        T_2, w_2 = icp._launch_icp_solve(*args, r2)
        assert torch.equal(T_k, T_2) and torch.equal(w_k, w_2)
        T_p, w_p = icp.icp_solve_plain(*args, r2)
        assert float((T_k - T_p).abs().max()) < POSE_TOL
        assert float((w_k - w_p).abs().max()) < WARP_TOL
        T_m, _ = icp.icp_solve_chunked_plain(*args, r2, blocks=blocks)
        assert torch.equal(T_k, T_m)
        if r2 == 0.0:
            assert torch.equal(T_k, torch.eye(4))
            assert torch.equal(w_k, args[0])


@pytest.mark.parametrize("n,blocks", [(1001, 128), (3000, 7), (4096, 128),
                                      (40, 128)])
def test_icp_chunked_plain_matches_plain(n, blocks):
    """The mirror's order of sums moves the pose by rounding only."""
    args = icp_round(n, n)
    for r2 in (0.25, 0.01):
        T_m, w_m = icp.icp_solve_chunked_plain(*args, r2, blocks=blocks)
        T_p, w_p = icp.icp_solve_plain(*args, r2)
        assert float((T_m - T_p).abs().max()) < POSE_TOL
        assert float((w_m - w_p).abs().max()) < WARP_TOL
        assert not torch.equal(T_m, torch.eye(4))
