"""K12 `conv_maps` (csrc/conv_maps.cu) at a first conv of side 7, its own
source built for the host with g++ against tests/cuda_host/ and run
through the wrapper's launch code on CPU tensors: every map bit-equal to
`conv_maps_staged_plain` (and to `conv_maps_plain`), with and without the
inverses (whose collision count stays 0; the side-7 map takes none), at
runs of 3, 5 and 32 rows a block, with every output allocated poisoned so
that each entry must be written, and on a pyramid whose level-0 bricks
overflow.

A side-7 entry is its row's cube base plus the tap's offset, or the
sentinel where the row's cell fails the tap's per-axis cell bits (the cell
lies past the 6 x 6 x 6 stage); this checks the packed entry table, the
cell test and the 16-byte stores at T = 343 on the CPU. What only the card
can show is `chip_smoke.py`'s."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.training import pipeline as tpipe
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
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),.*?>>>\(", re.S)
VOXEL = 0.3
BITS = (7, 7, 6)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ctypes library built by g++ from csrc/conv_maps.cu."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernel's source")
    out = tmp_path_factory.mktemp("host_conv_maps")
    cpp = out / "conv_maps.cpp"
    cpp.write_text(LAUNCH.sub(r"HostLaunch{(unsigned)(\2), "
                              r"(unsigned)(\3)}(\1, ",
                              (kernels.CSRC / "conv_maps.cu").read_text()))
    lib = out / "libconv_maps.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-I", str(HOST_HEADERS), "-o", str(lib), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    def load(name, argtypes, symbol=None):
        fn = getattr(host_lib, f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)


@pytest.fixture(params=[-7, 0])
def poisoned(request, monkeypatch):
    """torch.empty gives int tensors filled with -7 (no entry holds it) or
    with 0: an entry that no thread writes differs under one of the two."""
    empty = torch.empty

    def filled(*size, dtype=None, device=None, **kw):
        t = empty(*size, dtype=dtype, device=device, **kw)
        return t.fill_(bool(request.param) if t.dtype is torch.bool
                       else request.param)

    monkeypatch.setattr(torch, "empty", filled)


def pyramid(caps, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 2.5, (2, 700, 3)).astype(np.float32)
    counts = np.array([700, 500], np.int32)
    _, pyr = tpipe.preprocess_clouds(torch.from_numpy(xyz),
                                     torch.from_numpy(counts), caps=caps,
                                     voxel_size=VOXEL, window_bits=BITS)
    return pyr


def assert_maps_equal(got, want, what):
    for name in tbc.ConvMaps._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is None and b is None, f"{what}.{name}"
            continue
        for i, (x, y) in enumerate(zip(a, b) if isinstance(a, tuple)
                                   else [(a, b)]):
            assert x.dtype == y.dtype and x.shape == y.shape, f"{what}.{name}"
            assert torch.equal(x, y), (f"{what}.{name}[{i}]: "
                                       f"{int((x != y).sum())} differ")


@pytest.mark.parametrize("rows", [3, 5, 32])
def test_k12_source_side7(on_host, poisoned, monkeypatch, rows):
    monkeypatch.setattr(tbc, "K12_ROWS", rows)
    pyr = pyramid((1024, 256, 64, 32), 7)
    for inverse in (False, True):
        got = tbc._launch_k12(pyr, 4, 7, inverse)
        want = tbc.conv_maps_staged_plain(pyr, 4, 7, inverse)
        assert_maps_equal(got, want, f"rows={rows} inverse={inverse}")
        assert got.first.shape == (pyr.levels[0].cellslot.shape[0], 343)
        if inverse:
            tbc.collision_check(got.inv_same3[0]).raise_if_any()
    assert_maps_equal(got, tbc.conv_maps_plain(pyr, 4, 7, True), "plain")
    # the reach: no valid row reads more than 216 voxels
    M = got.first.shape[0]
    assert int((got.first < M).sum(1).max()) <= 216


def test_k12_source_side7_overflow(on_host):
    """Level-0 bricks at their cap (the dropped diagonal taps across the
    bricks that did not fit)."""
    caps = (256, 64, 32, 16)
    pyr = pyramid(caps, 8)
    full = tpipe.brick_caps(caps)[0]
    assert bool((pyr.levels[0].bmask.reshape(2, -1).sum(1) == full).all())
    assert_maps_equal(tbc._launch_k12(pyr, 4, 7, True),
                      tbc.conv_maps_staged_plain(pyr, 4, 7, True), "overflow")
