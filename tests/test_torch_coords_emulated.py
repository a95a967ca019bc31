"""The coordinate kernels' own CUDA sources (K10 csrc/voxelize.cu, K11
brick_pyramid.cu, K12 conv_maps.cu) built for the host with g++ against
tests/cuda_host/cuda_runtime.h, and run through the wrappers' launch code
on CPU tensors: every output bit-equal to the plain version; K10's
compaction also at tiles of 7 and 128 sorted keys (hundreds of blocks a
cloud, chained by its look-back), with an empty cloud, an all-invalid one
and the capacity reached inside a tile; K11's one pass at tiles of a few
rows (one cloud over many blocks, the look-back chaining them), with cuts
at every level inside a tile, an empty and an all-masked cloud and masked
rows between voxels of one brick; K12 at runs of a few rows (bricks split
across blocks); both with their outputs allocated poisoned, so that every
byte must be written; K12's collision count raising at the first conv
backward, not in the call.

This checks the kernels' indexing, scans, searches and scatters on the
CPU; what only the card can show (that nvcc takes the source, the launch
configuration, the real thread interleaving) is `chip_smoke.py`'s."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.sparse import brick_conv as tbc
from eyoc_tpu_torch.sparse import bricks as tbricks
from eyoc_tpu_torch.sparse import voxelize as tvox
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
SOURCES = ("voxelize", "brick_pyramid", "conv_maps")
VOXEL = 0.3
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),.*?>>>\(", re.S)


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
        cpp.write_text(LAUNCH.sub(r"HostLaunch{(unsigned)(\2), "
                                  r"(unsigned)(\3)}(\1, ", src))
        lib = out / f"lib{name}.so"
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                               "-pthread", "-I", str(HOST_HEADERS), "-o",
                               str(lib), str(cpp)], capture_output=True,
                              text=True)
        assert proc.returncode == 0, proc.stderr
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' launch code calls the host build: kernels.load gives
    its entry points, and the CUDA-only checks pass CPU tensors through."""
    def load(name, argtypes, symbol=None):
        fn = getattr(host_libs[name], f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)


def assert_equal(a, b, what=""):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, tuple):
        assert len(a) == len(b), what
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            assert_equal(x, y, f"{what}.{name}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), f"{what}: {int((a != b).sum())} differ"


def clouds(B, n, seed, bits):
    """Gaussian clouds with points on voxel faces, duplicates, points
    outside the window and masked tails."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 3.0, (B, n, 3)).astype(np.float32)
    xyz[:, ::7] = (np.round(xyz[:, ::7] / np.float32(VOXEL))
                   * np.float32(VOXEL))
    xyz[:, 5::11] = xyz[:, 4::11][:, :xyz[:, 5::11].shape[1]]
    xyz[:, -30:] *= 40.0
    counts = np.array([n - 300 * b for b in range(B)], np.int32)
    return torch.from_numpy(xyz), torch.from_numpy(counts)


@pytest.mark.parametrize("B,caps,bits", [
    (1, (4096, 1024, 256, 128), (7, 7, 6)),
    (2, (2048, 768, 256, 96), (7, 7, 6)),
    (3, (1024, 256, 64, 32), (7, 7, 6)),          # every overflow
    (2, (8192, 4096, 2048, 1024), (10, 10, 8)),   # none
])
def test_k10_k11_k12_sources_match_plain(on_host, B, caps, bits):
    xyz, counts = clouds(B, 3000, B, bits)
    cap = caps[0]
    vox, keys = tvox._launch_k10(xyz, counts, VOXEL, cap, bits)
    plain = tvox.voxelize_batched_plain(xyz, counts, VOXEL, cap, bits)
    assert_equal((vox, keys), plain, "K10")
    mask = vox.mask.reshape(-1)
    bcs = tpipe.brick_caps(caps)
    pyr = tbricks._launch_k11(keys, mask, B, bcs, bits)
    want = tbricks.build_pyramid_plain(keys, mask, B, bcs, bits)
    assert_equal(tuple(pyr.levels), tuple(want.levels), "K11 levels")
    assert_equal(tuple(pyr.vox_masks), tuple(want.vox_masks), "K11 masks")
    assert_equal(pyr.counts, want.counts, "K11 counts")
    for inverse, k1 in ((False, 5), (True, 5), (True, 3)):
        assert_equal(tuple(tbc._launch_k12(want, 4, k1, inverse)),
                     tuple(tbc.conv_maps_plain(want, 4, k1, inverse)),
                     f"K12 inverse={inverse} k1={k1}")


@pytest.mark.parametrize("tile", [7, 128, 2048])
@pytest.mark.parametrize("cap", [2048, 700])
def test_k10_source_tiles(on_host, monkeypatch, tile, cap):
    from test_torch_coords import k10_tile_clouds
    xyz, counts = map(torch.from_numpy, k10_tile_clouds())
    monkeypatch.setattr(tvox, "K10_TILE", tile)
    got = tvox._launch_k10(xyz, counts, VOXEL, cap, (7, 7, 6))
    assert_equal(got, tvox.voxelize_batched_plain(xyz, counts, VOXEL, cap,
                                                  (7, 7, 6)), f"K10 {tile}")
    assert_equal(got, tvox.voxelize_tiled_plain(xyz, counts, VOXEL, cap,
                                                (7, 7, 6), tile), "mirror")


def test_k12_source_counts_collisions(on_host):
    """Every brick taking one brick as its +z neighbour: K12 counts the
    collisions on the device, the call returns without reading the count,
    and the first conv backward over one of its inverses raises as
    invert_map does, with the same count, before dX reads the inverse."""
    xyz, counts = clouds(1, 3000, 9, (7, 7, 6))
    _, pyr = tpipe.preprocess_clouds(xyz, counts,
                                     caps=(4096, 1024, 256, 128),
                                     voxel_size=VOXEL, window_bits=(7, 7, 6))
    lv = pyr.levels[0]
    # the target: the brick with the most voxels at z = 0 within it
    target = int(lv.occ.reshape(-1, 8)[:, 0::2].sum(1).argmax())
    nbr6 = lv.nbr6.clone()
    nbr6[5] = torch.where(lv.bmask, torch.full_like(nbr6[5], target),
                          nbr6[5])
    bad = pyr._replace(levels=(lv._replace(nbr6=nbr6),) + pyr.levels[1:])
    with pytest.raises(ValueError) as plain:
        tbc.conv_maps_plain(bad, 4, 5, inverse=True)
    maps = tbc._launch_k12(bad, 4, 5, True)
    checks = {id(tbc.collision_check(i)) for part in (
        maps.inv_same3, maps.inv_down, maps.inv_up) for i in part}
    assert len(checks) == 1 and None not in {
        tbc.collision_check(maps.inv_same3[0])}
    M = lv.cellslot.shape[0]
    x = torch.ones((M, 8), requires_grad=True)
    W = torch.ones((27, 8, 8))
    out = tbc.SparseConvFunction.apply(x, None, W, maps.same3[0],
                                       maps.inv_same3[0])
    with pytest.raises(ValueError) as kernel:
        out.sum().backward()
    assert str(kernel.value) == str(plain.value)
    # a good pyramid's inverses pass the same check
    good = tbc._launch_k12(pyr, 4, 5, True)
    out = tbc.SparseConvFunction.apply(x, None, W, good.same3[0],
                                       good.inv_same3[0])
    out.sum().backward()
    assert x.grad is not None


@pytest.fixture(params=[-7, 0])
def poisoned(request, monkeypatch):
    """torch.empty gives tensors filled with a value no output holds
    (int -7, bool True), or with zeros: an output byte that no thread
    writes differs from the plain version under one of the two."""
    empty = torch.empty

    def filled(*size, dtype=None, device=None, **kw):
        t = empty(*size, dtype=dtype, device=device, **kw)
        return t.fill_(bool(request.param) if t.dtype is torch.bool
                       else request.param)

    monkeypatch.setattr(torch, "empty", filled)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("tile", [7, 64])
def test_k11_source_tiles(on_host, poisoned, monkeypatch, B, tile):
    """K11's one pass at tiles of 7 and 64 rows on
    test_torch_pyramid_onepass's rows (B = 8: every level cut, the level-0
    cut inside a tile; an empty and an all-masked cloud; masked rows
    between voxels of one brick), against the plain version and the
    one-pass mirror at the same tile."""
    from test_torch_pyramid_onepass import BITS, CASES, level0_rows
    caps = dict(CASES)[B]
    keys, mask = map(torch.from_numpy, level0_rows(B, seed=B))
    monkeypatch.setattr(tbricks, "K11_TILE", tile)
    got = tbricks._launch_k11(keys, mask, B, caps, BITS)
    want = tbricks.build_pyramid_plain(keys, mask, B, caps, BITS)
    assert_equal(tuple(got.levels), tuple(want.levels), "K11 levels")
    assert_equal(tuple(got.vox_masks), tuple(want.vox_masks), "K11 masks")
    assert_equal(got.counts, want.counts, "K11 counts")
    mirror = tbricks.build_pyramid_onepass_plain(keys, mask, B, caps, BITS,
                                                 tile)
    assert_equal(tuple(got), tuple(mirror), "mirror")


@pytest.mark.parametrize("rows", [3, 5, 32])
def test_k12_source_runs(on_host, poisoned, monkeypatch, rows):
    """K12's maps at runs of 3, 5 and 32 output rows a block (a brick's
    voxels split across blocks), on a voxelized pyramid whose level-0
    bricks overflow (maps and inverses) and on the masked rows' pyramid of
    test_torch_pyramid_onepass (maps), against the plain version."""
    from test_torch_pyramid_onepass import BITS, CASES, level0_rows
    monkeypatch.setattr(tbc, "K12_ROWS", rows)
    xyz, counts = clouds(2, 1500, 4, (7, 7, 6))
    _, pyr = tpipe.preprocess_clouds(xyz, counts, caps=(512, 128, 48, 16),
                                     voxel_size=VOXEL, window_bits=(7, 7, 6))
    assert bool((pyr.levels[0].bmask.reshape(2, -1).sum(1) == 128).all())
    for k1, inverse in ((5, True), (3, False)):
        assert_equal(tuple(tbc._launch_k12(pyr, 4, k1, inverse)),
                     tuple(tbc.conv_maps_plain(pyr, 4, k1, inverse)),
                     f"K12 k1={k1}")
    keys, mask = map(torch.from_numpy, level0_rows(8, seed=8))
    masked = tbricks.build_pyramid_plain(keys, mask, 8, dict(CASES)[8], BITS)
    assert_equal(tuple(tbc._launch_k12(masked, 4, 5, False)),
                 tuple(tbc.conv_maps_plain(masked, 4, 5, False)), "masked")
