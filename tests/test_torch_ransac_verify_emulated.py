"""K17 `ransac_verify`'s own CUDA source (csrc/ransac.cu `verify`: one
launch of pose groups x row splits) built for the host with g++ against
tests/cuda_host/cuda_runtime.h and run through the wrapper's launch code on
CPU tensors, held bit-equal to `ransac_verify_plain` on the counts and
`best`, and to the same test in unfused f32 (residual2's order, in numpy):

- `keep` of 64 and of 2048 rows, and `keep` None over 3000 hypotheses:
  one and several pose groups, a ragged last group (3000 = 11 x 256 +
  184);
- N = 256 and N = 1300 rows: with the default build the rows go to many
  splits (their counts added behind a ticket a group); a host build with
  -DEYOC_VERIFY_BLOCKS_PER_SM=0 gives one split a group, so a block walks
  several row tiles (1300 = 2 x 512 + 276, a ragged last tile);
- `valid` with holes (and an invalid tail), so tiles are compacted;
- every edge check failed: every count -1, and best the first kept row;
- the largest count tied across two pose groups: the lowest index wins;
- the ticket and sum words back at zero after every call (each launch
  resets the words it uses), and two calls in a row giving the same bits;
- the plain version's counts within a band of JAX's `_count_inliers`
  under jax.jit (equal but for tests within 1e-5 of the threshold);
- the C entry's group count equal to the wrapper's mirror.

What only the card can show (that nvcc takes the source, the real
interleaving of the blocks at the tickets) is `chip_smoke.py`'s."""

import ctypes
import functools
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from eyoc_tpu.registration import ransac as jransac
from eyoc_tpu_torch.registration import ransac
from eyoc_tpu_torch.utils import kernels
from test_torch_ransac import correspondences
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


THR, RATIO, H = 0.3, 0.9, 3000
BUILDS = {"splits": [], "one_split": ["-DEYOC_VERIFY_BLOCKS_PER_SM=0"]}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{build: ctypes library} built by g++ from csrc/ransac.cu, the two
    builds at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' source")
    out = tmp_path_factory.mktemp("host_verify")
    cpp = out / "ransac.cpp"
    cpp.write_text(host_source((kernels.CSRC / "ransac.cu").read_text()))
    procs = {}
    for name, flags in BUILDS.items():
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", *flags, "-I",
             str(HOST_HEADERS), "-I", str(kernels.CSRC), "-o", str(lib),
             str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def use_build(build, host_libs, monkeypatch):
    """The wrapper's launch code calls one host build; the ticket words
    are a zeroed CPU array of the size asked for. Returns the tickets."""
    lib = host_libs[build]

    def load(name, argtypes, symbol=None):
        fn = getattr(lib, f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    tickets = torch.zeros(8192, dtype=torch.int32)

    def ticket(dev, count=1):
        assert count <= tickets.numel()
        return tickets

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "ticket", ticket)
    monkeypatch.setattr(ransac, "_k17_words", {})
    return tickets


@pytest.fixture(params=sorted(BUILDS))
def each_build(request, host_libs, monkeypatch):
    """`use_build` for each host build in turn."""
    return use_build(request.param, host_libs, monkeypatch)


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """`use_build` for the default build (the card's splits)."""
    return use_build("splits", host_libs, monkeypatch)


def hypotheses(n, nv, seed, holes=False):
    """(trans [H, 4, 4], coarse [H], src, tgt, valid): the plain K16's
    poses and 64-row subset counts of H triplets of n correspondences (40%
    inliers, the first nv valid; with `holes` every 7th valid row
    invalid)."""
    src, tgt, valid, _ = correspondences(seed, n, 0.4, nv)
    if holes:
        valid[::7] = False
    rng = np.random.default_rng(seed)
    u_tri = torch.from_numpy(rng.random((H, 3)).astype(np.float32))
    u_sub = torch.from_numpy(rng.random(64).astype(np.float32))
    src, tgt, valid = map(torch.from_numpy, (src, tgt, valid))
    trans, coarse = ransac.ransac_hypotheses_plain(src, tgt, valid, u_tri,
                                                   u_sub, THR, RATIO)
    return trans, coarse, src, tgt, valid


def unfused_counts(trans, coarse, keep, src, tgt, valid):
    """residual2 < thr^2 in f32 numpy, one rounding an operation in the
    kernel's order: ((R0 x + R1 y) + R2 z) + t, then (dx dx + dy dy) + dz
    dz; -1 where the edge check failed."""
    rows = np.arange(trans.shape[0]) if keep is None else keep.numpy()
    T = trans.numpy()[rows][:, :3, :, None]           # [Hk, 3, 4, 1]
    s, t = src.numpy()[valid.numpy()], tgt.numpy()[valid.numpy()]
    o = [((T[:, r, 0] * s[:, 0] + T[:, r, 1] * s[:, 1]) + T[:, r, 2] * s[:, 2])
         + T[:, r, 3] for r in range(3)]                # [Hk, n] each
    d = [o[r] - t[:, r] for r in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    out = np.count_nonzero(d2 < np.float32(THR * THR), 1).astype(np.float32)
    return np.where(coarse.numpy()[rows] >= 0, out, np.float32(-1.0))


def verify_both(trans, coarse, keep, src, tgt, valid):
    """K17 through the host build and the plain version: counts and best
    bit-equal to each other and to the unfused mirror; returns them."""
    counts, best = ransac._launch_k17(trans, coarse, keep, src, tgt, valid,
                                      THR)
    counts_p, best_p = ransac.ransac_verify_plain(trans, coarse, keep, src,
                                                  tgt, valid, THR)
    assert counts.dtype == torch.float32 and best.dtype == torch.int32
    assert torch.equal(counts, counts_p)
    assert int(best) == int(best_p)
    np.testing.assert_array_equal(
        counts.numpy(), unfused_counts(trans, coarse, keep, src, tgt, valid))
    return counts, best


@pytest.mark.parametrize("k", [64, 2048, None])
@pytest.mark.parametrize("n,nv,holes", [(256, 256, False), (1300, 1250, True)])
def test_k17_source_matches_plain(each_build, k, n, nv, holes):
    trans, coarse, src, tgt, valid = hypotheses(n, nv, n + nv, holes)
    keep = None if k is None else ransac.topk(coarse, k)[1].int()
    counts, best = verify_both(trans, coarse, keep, src, tgt, valid)
    assert float(counts.max()) >= 0.3 * float(valid.sum())  # a true pose
    assert int((counts < 0).sum()) > 0 or k is not None     # failed edges
    for words in ransac._k17_words.values():     # every sum word back at 0
        assert not bool(words.any())
    assert not bool(each_build.any())            # every ticket word too
    if k != 2048:
        return
    # the same bits again (8 pose groups, their words used twice)
    again, best2 = ransac._launch_k17(trans, coarse, keep, src, tgt, valid,
                                      THR)
    assert torch.equal(again.view(torch.int32), counts.view(torch.int32))
    assert int(best2) == int(best)
    assert not bool(each_build.any())
    for words in ransac._k17_words.values():
        assert not bool(words.any())


@pytest.mark.parametrize("k", [64, None])
def test_k17_source_all_edges_failed(on_host, k):
    """No live pose: every count -1, best the first kept row."""
    trans, coarse, src, tgt, valid = hypotheses(256, 200, 5)
    keep = None if k is None else torch.arange(H - 1, H - 1 - 3 * k, -3,
                                               dtype=torch.int32)
    failed = torch.full_like(coarse, -1.0)
    counts, best = verify_both(trans, failed, keep, src, tgt, valid)
    assert bool((counts == -1).all())
    assert int(best) == (0 if keep is None else int(keep[0]))


@pytest.mark.parametrize("keep_rows", [False, True])
def test_k17_source_tie_across_groups(on_host, keep_rows):
    """The largest count only at two places in two pose groups (7 and 300;
    every other pose that reaches it failed): the lower place's row is
    best."""
    trans, coarse, src, tgt, valid = hypotheses(300, 300, 11)
    counts, top = ransac.ransac_verify_plain(trans, coarse, None, src, tgt,
                                             valid, THR)
    trans, coarse = trans.clone(), coarse.clone()
    coarse[counts == counts.max()] = -1.0
    a, b = (7, 300) if not keep_rows else (H - 5, 11)
    for h in (a, b):                       # two rows of the top pose
        trans[h], coarse[h] = trans[int(top)], 0.0
    keep = None
    if keep_rows:                          # keep[7] names a, keep[300] b
        rest = torch.tensor([h for h in range(H) if h not in (a, b)])
        keep = rest[torch.randperm(H - 2, generator=torch.Generator()
                                   .manual_seed(0))[:2048]].int()
        keep[7], keep[300] = a, b
    counts, best = verify_both(trans, coarse, keep, src, tgt, valid)
    assert counts[7] == counts[300] == counts.max()
    assert int((counts == counts.max()).sum()) == 2
    assert int(best) == a


def test_k17_groups_mirror(host_libs):
    fn = host_libs["splits"].eyoc_ransac_verify_groups
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for hk in (1, 255, 256, 257, 2048, 3000, 1048576):
        assert fn(hk) == -(-hk // ransac.K17_GROUP)


def test_k17_counts_near_jax():
    """The plain version's counts (the kernel's bits in the tests above)
    against JAX's `_count_inliers` under jax.jit with its -1 for a failed
    edge check: equal on every hypothesis with no test within 1e-5 of the
    threshold."""
    trans, coarse, src, tgt, valid = hypotheses(1300, 1250, 3, holes=True)
    keep = ransac.topk(coarse, 2048)[1].int()
    counts, _ = ransac.ransac_verify_plain(trans, coarse, keep, src, tgt,
                                           valid, THR)
    kept = trans[keep.long()]
    jfn = jax.jit(functools.partial(jransac._count_inliers, thresh=THR,
                                    chunk=512))
    want = np.asarray(jfn(kept.numpy(), src.numpy(), tgt.numpy(),
                          valid.numpy()))
    want = np.where(coarse.numpy()[keep.numpy()] >= 0, want, -1.0)
    s = src.double().numpy()[valid.numpy()]
    t = tgt.double().numpy()[valid.numpy()]
    T = kept.double().numpy()
    d2 = (((s[None] @ T[:, :3, :3].transpose(0, 2, 1)) + T[:, None, :3, 3]
           - t[None]) ** 2).sum(-1)
    clear = ~(np.abs(d2 - THR * THR) < 1e-5).any(1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(counts.numpy()[clear], want[clear])
