"""K21 `masked_norm_backward` (csrc/norm_backward.cu), K20's statistics
output and K22 `masked_norm_apply` (csrc/instance_norm.cu) built with g++
against tests/cuda_host/ (each CUDA thread a fiber; a cooperative launch
a grid of up to 8 blocks, all live at once) and run through the wrappers'
launch code on CPU bf16 tensors, against their plain versions.

K21 is one cooperative launch over `k21_grid`'s blocks; the host build
caches at most HOST_CACHE_BYTES of a block's rows (-DEYOC_NORM_CACHE_BYTES),
so most cases read some rows again in the dx pass, and the wrappers see a
card that holds `RESIDENT[case]` blocks (2 to 8): blocks straddle segment
boundaries, and each segment's sums come from several blocks. Cases: the
instance norm's backward over 3 clouds (one with no valid row, one with a
single valid row, a constant channel), the batch norm's over one segment
spread over several blocks, C = 32, 64, 256 and 512; every tail (bare,
ReLU, residual, ReLU with the pre-ReLU output's gradient). Compared: dx
within BF16_ULPS units in the last place of the plain version's
(`ulps_apart`), dresidual bit-equal, dscale / dbias within K21_REL of the
plain sums of absolute values; the scratch comes poisoned with NaN and a
second call gives the same bits. The same cases through K21's mirror on
the kernel's grid (`masked_norm_backward_chunked_plain(grid=...)`). K20's
statistics output (mean, rstd, live: what the backward reads) against the
plain version's within STATS_RTOL, live equal. K22: bit-equal to its
plain version at one segment and at three."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.sparse import norm as N
from eyoc_tpu_torch.utils import kernels
from test_torch_instance_norm import ulps_apart
from test_torch_norm_backward import TAILS, backward_case, rows
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


BF16_ULPS = 1          # bf16 dx of f32 coefficients summed in two orders
K21_REL = 1e-5         # f32 sums over <= 3000 rows in two orders
STATS_RTOL = 1e-5      # K20's f32 statistics, two orders (rsqrt vs 1/sqrt)
SOURCES = ("norm_backward", "instance_norm")
HOST_CACHE_BYTES = 98304
# (S, cap, C): the blocks the wrappers are told the card holds
RESIDENT = {(3, 300, 64): 8, (1, 3000, 32): 8, (2, 100, 512): 3,
            (1, 2000, 256): 5, (1, 600, 512): 8, (3, 200, 32): 2,
            (3, 100, 256): 7, (3, 40, 512): 4, (3, 700, 32): 6}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build the kernels' sources")
    out = tmp_path_factory.mktemp("host_norm_backward")
    libs = {}
    for name in SOURCES:
        cpp = out / f"{name}.cpp"
        cpp.write_text(host_source((kernels.CSRC / f"{name}.cu").read_text()))
        so = out / f"lib{name}.so"
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                               f"-DEYOC_NORM_CACHE_BYTES={HOST_CACHE_BYTES}",
                               "-I", str(HOST_HEADERS), "-o", str(so),
                               str(cpp)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' launch code on the host builds: CPU tensors pass the
    CUDA-only checks, the scratch comes poisoned with NaN, the ticket words
    are one zeroed array kept across calls (K21 takes none: they stay at
    zero), and the card holds `resident["blocks"]` blocks of K21 (8 unless
    a test sets it)."""
    tickets = torch.zeros(256, dtype=torch.int32)
    resident = {"blocks": 8}

    def load(name, argtypes, symbol=None):
        fn = getattr(host_libs[name], f"eyoc_{symbol or name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn
    nan = lambda n, x: torch.full((n,), float("nan"))     # noqa: E731
    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "require_cuda",
                        lambda name, *tensors, dtypes=None: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "ticket", lambda dev, count=1: tickets)
    monkeypatch.setattr(N, "_k20_scratch", nan)
    monkeypatch.setattr(N, "_k21_scratch", nan)
    monkeypatch.setattr(N, "_k21_resident", lambda dev: resident["blocks"])
    return tickets, resident


def abs_sums(x, mask, S, stats, dy, y, dpre):
    """[S, 2C]: the plain sums of |dy0| and |dy0 xhat| a segment, the size
    of dscale's and dbias's terms."""
    M, C = x.shape
    d = N._grad_at_norm(dy, y, dpre, x.dtype).abs()
    d = d * mask.float()[:, None]
    mean, rstd, _ = stats.reshape(S, 3, C).unbind(1)
    xh = ((x.float().reshape(S, M // S, C) - mean[:, None])
          * rstd[:, None]).abs()
    return d.reshape(S, M // S, C).sum(1), (d.reshape(S, M // S, C)
                                            * xh).sum(1)


@pytest.mark.parametrize("S,cap,C", list(RESIDENT))
def test_k21_source_matches_plain(on_host, S, cap, C):
    tickets, resident = on_host
    resident["blocks"] = RESIDENT[(S, cap, C)]
    grid = N.k21_grid(S * cap, C, resident["blocks"])
    assert 2 <= grid[0] <= 8
    for tail in TAILS:
        args = backward_case(S, cap, C, 30 + S, tail, torch.bfloat16)
        x, mask, _, scale, stats, dy, y, dpre, residual = args
        counter = "masked_norm_backward_bn" if S == 1 else \
            "masked_norm_backward"
        before = kernels.launches[counter]
        got = N._launch_k21(*args, counter)
        assert kernels.launches[counter] == before + 1
        want = N.masked_norm_backward_plain(*args)
        mirror = N.masked_norm_backward_chunked_plain(*args, grid=grid)
        sdy_abs, sdyxh_abs = abs_sums(x, mask, S, stats, dy, y, dpre)
        for ref in (want, mirror):
            dx, dres, ds, db = got
            assert dx.dtype == torch.bfloat16
            assert torch.isfinite(dx.float()).all()
            assert ulps_apart(dx, ref[0]) <= BF16_ULPS, tail
            assert not dx[~mask].any()
            if residual:
                assert torch.equal(dres, ref[1])
            else:
                assert dres is None
            for g, w, size in ((ds, ref[2], sdyxh_abs),
                               (db, ref[3], sdy_abs)):
                assert (g - w).abs().max() <= \
                    K21_REL * size.sum(0).max() + 1e-6
        assert not tickets.any()                  # no ticket word left
        again = N._launch_k21(*args, counter)
        for a, b in zip(got, again):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("S,cap,C", [(3, 300, 64), (2, 100, 512)])
def test_k20_statistics_output_matches_plain(on_host, S, cap, C):
    x, mask, scale, bias, _, _, _ = rows(S, cap, C, 40 + S)
    t = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask), S,
         torch.from_numpy(scale), torch.from_numpy(bias))
    (y, stats) = N._launch_k20(*t, 1e-5, True, None, False, True)
    y_eval = N._launch_k20(*t, 1e-5, True, None, False)
    assert torch.equal(y, y_eval)                 # the eval output's bits
    _, want = N.masked_instance_norm_plain(*t, relu=True, with_stats=True)
    got, want = stats.reshape(S, 3, C), want.reshape(S, 3, C)
    np.testing.assert_allclose(got[:, :2].numpy(), want[:, :2].numpy(),
                               rtol=STATS_RTOL, atol=1e-6)
    assert torch.equal(got[:, 2], want[:, 2])     # var_raw > 0
    if S == 3:
        assert not got[1:, 2].any()               # empty, single row: 0


@pytest.mark.parametrize("S", [1, 3])
def test_k22_source_matches_plain(on_host, S):
    C = 64
    x, mask, scale, bias, res, _, _ = rows(S, 300, C, 50 + S)
    bf = torch.bfloat16
    xt, mt = torch.from_numpy(x).to(bf), torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(S)
    gof = torch.cat([torch.rand((S, C), generator=gen) * 40.0,
                     torch.randn((S, C), generator=gen)], 1)
    r = torch.from_numpy(res).to(bf)
    for kw in (dict(), dict(relu=True), dict(relu=True, skip=True),
               dict(residual=r)):
        before = kernels.launches["masked_norm_apply"]
        got = N._launch_k22(xt, mt, gof, kw.get("relu", False),
                            kw.get("residual"), kw.get("skip", False))
        assert kernels.launches["masked_norm_apply"] == before + 1
        want = N.masked_norm_apply_plain(xt, mt, gof, **kw)
        for a, b in zip(got if kw.get("skip") else (got,),
                        want if kw.get("skip") else (want,)):
            assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take(on_host):
    x, mask, scale, _, _, dy, _ = rows(1, 64, 12, 0)
    bf = torch.bfloat16
    xt, mt = torch.from_numpy(x).to(bf), torch.from_numpy(mask)
    with pytest.raises(ValueError):
        N._launch_k22(xt, mt, torch.ones(1, 24), False, None, False)
    with pytest.raises(ValueError):
        N._launch_k21(xt, mt, 1, torch.from_numpy(scale),
                      torch.zeros(1, 36), torch.from_numpy(dy).to(bf), None,
                      None, False, "masked_norm_backward")
    x8 = torch.zeros(60, 8, dtype=bf)
    with pytest.raises(ValueError):                  # 60 rows, 7 segments
        N._launch_k21(x8, torch.ones(60, dtype=torch.bool), 7,
                      torch.ones(8), torch.zeros(7, 24), x8, None, None,
                      False, "masked_norm_backward")
