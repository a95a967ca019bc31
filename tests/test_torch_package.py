"""The port's package boundaries: it imports neither JAX nor eyoc_tpu, its
entry points default to the GPU and refuse to run without one, and a kernel
wrapper given a non-CPU tensor launches its kernel or raises — it never
falls back to its plain version."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import eyoc_tpu_torch
from eyoc_tpu_torch import api, eval as teval
from eyoc_tpu_torch.models import ResUNet, UNetSpec, init_unet, load_model
from eyoc_tpu_torch.ops import knn
from eyoc_tpu_torch.registration import sc2pcr
from eyoc_tpu_torch.sparse import brick_conv
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        eyoc_tpu_torch.__path__, "eyoc_tpu_torch."))


def test_imports_neither_jax_nor_eyoc_tpu():
    mods = all_modules()
    assert "eyoc_tpu_torch.registration.sc2pcr" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'eyoc_tpu' or m.startswith('eyoc_tpu.')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_neither():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in src and "from jax" not in src
    assert "eyoc_tpu." not in src.replace("eyoc_tpu_torch", "")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        eyoc_tpu_torch.resolve_device()
    assert eyoc_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(no_cuda):
    spec = UNetSpec("tiny", "BN", "BN", (4, 4), (4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_unet(load_model("ResUNetBN2C"))
    model = ResUNet(spec, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.extract_features(model, np.zeros((10, 3), np.float32))
    batch = teval.RawBatch(*(torch.zeros(1) for _ in range(7)))
    cfg = teval.EvalConfig(caps=(64, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.test_pair(model, batch, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.embed_pair(model, batch, cfg)


class _LoaderDown(RuntimeError):
    pass


@pytest.fixture
def loader_down(monkeypatch):
    def fail(name, argtypes, symbol=None):
        raise _LoaderDown(symbol or name)
    monkeypatch.setattr(kernels, "load", fail)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_never_fall_back(loader_down):
    before = dict(kernels.launches)
    with pytest.raises(_LoaderDown, match="sparse_conv"):
        brick_conv.sparse_conv(meta(8, 4, dtype=torch.bfloat16),
                               meta(27, 4, 4, dtype=torch.bfloat16),
                               meta(8, 27, dtype=torch.int32))
    with pytest.raises(_LoaderDown, match="masked_argmin"):
        knn.masked_argmin(meta(8, 32), meta(8, dtype=torch.bool),
                          meta(9, 32), meta(9, dtype=torch.bool))
    with pytest.raises(_LoaderDown, match="sc2_power_iteration"):
        sc2pcr.sc2_power_iteration(meta(8, 3), meta(8, 3),
                                   meta(8, dtype=torch.bool), 0.1, 20)
    with pytest.raises(_LoaderDown, match="sc2_seed_counts"):
        sc2pcr.sc2_seed_counts(meta(8, 3), meta(8, 3),
                               meta(8, dtype=torch.bool),
                               meta(4, dtype=torch.int32), 0.1)
    with pytest.raises(_LoaderDown, match="sc2_seed_topk"):
        sc2pcr.sc2_seed_topk(meta(8, 3), meta(8, 3),
                             meta(8, dtype=torch.bool),
                             meta(4, dtype=torch.int32), 0.1, 3)
    assert kernels.launches == before


def test_cpu_tensors_take_the_plain_versions(loader_down):
    """On the CPU nothing is built or loaded, and nothing is counted."""
    before = dict(kernels.launches)
    x = torch.randn(10, 4)
    out = brick_conv.sparse_conv(x, torch.randn(1, 4, 3),
                                 brick_conv.identity_map(10, "cpu"))
    assert out.shape == (10, 3)
    src = torch.randn(16, 3)
    valid = torch.ones(16, dtype=torch.bool)
    knn.masked_argmin(src, valid, src, valid)
    sc2pcr.sc2_power_iteration(src, src, valid, 0.1, 5)
    sc2pcr.sc2_seed_counts(src, src, valid,
                           torch.arange(4, dtype=torch.int32), 0.1)
    idx = sc2pcr.sc2_seed_topk(src, src, valid,
                               torch.arange(4, dtype=torch.int32), 0.1, 3)
    assert idx.shape == (4, 3) and idx.dtype == torch.int32
    assert kernels.launches == before


def test_cuda_wrapper_validates_before_launch(monkeypatch):
    """With a loader that succeeds, a tensor that is not on a CUDA device
    is refused by the argument checks instead of being launched."""
    monkeypatch.setattr(kernels, "load", lambda name, argtypes: None)
    with pytest.raises(ValueError, match="CUDA"):
        knn.masked_argmin(meta(8, 32), meta(8, dtype=torch.bool),
                          meta(9, 32), meta(9, dtype=torch.bool))


def test_library_names_track_sources():
    names = {n: kernels.library_path(n).name for n in kernels.KERNELS}
    assert len(set(names.values())) == len(kernels.KERNELS)
    assert all(os.path.exists(kernels.CSRC / f"{n}.cu")
               for n in kernels.KERNELS)
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Run here (no CUDA): non-zero exit and no result line; and the script
    alone, outside the repository, fails too."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
