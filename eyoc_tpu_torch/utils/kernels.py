"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under `eyoc_tpu_torch/csrc/` with a
plain C interface. It is compiled with `nvcc` for `sm_90a` into its own
shared library under `build/kernels/` at first use (or all at once, in
parallel, by `build_all`) and called through ctypes. The library name
carries a hash of the source and flags, so an edited source is rebuilt and
a stale library is never loaded.

Nothing is compiled or loaded at import time: the CPU tests import every
module on a host without `nvcc`.

`launches` holds one plain integer per counted launch site; a wrapper adds
one exactly where it launches its kernel, so a run can show which kernels
its main path went through. A source may hold more than one entry point
(K6's forward and backward, K4's counts and top k, K8 and K9, K14 and K15
in `sc2_refine`, K16-K18 in `ransac`, K20 and K22 in `instance_norm`; K19
and K21 are entry points named apart from their sources), and one kernel
may be counted under two names (K1 as the forward conv and as the conv
backward's dX; K16's single-stage and two-stage entries; K21 as the
instance norm's backward and as the batch norm's), so the
counters are `COUNTERS`: the sources in `KERNELS` with an entry point of
their own name, and the other entry points. A wrapper call that makes
several launches (K4's top k, K10, K11, K12, K14, K16, K17, K20, K21)
counts one.

The launch path is part of a small kernel's time: a call that moves a few
hundred KB runs for a microsecond or two on the card, and the host's work
around it sets its pace. So the checks every wrapper makes (`require_cuda`)
read a few attributes per tensor and build their messages only on failure,
and `stream_handle` reads the raw stream without building a Stream object.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("sparse_conv", "masked_argmin", "sc2_power_iteration",
           "sc2_seed_counts", "sparse_conv_wgrad", "take_rows",
           "masked_channel_sums", "masked_knn2", "voxelize", "brick_pyramid",
           "conv_maps", "sc2_nms", "sc2_refine", "ransac", "robust_irls",
           "instance_norm", "norm_backward")
COUNTERS = tuple(k for k in KERNELS if k not in (
    "sc2_refine", "ransac", "robust_irls", "instance_norm",
    "norm_backward")) + (
    "sparse_conv_dgrad", "take_rows_backward", "sc2_seed_topk",
    "masked_argmin_excl", "sc2_seed_transforms", "sc2_irls",
    "ransac_hypotheses", "ransac_hypotheses_topk", "ransac_verify",
    "ransac_polish", "icp_solve", "est_quad_linear_robust",
    "masked_instance_norm", "masked_norm_apply", "masked_norm_backward",
    "masked_norm_backward_bn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launches = {name: 0 for name in COUNTERS}
_fns: dict = {}


def reset_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = name.replace("/", "_")
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile one kernel source (no-op when its library exists)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Compile every kernel, one nvcc per source, all started together.
    Returns the wall time in seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for fut in [pool.submit(build, name) for name in KERNELS]:
            fut.result()
    return time.perf_counter() - t0


def load(name: str, argtypes, symbol: str | None = None) -> ctypes._CFuncPtr:
    """The C entry point `eyoc_<symbol>` (default: `eyoc_<name>`) of the
    kernel source `name` (built on demand).

    Raises when the kernel cannot be built or loaded: a wrapper never falls
    back to its plain version for a CUDA tensor."""
    symbol = symbol or name
    fn = _fns.get(symbol)
    if fn is None:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, f"eyoc_{symbol}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


# The current stream's raw handle for a device index. The public
# `torch.cuda.current_stream(i).cuda_stream` builds a Stream object on every
# call, a few microseconds of the launch path of a small kernel; this
# private binding returns the same integer directly (Triton's launcher
# reads it the same way). Builds without it take the public call.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device_index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def check_error(name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def check_launch(name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t from a launch; count it otherwise (a
    wrapper whose call makes several launches checks the earlier ones with
    `check_error` and counts the call once, here)."""
    check_error(name, err)
    launches[name] += 1


def require_cuda(name: str, *tensors, dtypes=None) -> int:
    """Validate the tensors a kernel reads or writes: CUDA, one device and
    contiguous; `dtypes` optionally pins each tensor's dtype (None = any).
    Returns the device index (for `stream_handle`).

    The common case (every check passes) costs a few attribute reads per
    tensor; the message of a failed check is worked out only then."""
    dev = -1
    for t, want in zip(tensors, dtypes or _ANY):
        if t is None:
            continue
        if dev < 0:
            dev = t.get_device()
        if not (t.is_cuda and t.is_contiguous() and t.get_device() == dev
                and (want is None or t.dtype is want)):
            _refuse(name, tensors, dtypes)
    return dev


_ANY = itertools.repeat(None)      # dtypes=None: any dtype, for every tensor


def _refuse(name: str, tensors, dtypes) -> None:
    dev = None
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             "expected a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and dtypes[i] is not None \
                and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: argument {i} has dtype {t.dtype}, "
                             f"expected {dtypes[i]}")


_tickets: dict = {}


def ticket(device_index: int, count: int = 1) -> torch.Tensor:
    """`count` zeroed int32 counters on the device, for a kernel whose last
    block to finish a tile does that tile's final reduction (K2, K7). The
    kernel resets each counter before it ends, so calls on one stream can
    share them; allocated once per device, and again only to grow."""
    t = _tickets.get(device_index)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 256), dtype=torch.int32,
                        device=f"cuda:{device_index}")
        _tickets[device_index] = t
    return t


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
