"""Device resolution and float32 precision policy for the port.

Every entry point runs on `cuda` unless the caller passes `device="cpu"`
(under data parallelism, each rank on its own card, cuda:{LOCAL_RANK});
with no GPU present and no explicit device, it raises instead of silently
running on the host.

Precision: TF32 is switched off for matmuls and cuDNN. TF32 keeps about
three decimal digits, the same class of fault as the bf16 default dots that
put meter-scale noise on coordinate-scale products in the JAX package
(eyoc_tpu/geometry/metrics.py:19-27, tests/test_precision.py). Every f32
product on a coordinate path must stay full f32.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device, or a RuntimeError when there is none:
    under data parallelism (a torch.distributed group of torchrun's ranks)
    each rank's own, cuda:{LOCAL_RANK}; else the current one.

    An explicit device (e.g. "cpu" in the tests) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "eyoc_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        local = os.environ.get("LOCAL_RANK")
        if local is not None and dist.is_available() and \
                dist.is_initialized():
            return torch.device("cuda", int(local))
        return torch.device("cuda")
    return torch.device(device)
