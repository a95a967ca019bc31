"""Device resolution and float32 precision policy for the port.

Every entry point runs on `cuda` unless the caller passes `device="cpu"`;
with no GPU present and no explicit device, it raises instead of silently
running on the host.

Precision: TF32 is switched off for matmuls and cuDNN. TF32 keeps about
three decimal digits, the same class of fault as the bf16 default dots that
put meter-scale noise on coordinate-scale products in the JAX package
(eyoc_tpu/geometry/metrics.py:19-27, tests/test_precision.py). Every f32
product on a coordinate path must stay full f32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` -> the first CUDA device, or a RuntimeError when there is none.

    An explicit device (e.g. "cpu" in the tests) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "eyoc_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
