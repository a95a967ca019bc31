"""Inclusive prefix ops (counterpart of eyoc_tpu/sparse/scan.py).

The JAX package blocks these scans to suit the TPU's tiling; on the GPU a
1-D torch scan is already one pass, so they are thin wrappers."""

from __future__ import annotations

import torch


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor, in its own dtype."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum of a 1-D tensor."""
    return torch.cummax(x, 0).values
