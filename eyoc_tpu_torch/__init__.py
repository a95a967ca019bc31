"""eyoc_tpu_torch — the PyTorch/CUDA port of `eyoc_tpu` for NVIDIA Hopper.

The package mirrors `eyoc_tpu`'s module names. It imports torch, numpy and
scipy only: never `jax`, and nothing of `eyoc_tpu`. Entry points run on a
CUDA device unless the caller passes `device="cpu"`; on the CPU every
hand-written kernel is replaced by its plain PyTorch version.
"""

from eyoc_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
