"""SGD with momentum and weight decay, and the exponential LR schedule
(counterpart of eyoc_tpu/training/optim.py:sgd_update, exp_lr, :1-37).

The JAX update is torch.optim.SGD's own rule with dampening 0:
    grad <- grad + weight_decay * param
    buf  <- momentum * buf + grad
    param <- param - lr * buf
applied to every parameter, BN affines and the final bias included, so the
port uses torch.optim.SGD itself (tests/test_torch_train_step.py holds it
against `sgd_update`). Adam and AdamW wait for a later slice (ROADMAP).

`ema_update` and `sync_labeler` keep the EYOC labeler (a second ResUNet)
in step with the student, as ContinuousCorrExtensionTrainer does before
each epoch (eyoc_tpu/training/optim.py:108-115, trainer.py:352-377).
"""

from __future__ import annotations

import torch


def sgd(params, lr: float, momentum: float = 0.8,
        weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay)


def exp_lr(base_lr: float, gamma: float, epoch: int) -> float:
    """epoch is 1-based; torch ExponentialLR stepped once per epoch."""
    return base_lr * (gamma ** (epoch - 1))


def ema_update(labeler: torch.Tensor, model: torch.Tensor, decay: float,
               num_updates: int) -> torch.Tensor:
    """Debiased EMA (reference lib/trainer.py:1509-1514):
    (decay * labeler + (1 - decay) * model) / (1 - decay^num_updates)."""
    debias = 1.0 - decay ** num_updates
    return (decay * labeler + (1.0 - decay) * model) / debias


@torch.no_grad()
def sync_labeler(labeler: torch.nn.Module, model: torch.nn.Module,
                 num_updates: int, strategy: str = "EMA",
                 decay: float = 0.2) -> int:
    """One labeler sync; returns the new EMA update count.

    num_updates 0 (a labeler not yet initialized): copy the student's
    parameters and BN buffers, count 1. "Sync": copy both. "EMA": the
    parameters by `ema_update` at the current count, the buffers copied,
    count + 1."""
    pairs = list(zip(labeler.parameters(), model.parameters()))
    buffers = list(zip(labeler.buffers(), model.buffers()))
    if num_updates == 0 or strategy == "Sync":
        for dst, src in pairs + buffers:
            dst.copy_(src)
        return max(num_updates, 1)
    if strategy != "EMA":
        raise NotImplementedError(strategy)
    for dst, src in pairs:
        dst.copy_(ema_update(dst, src, decay, num_updates))
    for dst, src in buffers:
        dst.copy_(src)
    return num_updates + 1
