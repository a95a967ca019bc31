"""SGD with momentum and weight decay, and the exponential LR schedule
(counterpart of eyoc_tpu/training/optim.py:sgd_update, exp_lr, :1-37).

The JAX update is torch.optim.SGD's own rule with dampening 0:
    grad <- grad + weight_decay * param
    buf  <- momentum * buf + grad
    param <- param - lr * buf
applied to every parameter, BN affines and the final bias included, so the
port uses torch.optim.SGD itself (tests/test_torch_train_step.py holds it
against `sgd_update`). Adam and AdamW wait for a later slice (ROADMAP).
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
