"""The optimizers and the exponential LR schedule (counterpart of
eyoc_tpu/training/optim.py: sgd_update, adam_update, adamw_update, exp_lr,
ema_update, :1-115).

Each JAX update is the rule of the torch optimizer the reference builds by
name (getattr(torch.optim, cfg.optimizer), lib/trainer.py:80-84), so the
port uses those optimizers themselves, on every parameter (BN affines and
the final bias included):
- SGD (dampening 0): grad <- grad + wd * p; buf <- momentum * buf + grad;
  p <- p - lr * buf;
- Adam: the weight decay added into the gradient (L2), bias-corrected
  moments, p <- p - lr * (m / c1) / (sqrt(v / c2) + eps);
- AdamW: decoupled decay, p <- p * (1 - lr * wd) before the Adam step.
tests/test_torch_train_step.py and tests/test_torch_metric_losses.py hold
them against sgd_update, adam_update and adamw_update.

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


def adam(params, lr: float, betas=(0.9, 0.999),
         weight_decay: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8,
                            weight_decay=weight_decay)


def adamw(params, lr: float, betas=(0.9, 0.999),
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=1e-8,
                             weight_decay=weight_decay)


OPTIMIZERS = ("SGD", "Adam", "AdamW")


def make_optimizer(params, name: str, lr: float, momentum: float = 0.8,
                   weight_decay: float = 1e-4,
                   betas=(0.9, 0.999)) -> torch.optim.Optimizer:
    """The trainers' optimizer by its `--optimizer` name."""
    if name == "SGD":
        return sgd(params, lr, momentum, weight_decay)
    if name == "Adam":
        return adam(params, lr, betas, weight_decay)
    if name == "AdamW":
        return adamw(params, lr, betas, weight_decay)
    raise ValueError(f"unknown optimizer {name!r}; available: "
                     + ", ".join(OPTIMIZERS))


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The epoch's learning rate on every parameter group (JAX passes it
    to each step)."""
    for group in opt.param_groups:
        group["lr"] = lr


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
