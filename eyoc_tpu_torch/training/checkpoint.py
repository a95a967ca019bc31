"""Checkpoint save / resume (counterpart of
eyoc_tpu/training/checkpoint.py:27-105), in the port's own format.

The reference's checkpoint contract (lib/trainer.py:108-125, 166-179):
`{epoch, weights and BN statistics, optimizer, config, best_val,
best_val_epoch, best_val_metric}` saved as `checkpoint` and
`best_val_checkpoint`; `--resume` restores everything,
`--finetune_restart` and `--weights` the weights only, and a labeler loads
from another run (`--labeler_dir` / `--labeler_weight`).

`<name>.pt` is a `torch.save` of the student's and the labeler's
`state_dict`s (parameters and BN buffers), the optimizer's `state_dict`,
`num_updates` (the EMA count) and the state of the torch.Generator that
draws the steps' random numbers (JAX keeps a PRNG key in its state).
`<name>.json` holds the JAX package's metadata keys (`epoch`, `best_val`,
`best_val_epoch`, `best_val_metric`, `config`). The JAX package's
`.msgpack` files are not read here (they need flax); JAX weights cross
over through `models.convert.params_from_jax`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Tuple

import torch


def save_checkpoint(out_dir: str, name: str, *, epoch: int, model, labeler,
                    opt: torch.optim.Optimizer, num_updates: int,
                    generator: torch.Generator, config: Dict[str, Any],
                    best_val: float, best_val_epoch: int,
                    best_val_metric: str) -> str:
    """Writes `<out_dir>/<name>.pt` and `<name>.json`; returns the .pt
    path."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {
        "model": model.state_dict(),
        "labeler": labeler.state_dict(),
        "opt": opt.state_dict(),
        "num_updates": int(num_updates),
        "generator": generator.get_state(),
    }
    path = os.path.join(out_dir, f"{name}.pt")
    torch.save(payload, path)
    meta = {
        "epoch": int(epoch),
        "best_val": float(best_val),
        "best_val_epoch": (int(best_val_epoch)
                           if math.isfinite(best_val_epoch) else -1),
        "best_val_metric": best_val_metric,
        "config": dict(config),
    }
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _payload(path_base: str) -> dict:
    return torch.load(path_base + ".pt", map_location="cpu",
                      weights_only=True)


def load_checkpoint(path_base: str, model, labeler,
                    opt: torch.optim.Optimizer,
                    generator: torch.Generator) -> Tuple[int, Dict[str, Any]]:
    """path_base: the path without extension (e.g. <dir>/checkpoint).
    Restores the student, the labeler, the optimizer and the generator in
    place; returns (num_updates, meta)."""
    payload = _payload(path_base)
    model.load_state_dict(payload["model"])
    labeler.load_state_dict(payload["labeler"])
    opt.load_state_dict(payload["opt"])
    generator.set_state(payload["generator"])
    meta = {}
    if os.path.exists(path_base + ".json"):
        with open(path_base + ".json") as f:
            meta = json.load(f)
    return int(payload["num_updates"]), meta


def load_weights_only(path_base: str, model) -> None:
    """`--weights`, `--finetune_restart` and labeler loading: the student's
    parameters and BN statistics of a checkpoint into `model`."""
    model.load_state_dict(_payload(path_base)["model"])
