"""Train entry point: `python -m eyoc_tpu_torch.cli.train --flags`, the
JAX CLI's flags (eyoc_tpu/cli/train.py; reference train.py:54-98). On the
command line it trains on the CUDA device; `main(config, device="cpu")`
runs the plain versions on the host."""

from __future__ import annotations

import logging
import sys

import numpy as np

from eyoc_tpu_torch.config import get_config
from eyoc_tpu_torch.data.loader import make_data_loader
from eyoc_tpu_torch.training.trainer import get_trainer

def log_to_stdout() -> None:
    """The JAX CLI's log format, INFO and above on stdout."""
    logging.getLogger().setLevel(logging.INFO)
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d %H:%M:%S",
                        handlers=[logging.StreamHandler(sys.stdout)])


def main(config, device=None):
    """Builds the loaders and the config's trainer, trains it, and returns
    the trainer."""
    np.random.seed(config.get("seed", 0))
    train_loader = make_data_loader(config, config.train_phase,
                                    config.batch_size)
    val_loader = None
    if config.test_valid:
        val_loader = make_data_loader(config, config.val_phase,
                                      config.val_batch_size)
    Trainer = get_trainer(config.trainer)
    trainer = Trainer(config, train_loader, val_loader, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    log_to_stdout()
    main(get_config())
