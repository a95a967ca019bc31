"""A trainer at world size 2 over gloo on the CPU: cli.train.main under
torchrun (tests/ddp_worker.py, no JAX imported) with the EYOC trainer
(ContinuousCorrExtensionTrainer) at batch_size 2, --dp_devices 2, a base
epoch then an extension epoch (the labeler's forwards with each rank's own
BN statistics), one pair a rank through parallel.ddp.dp_train_step, and
validation one pair a rank (val_batch_size 2: ddp.dp_valid_pair).
Compared: both ranks resolve dp 2, their epoch logs (finite metrics,
averaged over the ranks) and every parameter and buffer bit-equal, the
parameters moved, and the checkpoints written (by rank 0)."""

import math
import os

import torch

from eyoc_tpu_torch.models import init_unet, load_model
from ddp_worker import run_ranks
from test_torch_train_cli import tiny
from test_torch_train_step import _one_torch_thread  # noqa: F401


def test_trainer_epochs_at_world_size_2(tmp_path):
    out_dir = str(tmp_path / "run")
    cfg = tiny(out_dir, batch_size=2, dp_devices=2, val_batch_size=2,
               test_valid=True, synthetic_pairs_per_epoch=2)
    outs = run_ranks("trainer", dict(config=dict(cfg)), tmp_path,
                     timeout=400)
    assert [o["dp"] for o in outs] == [2, 2]
    logs = [o["epoch_log"] for o in outs]
    assert [e["kind"] for e in logs[0]] == ["base", "extension"]
    for e0, e1 in zip(*logs):
        assert e0["metrics"] == e1["metrics"]
        assert all(math.isfinite(v) for v in e0["metrics"].values()), e0
    s0, s1 = (o["state"] for o in outs)
    for k, v in s0.items():
        assert torch.equal(v, s1[k]), k
    init = init_unet(load_model("SimpleNetBNE"), torch.Generator()
                     .manual_seed(0), 1, 8, 3, device="cpu").state_dict()
    assert not torch.equal(init["conv1.weight"], s0["conv1.weight"])
    for name in ("config.json", "checkpoint.pt", "best_val_checkpoint.pt"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    saved = torch.load(os.path.join(out_dir, "checkpoint.pt"),
                       weights_only=False)
    assert torch.equal(saved["model"]["conv1.weight"], s0["conv1.weight"])
