"""The port's train CLI on the CPU at a tiny size:
`cli.train.main(config, device="cpu")` over the synthetic datasets.

- every trainer of the registry constructs and trains 2 epochs (finite
  losses, both checkpoints written; the frozen-labeler trainer loads its
  labeler from another run's directory);
- the EYOC trainer runs a base epoch (identity labels) and then an
  extension epoch, and a `--resume_dir` round trip (the CLI's
  get_config) restores the student, the labeler, the optimizer state,
  num_updates, the generator and the best-val record exactly, starting at
  the next epoch;
- `--finetune_restart` and `--weights` load the weights only;
- the loader's producer thread ends with its consumer (an iteration left
  early, as the validation's), and a dataset error reaches the consumer.
"""

import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from eyoc_tpu_torch.cli.train import main
from eyoc_tpu_torch.config import Config, build_parser, get_config
from eyoc_tpu_torch.data.loader import DataLoader
from eyoc_tpu_torch.training.trainer import TRAINERS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only wait on each other, and
    stall when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny(out_dir, **kw):
    cfg = Config(vars(build_parser().parse_args([])))
    cfg.update(dict(
        model="SimpleNetBNE", conv1_kernel_size=3, model_n_out=8,
        voxel_size=0.3, dataset="SyntheticContinuousPairDataset",
        trainer="ContinuousCorrExtensionTrainer",
        # epoch 1 at MAX_DIST 1 (base), epoch 2 extended to 3 m
        pair_min_dist=1, pair_max_dist=2, max_epoch=2, extension_steps=1,
        synthetic_points=2048, synthetic_pairs_per_epoch=2,
        raw_point_capacity=2048, voxel_capacity=256, window_bits="8,8,7",
        batch_size=2, num_pos_per_batch=64, num_hn_samples_per_batch=32,
        triplet_num_pos=32, triplet_num_rand=64, num_corres=128,
        eval_sample_points=128, max_points=128, val_max_iter=1,
        stat_freq=1, sync_strategy="EMA", ema_decay=0.2, out_dir=out_dir))
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def labeler_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("labeler"))
    main(tiny(out, trainer="HardestContrastiveLossTrainer", max_epoch=1),
         device="cpu")
    return out


def check_run(t, epochs):
    assert [e["epoch"] for e in t.epoch_log] == list(range(1, epochs + 1))
    for e in t.epoch_log:
        assert all(math.isfinite(v) for v in e["metrics"].values()), e
    for name in ("checkpoint", "best_val_checkpoint"):
        for ext in (".pt", ".json"):
            assert os.path.exists(os.path.join(t.checkpoint_dir, name + ext))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_every_trainer_trains(name, tmp_path, labeler_run):
    kw = {}
    if name == "CorrespondenceExtensionTrainer":
        kw = dict(labeler_dir=labeler_run)
    t = main(tiny(str(tmp_path), trainer=name, **kw), device="cpu")
    check_run(t, 2)
    assert t.step_cfg.loss_kind == t.LOSS_KIND
    if name == "CorrespondenceExtensionTrainer":
        want = torch.load(os.path.join(labeler_run, "checkpoint.pt"),
                          weights_only=True)["model"]
        for k, v in t.labeler.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_eyoc_resume_round_trip(tmp_path):
    out = str(tmp_path)
    t = main(tiny(out), device="cpu")
    check_run(t, 2)
    assert [e["kind"] for e in t.epoch_log] == ["base", "extension"]
    assert t.num_updates == 1 and t.labeler_initialized

    r = main(get_config(["--resume_dir", out]), device="cpu")
    assert r.config.resume == os.path.join(out, "checkpoint")
    assert r.start_epoch == 3 and r.epoch_log == []
    assert r.num_updates == t.num_updates
    assert (r.best_val, r.best_val_epoch) == (t.best_val, t.best_val_epoch)
    assert torch.equal(r.generator.get_state(), t.generator.get_state())
    for a, b in ((r.model, t.model), (r.labeler, t.labeler)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sb:
            assert torch.equal(sa[k], sb[k]), k
    oa, ob = r.opt.state_dict(), t.opt.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert len(oa["state"]) == len(ob["state"]) > 0
    for i, st in ob["state"].items():
        for k, v in st.items():
            assert torch.equal(oa["state"][i][k], v), (i, k)


@pytest.mark.parametrize("how", ["finetune_restart", "weights"])
def test_weights_only(how, tmp_path, labeler_run):
    base = os.path.join(labeler_run, "checkpoint")
    kw = (dict(resume=base, finetune_restart=True) if how == "finetune_restart"
          else dict(weights=base))
    t = main(tiny(str(tmp_path), trainer="HardestContrastiveLossTrainer",
                  max_epoch=0, **kw), device="cpu")
    assert t.start_epoch == 1 and t.num_updates == 0
    assert t.opt.state_dict()["state"] == {}
    want = torch.load(base + ".pt", weights_only=True)["model"]
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not np.isfinite(t.best_val)


class _Items:
    """`n` tiny items, item i's first coordinate i; reading item `bad`
    raises."""

    def __init__(self, n, bad=-1):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise KeyError(f"item {i}")
        time.sleep(0.002)
        xyz = np.zeros((4, 3), np.float32)
        xyz[0, 0] = i
        return {"xyz0": xyz, "xyz1": xyz, "T_gt": np.eye(4),
                "frame_distance": 1, "search_radius": 0.45}


def test_loader_producer_ends_with_its_consumer():
    before = set(threading.enumerate())

    def new_threads():
        return set(threading.enumerate()) - before

    loader = DataLoader(_Items(40), 1, 4, shuffle=False)
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()                       # left early: the producer joined
        assert not new_threads()
    assert [int(b.xyz0[0, 0, 0]) for b in loader] == list(range(40))
    assert not new_threads()
    with pytest.raises(KeyError, match="item 5"):
        for _ in DataLoader(_Items(40, bad=5), 2, 4, shuffle=False):
            pass
    assert not new_threads()
