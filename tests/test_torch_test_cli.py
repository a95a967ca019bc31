"""eyoc_tpu_torch.cli.test, the runbook's second step, on the CPU:

- `parse_args` and `load_test_config` give the JAX CLI's config for the
  same argv, with RANSAC (the default) and with `--use_RANSAC false`
  (SC2PCR_KITTI merged), and with every other flag set (no compile);
- the runbook end to end at tiny caps: a reference-style checkpoint of
  SimpleNetBNE (the port's init from torch.Generator seed 3, exported by the
  port's `params_to_torch_state_dict`) through `import_torch_ckpt.main`
  with --write_test_config, then `cli.test.main(config, device="cpu")` over
  a KITTI-format tree (test_torch_kitti_data.py's, scans within 18 m) on
  KITTINMPairDataset (its ICP ground truth on the CPU) with SC2-PCR,
  `--num_pairs 2`: the four keys, each pose equal to `eval.test_pair` on
  the same batch and draws, RR the mean of `registration_success` on those
  poses; RANSAC (the default H = 1M hypotheses) is left to the card
  (chip_smoke.py phase 10);
- `--dp_devices 2` in one process clamps to the one rank there is (as the
  JAX CLI clamps it to its devices): the loader takes batches of 1;
- the Feat timer spans the batch's host-to-device copy (`RawBatch.to`),
  as the JAX CLI's does (its embed takes the host batch): one pair of the
  runbook's tree with a recording Timer and a recording `to`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from eyoc_tpu.cli import test as jtest
from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.cli import test as ttest
from eyoc_tpu_torch.config import Config, build_parser
from eyoc_tpu_torch.data import datasets as TD
from eyoc_tpu_torch.geometry.metrics import registration_success
from eyoc_tpu_torch.models import init_unet, load_model
from eyoc_tpu_torch.tools import import_torch_ckpt
from eyoc_tpu_torch.training.pipeline import RawBatch
from eyoc_tpu_torch.training.trainer import build_step_config
from test_torch_kitti_data import kitti_tree

# the tiny capacities of the runbook run (its checkpoint's embedded config
# carries them, as tests/test_runbook.py's does)
TINY = dict(raw_point_capacity=4096, voxel_capacity=1024,
            eval_sample_points=128, knn_tile=128, num_corres=128,
            corr_capacity=256, voxel_size=0.3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def save_dir(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    cfg = Config(vars(build_parser().parse_args([])))
    cfg.update(TINY, model="SimpleNetBNE", model_n_out=16,
               conv1_kernel_size=3)
    cfg.save(str(d / "config.json"))
    return str(d)


@pytest.mark.parametrize("argv", [
    [],
    ["--use_RANSAC", "false"],
    ["--use_RANSAC", "false", "--dataset", "KITTINMPairDataset",
     "--test_phase", "val", "--LoKITTI", "true", "--pair_min_dist", "5",
     "--pair_max_dist", "10", "--downsample_single", "0.5",
     "--kitti_root", "/elsewhere", "--rre_thresh", "3", "--rte_thresh",
     "1", "--num_pairs", "7", "--trace_dir", "/tmp/t", "--nn_dist_stats",
     "true", "--window_bits", "8,8,6", "--dp_devices", "1"],
])
def test_config_matches_jax(tmp_path, argv):
    argv = ["--save_dir", save_dir(tmp_path)] + argv
    ja, ta = jtest.parse_args(argv), ttest.parse_args(argv)
    assert vars(ja) == vars(ta)
    want = dict(jtest.load_test_config(ja))
    got = dict(ttest.load_test_config(ta))
    assert got == want and list(got) == list(want)


class _Loader(RuntimeError):
    pass


def test_dp_devices_raise(tmp_path, monkeypatch):
    """`--dp_devices 2` with one rank no longer raises: it clamps to 1 (the
    loader's batch size), as eyoc_tpu/cli/test.py:140 clamps it."""
    sizes = []

    def loader(config, phase, batch_size, **kw):
        sizes.append(batch_size)
        raise _Loader
    monkeypatch.setattr(ttest, "make_data_loader", loader)
    args = ttest.parse_args(["--save_dir", save_dir(tmp_path),
                             "--dp_devices", "2"])
    assert args.dp_devices == 2
    with pytest.raises(_Loader):
        ttest.main(ttest.load_test_config(args), dp=args.dp_devices,
                   device="cpu")
    assert sizes == [1]


def reference_checkpoint(path):
    """A reference-style .pth of SimpleNetBNE/16 (conv1 k = 3): the port's
    init (torch.Generator seed 3) through the port's exporter, the tiny
    capacities in its embedded config."""
    model = init_unet(load_model("SimpleNetBNE"),
                      torch.Generator().manual_seed(3), 1, 16, 3,
                      dtype=torch.float32, device="cpu")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          import_torch_ckpt.params_to_torch_state_dict(
              model.state_dict()).items()}
    torch.save({"epoch": 11, "state_dict": sd, "optimizer": {},
                "scheduler": {}, "config": {"model": "SimpleNetBNE",
                                            "model_n_out": 16,
                                            "conv1_kernel_size": 3, **TINY},
                "best_val": 0.5, "best_val_epoch": 3,
                "best_val_metric": "feat_match_ratio"}, path)
    return model


def test_runbook_on_kitti_tree(tmp_path, monkeypatch):
    root = kitti_tree(tmp_path / "kitti", radius=18.0)
    split = tmp_path / "split_00.txt"
    split.write_text("00\n")
    monkeypatch.setattr(TD, "_split_file", lambda name: str(split))
    pth = str(tmp_path / "best_val_checkpoint.pth")
    exported = reference_checkpoint(pth)
    out = str(tmp_path / "imported")
    import_torch_ckpt.main(["--input", pth, "--output_dir", out, "--name",
                            "best_val_checkpoint", "--write_test_config"])
    args = ttest.parse_args([
        "--save_dir", out, "--kitti_root", root,
        "--dataset", "KITTINMPairDataset", "--pair_min_dist", "3",
        "--use_RANSAC", "false", "--window_bits", "7,7,6",
        "--num_pairs", "2"])
    config = ttest.load_test_config(args)
    record = []
    res = ttest.main(config, num_pairs=args.num_pairs, device="cpu",
                     record=record)
    assert set(res) >= {"rr", "rte", "rre", "pairs_per_sec"}
    assert 0.0 <= res["rr"] <= 1.0 and np.isfinite(res["pairs_per_sec"])
    assert len(record) == 2
    # the ICP ground truth ran, one cached pose a pair
    assert len(os.listdir(os.path.join(root, "icp"))) >= 2

    # each pose is eval.test_pair's on the same batch and draws, with the
    # imported weights
    spec = load_model("SimpleNetBNE")
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 16, 3,
                      device="cpu")
    model.load_state_dict(exported.state_dict())
    _, cfg = build_step_config(config, spec)
    cfg = dataclasses.replace(cfg, use_ransac=False)
    ok = []
    for batch, state, T_est in record:
        gen = torch.Generator()
        gen.set_state(state)
        want = teval.test_pair(model, batch, cfg, generator=gen,
                               device="cpu")
        assert torch.equal(want["T_est"], T_est)
        ok.append(bool(registration_success(T_est, batch.T_gt[0])[0]))
    assert res["rr"] == np.mean(ok)


def test_feat_timer_spans_the_copy(tmp_path, monkeypatch):
    root = kitti_tree(tmp_path / "kitti", radius=18.0)
    split = tmp_path / "split_00.txt"
    split.write_text("00\n")
    monkeypatch.setattr(TD, "_split_file", lambda name: str(split))
    pth = str(tmp_path / "best_val_checkpoint.pth")
    reference_checkpoint(pth)
    out = str(tmp_path / "imported")
    import_torch_ckpt.main(["--input", pth, "--output_dir", out, "--name",
                            "best_val_checkpoint", "--write_test_config"])
    events = []
    timers = []

    class RecordingTimer(ttest.Timer):
        def __init__(self):
            super().__init__()
            timers.append(self)

        def tic(self):
            events.append(("tic", timers.index(self)))
            super().tic()

        def toc(self, average=True):
            events.append(("toc", timers.index(self)))
            return super().toc(average)

    real_to = RawBatch.to

    def recording_to(self, device):
        events.append(("copy", None))
        return real_to(self, device)

    monkeypatch.setattr(ttest, "Timer", RecordingTimer)
    monkeypatch.setattr(RawBatch, "to", recording_to)
    args = ttest.parse_args([
        "--save_dir", out, "--kitti_root", root,
        "--dataset", "KITTINMPairDataset", "--pair_min_dist", "3",
        "--use_RANSAC", "false", "--window_bits", "7,7,6",
        "--num_pairs", "1"])
    ttest.main(ttest.load_test_config(args), num_pairs=args.num_pairs,
               device="cpu")
    feat = 1                       # data, feat, reg: made in that order
    copy = events.index(("copy", None))
    assert events[copy - 1] == ("tic", feat)
    assert ("toc", feat) in events[copy + 1:]
    assert events.index(("toc", feat)) > copy
