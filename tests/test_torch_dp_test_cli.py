"""cli.test under torchrun at --dp_devices 2 over gloo on the CPU
(tests/ddp_worker.py, no JAX in the ranks): each batch holds 2 pairs of
the synthetic test split, each rank registers its own with SC2-PCR (its
draws from a generator seeded with its rank), the poses are gathered and
both ranks report the summary of both pairs. Compared: the two ranks'
rr / rte / rre equal; each rank's recorded pair is pair `rank` of the
loader's batch, and eval.test_pair on it from the recorded draws' state
gives the rank's pose bit for bit; rr is the mean of
`registration_success` over the two poses."""

import os

import numpy as np
import torch

from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.cli import test as ttest
from eyoc_tpu_torch.config import Config, build_parser
from eyoc_tpu_torch.data.loader import make_data_loader
from eyoc_tpu_torch.geometry.metrics import registration_success
from eyoc_tpu_torch.models import init_unet, load_model
from eyoc_tpu_torch.training.trainer import build_step_config
from ddp_worker import run_ranks
from test_torch_train_step import _one_torch_thread  # noqa: F401

TINY = dict(raw_point_capacity=2048, voxel_capacity=512,
            eval_sample_points=128, knn_tile=128, num_corres=128,
            corr_capacity=256, voxel_size=0.3, model="SimpleNetBNE",
            model_n_out=16, conv1_kernel_size=3,
            dataset="SyntheticPairDataset", synthetic_points=2048,
            synthetic_pairs_per_epoch=4, window_bits="8,8,7")


def test_cli_test_splits_pairs_over_ranks(tmp_path):
    d = str(tmp_path / "run")
    os.makedirs(d)
    cfg = Config(vars(build_parser().parse_args([])))
    cfg.update(TINY)
    cfg.save(os.path.join(d, "config.json"))
    config = ttest.load_test_config(ttest.parse_args([
        "--save_dir", d, "--use_RANSAC", "false", "--window_bits", "8,8,7",
        "--dataset", "SyntheticPairDataset"]))
    outs = run_ranks("cli_test", dict(config=config, num_pairs=1), tmp_path)
    assert outs[0]["res"] == outs[1]["res"]

    batch = next(iter(make_data_loader(config, config.test_phase, 2,
                                       shuffle=False, device="cpu")))
    spec = load_model("SimpleNetBNE")
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 16, 3,
                      device="cpu")
    _, ecfg = build_step_config(config, spec)
    ok = []
    for r, out in enumerate(outs):
        (pair, state, T), = out["record"]
        for a, b in zip(pair, batch):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)[r:r + 1])
        gen = torch.Generator()
        gen.set_state(state)
        want = teval.test_pair(model, pair, ecfg, generator=gen,
                               device="cpu")
        assert torch.equal(want["T_est"], T)
        ok.append(bool(registration_success(T, pair.T_gt[0])[0]))
    assert outs[0]["res"]["rr"] == np.mean(ok)
