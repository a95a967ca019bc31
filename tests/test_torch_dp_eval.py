"""DP eval equals serial (as tests/test_parallel.py::TestEvalDP holds the
JAX package's): parallel/ddp's dp_embed_pair, dp_register_pair,
dp_test_pair and dp_valid_pair at world size 2 over gloo on the CPU, one
pair a rank, against eval.embed_pair / register_pair / test_pair /
valid_pair on each pair in turn in this process, given the same noise
(the valid step's drawn by each rank in pair order from one generator, as
the serial loop draws them): every gathered output bit-equal. The
workers run tests/ddp_worker.py through torchrun and import no JAX."""

import dataclasses

import numpy as np
import torch

from eyoc_tpu_torch import eval as teval
from eyoc_tpu_torch.eval import (EvalConfig, embed_pair, register_pair,
                                 subset_noise, valid_pair)
from eyoc_tpu_torch.models import init_unet, load_model
from eyoc_tpu_torch.registration.sc2pcr import SC2PCRConfig
from eyoc_tpu_torch.training.pipeline import RawBatch
from ddp_worker import run_ranks
from test_torch_train_step import _one_torch_thread  # noqa: F401

BITS = (8, 8, 7)
D = 2


def test_dp_eval_equals_serial(tmp_path):
    spec = load_model("SimpleNetBNE")
    model = init_unet(spec, torch.Generator().manual_seed(0), 1, 8, 3,
                      dtype=torch.float32, device="cpu")
    cfg = EvalConfig(caps=(256, 128, 128), voxel_size=0.3, window_bits=BITS,
                     eval_sample_points=200,
                     sc2=SC2PCRConfig(max_points=200, seed_cap=40))
    rng = np.random.default_rng(3)
    P = 300
    xyz0 = rng.uniform(-6, 6, (D, P, 3)).astype(np.float32)
    shift = np.asarray([1.0, 0.5, 0.0], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    T[:, :3, 3] = shift
    batch = RawBatch(*map(torch.from_numpy, (
        xyz0, np.full(D, P, np.int32), xyz0 + shift, np.full(D, P, np.int32),
        T, np.ones(D, np.int32), np.full(D, 0.45, np.float32))))
    pairs = [RawBatch(*(x[d:d + 1] for x in batch)) for d in range(D)]
    serial = [embed_pair(model, p, cfg, device="cpu") for p in pairs]
    gen = torch.Generator().manual_seed(7)
    noise = [(subset_noise(e[2], gen), subset_noise(e[5], gen))
             for e in serial]
    stacked = tuple(torch.stack([n[k] for n in noise]) for k in range(2))
    outs = run_ranks("eval", dict(
        spec=dataclasses.asdict(spec), n_out=8, k1=3,
        state=model.state_dict(), cfg=cfg,
        batch=tuple(batch), noise=stacked), tmp_path)

    vgen = torch.Generator().manual_seed(0)
    for d in range(D):
        T1 = register_pair(*serial[d], cfg, noise=noise[d])
        t1 = teval.test_pair(model, pairs[d], cfg, noise=noise[d], device="cpu")
        v1 = valid_pair(model, pairs[d], cfg, generator=vgen, device="cpu")
        for out in outs:
            for a, b in zip(serial[d], out["embed"]):
                assert torch.equal(a, b[d])
            assert torch.equal(T1, out["T"][d])
            for k, v in t1.items():
                assert torch.equal(v, out["test"][k][d]), k
            for k, v in v1.items():
                assert torch.equal(torch.as_tensor(v), out["valid"][k][d]), k
    assert bool(torch.isfinite(outs[0]["T"]).all())
