"""One rank of the port's data-parallel tests, on the CPU over gloo.

Run by the tests through torchrun, which sets each rank's environment:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/ddp_worker.py <case> <input.pt> <output stem>

Each rank reads the case's inputs from <input.pt> (made by the test), runs
the port's code and writes its results to <output stem>.<rank>.pt. It
imports torch and the port only (no JAX), so the test module, which
imports both, is never imported here.

Cases:
- sync_bn: masked_batch_norm over the group (sync-BN) on the rank's rows,
  bare and with its ReLU tail; loss = sum(y * w), backward: y, dX,
  dscale, dbias, the new running statistics.
- train_step: one parallel.ddp.dp_train_step("base") of the global batch
  on the rank's pair, with given draws: the metrics and the state dict.
- eval: dp_embed_pair + dp_register_pair, dp_test_pair and dp_valid_pair
  on one pair a rank, with given noise: the gathered results.
- trainer: cli.train.main on the CPU (the trainer at dp_devices 2): the
  state dict and the epoch log.
- cli_test: cli.test.main at --dp_devices 2 on the CPU: its summary and
  the record of the rank's pair (batch, draws' state, pose).
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from eyoc_tpu_torch.parallel import ddp  # noqa: E402


def sync_bn(inp, r):
    from eyoc_tpu_torch.sparse.norm import masked_batch_norm
    out = {}
    for tail in ("bare", "relu"):
        x = inp["x"][r].clone().requires_grad_(True)
        scale = inp["scale"].clone().requires_grad_(True)
        bias = inp["bias"].clone().requires_grad_(True)
        rm, rv = inp["mean"].clone(), inp["var"].clone()
        y = masked_batch_norm(x, inp["mask"][r], scale, bias, rm, rv,
                              momentum=0.05, relu=tail == "relu",
                              group=dist.group.WORLD)
        (y * inp["w"][r]).sum().backward()
        out[tail] = dict(y=y.detach(), dx=x.grad, dscale=scale.grad,
                         dbias=bias.grad, mean=rm, var=rv)
    return out


def _model(inp):
    from eyoc_tpu_torch.models import ResUNet, UNetSpec
    model = ResUNet(UNetSpec(**inp["spec"]), 1, inp["n_out"], inp["k1"],
                    dtype=torch.float32)
    model.load_state_dict(inp["state"])
    return model


def train_step(inp, r):
    from eyoc_tpu_torch.training.optim import sgd
    from eyoc_tpu_torch.training.pipeline import RawBatch
    from eyoc_tpu_torch.training.steps import TrainConfig
    model = _model(inp)
    opt = sgd(model.parameters(), lr=inp["lr"], momentum=0.8,
              weight_decay=1e-4)
    m = ddp.dp_train_step("base", model, opt, RawBatch(*inp["batch"]),
                          TrainConfig(**inp["cfg"]), draws=inp["draws"],
                          device="cpu")
    return dict(metrics={k: v.clone() for k, v in m.items()},
                state=model.state_dict())


def evaluate(inp, r):
    from eyoc_tpu_torch.eval import embed_pair
    from eyoc_tpu_torch.training.pipeline import RawBatch
    model = _model(inp)
    cfg = inp["cfg"]
    batch = RawBatch(*inp["batch"])
    emb = ddp.dp_embed_pair(model, batch, cfg, device="cpu")
    local = embed_pair(model, ddp.shard_batch(batch), cfg, device="cpu")
    T = ddp.dp_register_pair(local, cfg, noise=inp["noise"])
    test = ddp.dp_test_pair(model, batch, cfg, noise=inp["noise"],
                            device="cpu")
    valid = ddp.dp_valid_pair(model, batch, cfg,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    return dict(embed=emb, T=T, test=test, valid=valid)


def trainer(inp, r):
    from eyoc_tpu_torch.cli.train import main
    from eyoc_tpu_torch.config import Config
    t = main(Config(inp["config"]), device="cpu")
    return dict(state=t.model.state_dict(), epoch_log=t.epoch_log,
                dp=t.dp)


def run_ranks(case: str, inputs: dict, tmp_path, ranks: int = 2,
              timeout: float = 300) -> list:
    """Run `case` on `ranks` ranks through torchrun (a free localhost port,
    gloo) with `inputs`; returns each rank's outputs, in rank order."""
    import subprocess
    src = os.path.join(str(tmp_path), f"{case}_in.pt")
    stem = os.path.join(str(tmp_path), f"{case}_out")
    torch.save(inputs, src)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(ranks), os.path.abspath(__file__), case,
         src, stem], env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    outs = [torch.load(f"{stem}.{r}.pt", weights_only=False)
            for r in range(ranks)]
    assert not any(o["jax_imported"] for o in outs)
    return outs


def cli_test(inp, r):
    from eyoc_tpu_torch.cli import test
    record = []
    res = test.main(inp["config"], num_pairs=inp["num_pairs"], dp=2,
                    device="cpu", record=record)
    return dict(res={k: res[k] for k in ("rr", "rte", "rre")},
                record=record)


CASES = {"sync_bn": sync_bn, "train_step": train_step, "eval": evaluate,
         "trainer": trainer, "cli_test": cli_test}


def main():
    case, src, stem = sys.argv[1:4]
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    ddp.maybe_distributed_init(device="cpu")
    r = dist.get_rank()
    out = CASES[case](torch.load(src, weights_only=False), r)
    out["jax_imported"] = "jax" in sys.modules
    torch.save(out, f"{stem}.{r}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
