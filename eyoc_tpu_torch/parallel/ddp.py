"""Data parallelism over torch.distributed (counterpart of
eyoc_tpu/parallel/mesh.py).

JAX shards the pair batch over a 1-D `dp` mesh inside one program
(`shard_map`); PyTorch's idiom is one process a device: torchrun starts D
ranks, each on `cuda:{LOCAL_RANK}` (utils/device.resolve_device), and every
rank runs the same step on its B / D pairs.

- `maybe_distributed_init`: `init_process_group` from torchrun's
  environment, behind --multihost or when WORLD_SIZE is set (NCCL on the
  card, gloo on the CPU); mesh.py:30-37.
- `dp_device_count`: --dp_devices resolved against the ranks there are
  (-1: the largest count that divides the batch); mesh.py:40-56.
- `shard_batch`: a rank's B / D slice of the global batch; with iter_size
  the micro-batch axis stays whole (mesh.py:66-77).
- `dp_train_step`: the train step on the rank's slice (mesh.py:78-106):
  every BatchNorm of the student synchronized over the ranks
  (sparse/norm.py's sync-BN; the labeler's only with
  `cfg.labeler_sync_bn`), the gradients averaged once after the backward
  in one flattened all_reduce / D (steps.py:310-311's pmean), the metrics
  averaged (:349-351). The draws are the same on every rank, as JAX's key
  is replicated over `dp`: the trainer seeds each rank's generator alike.
- `dp_embed_pair`, `dp_register_pair`, `dp_test_pair`, `dp_valid_pair`:
  one pair a rank, the results gathered over the ranks ([D, ...] on every
  rank; mesh.py:109-182).

No DistributedDataParallel wrapper: its buffer broadcast would overwrite
the BN running statistics with rank 0's every step, and the step averages
the gradients itself.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# the variables torchrun sets for each rank
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_distributed_init(config=None, device=None) -> bool:
    """Join torchrun's process group behind --multihost, or when WORLD_SIZE
    is set (as torchrun sets it); True when a group is up. NCCL with each
    rank on cuda:{LOCAL_RANK} unless `device` is the CPU, then gloo. Raises
    when --multihost is asked without torchrun's environment."""
    if dist.is_initialized():
        return True
    multihost = bool(config.get("multihost", False)) if config else False
    if not multihost and "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            "data parallelism runs under torchrun (python -m "
            "torch.distributed.run), which sets " + ", ".join(ENV)
            + "; missing: " + ", ".join(missing))
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    return True


def world_size(group=None) -> int:
    """The ranks of `group` (default: the whole world), 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in `group`, 0 without one."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def dp_device_count(config, available: int | None = None) -> int:
    """--dp_devices against the ranks there are (`available`, default the
    world size): n > 0 gives min(n, available); -1 the largest count up to
    `available` that divides the batch size (mesh.py:40-56)."""
    n = int(config.get("dp_devices", -1))
    avail = world_size() if available is None else available
    if n > 0:
        return min(n, avail)
    bs = int(config.get("batch_size", 1) or 1)
    d = min(avail, bs)
    while d > 1 and bs % d != 0:
        d -= 1
    return max(d, 1)


def _slice(batch, r: int, D: int, dim: int = 0):
    B = batch.xyz0.shape[dim]
    if B % D:
        raise ValueError(f"a batch of {B} pairs does not split over {D} "
                         "ranks")
    n = B // D
    return type(batch)(*(torch.as_tensor(x).narrow(dim, r * n, n)
                         for x in batch))


def shard_batch(batch, r: int | None = None, D: int | None = None):
    """Rank r's slice of B / D pairs of a RawBatch (default: this rank's of
    the world's), or of each micro-batch of a list; a stacked iter_size
    RawBatch (fields [iter_size, B, ...]) keeps its leading axis whole."""
    r = rank() if r is None else r
    D = world_size() if D is None else D
    if not hasattr(batch, "xyz0"):            # a list of micro-batches
        return [_slice(b, r, D) for b in batch]
    return _slice(batch, r, D, 1 if batch.xyz0.dim() == 4 else 0)


def average_gradients(params, group=None) -> None:
    """Every parameter's gradient averaged over the ranks in place: one
    flattened all_reduce, then / D (a missing gradient counts as 0)."""
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= world_size(group)
    at = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[at:at + n].view_as(p)
        at += n


def average_metrics(metrics: dict, group=None) -> dict:
    """The 0-d metrics averaged over the ranks (one all_reduce)."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= world_size(group)
    return {k: flat[i] for i, k in enumerate(keys)}


def dp_train_step(kind: str, model, opt, batch, cfg, *, group=None,
                  labeler=None, **kw) -> dict:
    """One data-parallel train step (mesh.py:make_dp_train_step) on this
    rank's slice of the global `batch`: `kind` "base"
    (training.steps.base_train_step) or "extension" (extension_train_step,
    with `labeler`); `kw` goes to the step (draws of the rank's slice,
    generator, device, label_mode, similarity, timings). The parameters,
    the optimizer's state and the BN statistics stay the same on every
    rank."""
    from eyoc_tpu_torch.training import steps
    group = group if group is not None else dist.group.WORLD
    local = shard_batch(batch, rank(group), world_size(group))
    if kind == "base":
        return steps.base_train_step(model, opt, local, cfg, group=group,
                                     **kw)
    if kind == "extension":
        return steps.extension_train_step(model, labeler, opt, local, cfg,
                                          group=group, **kw)
    raise ValueError(f"unknown step kind {kind!r}")


# ---------------------------------------------------------------- eval


def gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[D, ...]: every rank's `t` (of one shape), in rank order."""
    D = world_size(group)
    flag = t.dtype == torch.bool
    src = t.to(torch.uint8) if flag else t.contiguous()
    out = [torch.empty_like(src) for _ in range(D)]
    dist.all_gather(out, src, group=group)
    out = torch.stack(out)
    return out.bool() if flag else out


def _mine(t, r):
    """Rank r's entry of a per-pair argument (a tuple of [D, ...] tensors,
    or None)."""
    return None if t is None else tuple(x[r] for x in t)


def dp_embed_pair(model, batch, cfg, group=None, device=None):
    """eval.embed_pair on one pair a rank of a batch of D pairs; returns
    the six outputs gathered, each [D, ...] (mesh.py:make_dp_embed_step)."""
    from eyoc_tpu_torch.eval import embed_pair
    r, D = rank(group), world_size(group)
    out = embed_pair(model, _slice(batch, r, D), cfg, device)
    return tuple(gather(t, group) for t in out)


def dp_register_pair(embedded, cfg, group=None, noise=None, keep=None,
                     generator=None):
    """eval.register_pair of each rank's own embedded pair (the six local
    outputs of embed_pair); T_est [D, 4, 4] gathered
    (mesh.py:make_dp_register_step). `noise` / `keep`: per-pair pairs of
    [D, cap] tensors, each rank taking its row."""
    from eyoc_tpu_torch.eval import register_pair
    r = rank(group)
    T = register_pair(*embedded, cfg, noise=_mine(noise, r),
                      keep=_mine(keep, r), generator=generator)
    return gather(T, group)


def dp_test_pair(model, batch, cfg, group=None, noise=None, keep=None,
                 generator=None, device=None) -> dict:
    """eval.test_pair on one pair a rank of a batch of D pairs:
    {"T_est" [D, 4, 4], "rte" [D], "rre" [D]} gathered
    (mesh.py:make_dp_test_step)."""
    from eyoc_tpu_torch.eval import test_pair
    r, D = rank(group), world_size(group)
    out = test_pair(model, _slice(batch, r, D), cfg, noise=_mine(noise, r),
                    keep=_mine(keep, r), generator=generator, device=device)
    return {k: gather(v, group) for k, v in out.items()}


def dp_valid_pair(model, batch, cfg, group=None, noise=None, generator=None,
                  device=None) -> dict:
    """eval.valid_pair on one pair a rank of a batch of D pairs: {"loss",
    "rte", "rre", "hit_ratio"}, each [D], gathered
    (mesh.py:make_dp_valid_step). Without `noise`, each rank draws the
    subsets' uniforms of all D pairs from `generator` in pair order and
    keeps its own: the serial loop's draws, pair by pair."""
    from eyoc_tpu_torch.eval import uniforms, valid_pair
    r, D = rank(group), world_size(group)
    local = _slice(batch, r, D)
    if noise is None:
        shape = torch.empty(cfg.caps[0], dtype=torch.bool)
        draws = [(uniforms(shape, generator), uniforms(shape, generator))
                 for _ in range(D)]
        noise = draws[r]
    else:
        noise = _mine(noise, r)
    out = valid_pair(model, local, cfg, noise=noise, device=device)
    return {k: gather(torch.as_tensor(v), group) for k, v in out.items()}
