"""Import the reference's torch/MinkowskiEngine checkpoints into the port
(counterpart of eyoc_tpu/tools/import_torch_ckpt.py, the same flags).

The reference publishes pretrained weights (reference README.md:9) saved by
`_save_checkpoint` as `{epoch, state_dict, optimizer, scheduler, config,
best_val*}` (reference lib/trainer.py:166-179). The port's `ResUNet`
mirrors the torch module names (models/unet.py), so the mapping is
mechanical:

    conv{l}.kernel         [K^3, Ci, Co]  -> conv{l}.weight       (identity)
    conv{l}_tr.kernel      [K^3, Ci, Co]  -> conv{l}_tr.weight
    conv1_tr.kernel        [Ci, Co] (k=1) -> conv1_tr.weight      ([1, Ci, Co])
    final.kernel / final.bias [1, Co]     -> final.weight / final.bias [Co]
    norm*.bn.{weight,bias,running_mean,running_var} -> norm*.{...}
    block*.{conv1,conv2}.kernel           -> block*.{conv1,conv2}.weight
    block*.{norm1,norm2}.bn.*             -> block*.{norm1,norm2}.*

MinkowskiEngine's kernel tap order (the last coordinate axis fastest) is
the port's, so kernels copy through with no permutation; an instance norm
carries its affine only. ResUNetExpBN2C's repeats map the same way:
norm{l}_{r}.bn.* -> norm{l}_{r}.*, block{l}_{r}.* -> block{l}_{r}.* (the
JAX importer's template, eyoc_tpu/tools/import_torch_ckpt.py:183-222).

Loading uses `torch.load(..., weights_only=True)`; a checkpoint that it
refuses (the reference pickles its config as an easydict) is read by a
minimal zip + pickle reader that keeps the tensors and degrades other
classes to plain dicts. Saving writes the port's `<name>.pt` (the student's
state dict under "model", what `training.checkpoint.load_weights_only`
reads) and the `<name>.json` sidecar.

    python -m eyoc_tpu_torch.tools.import_torch_ckpt \\
        --input /path/to/best_val_checkpoint.pth --output_dir runs/imported \\
        --name best_val_checkpoint --write_test_config

makes `runs/imported` a `--save_dir` for `python -m
eyoc_tpu_torch.cli.test` (the runbook in README.md). The tool runs on the
host: it builds no kernel and touches no card.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import zipfile
from typing import Any, Dict

import numpy as np
import torch

from eyoc_tpu_torch.config import Config, build_parser
from eyoc_tpu_torch.models import ResUNet, load_model
from eyoc_tpu_torch.models.unet import BatchNorm, InstanceNorm, SparseConv

# ----------------------------------------------------------- torch .pth I/O


class _TensorStub:
    def __init__(self, storage, storage_offset, size, stride):
        self.storage = storage
        self.storage_offset = storage_offset
        self.size = size
        self.stride = stride

    def numpy(self):
        arr = self.storage[self.storage_offset:]
        return np.lib.stride_tricks.as_strided(
            arr, shape=self.size,
            strides=[s * arr.itemsize for s in self.stride]).copy()


_DTYPES = {
    "FloatStorage": np.float32, "DoubleStorage": np.float64,
    "HalfStorage": np.float16, "LongStorage": np.int64,
    "IntStorage": np.int32, "ShortStorage": np.int16,
    "CharStorage": np.int8, "ByteStorage": np.uint8, "BoolStorage": np.bool_,
}


def _torch_load_zip(path: str) -> Dict[str, Any]:
    """Minimal reader for torch's zip format: data.pkl + one blob a
    storage. Tensors come back as numpy arrays; unknown classes (the
    reference's easydict config, ...) as plain dicts."""
    zf = zipfile.ZipFile(path)
    prefix = zf.namelist()[0].split("/")[0]
    storages: Dict[str, np.ndarray] = {}

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch._utils" and name in (
                    "_rebuild_tensor_v2", "_rebuild_tensor"):
                def rebuild(storage, storage_offset, size, stride, *a):
                    return _TensorStub(storage, storage_offset, size,
                                       stride).numpy()
                return rebuild
            if module == "collections" and name == "OrderedDict":
                return dict
            if module == "torch" and name.endswith("Storage"):
                return _DTYPES[name]

            class _Any(dict):
                def __init__(self, *a, **k):
                    super().__init__()
            return _Any

        def persistent_load(self, pid):
            # ('storage', dtype, key, location, numel)
            _, dtype, key, _, numel = pid
            if key not in storages:
                raw = zf.read(f"{prefix}/data/{key}")
                storages[key] = np.frombuffer(raw, dtype=dtype, count=numel)
            return storages[key]

    with zf.open(f"{prefix}/data.pkl") as f:
        return Unpickler(f).load()


def _torch_load(path: str) -> Dict[str, Any]:
    """A torch checkpoint on the host: `torch.load` with weights_only, or,
    where that refuses a class in the file, the zip + pickle reader."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return _torch_load_zip(path)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ------------------------------------------------------------- the mapping


class ImportError_(ValueError):
    pass


def _get(sd: Dict[str, Any], key: str) -> np.ndarray:
    if key not in sd:
        raise ImportError_(f"torch state_dict is missing key {key!r}")
    return np.asarray(_to_numpy(sd[key]), np.float32)


def _conv_kernel(sd, key: str, shape) -> np.ndarray:
    w = _get(sd, key)
    if w.ndim == 2:  # ME stores kernel_size=1 convs as [Ci, Co]
        w = w[None]
    if w.shape != tuple(shape):
        raise ImportError_(
            f"{key}: torch kernel shape {w.shape} != expected {tuple(shape)}")
    return w


def _norm_entries(sd, name: str, norm) -> Dict[str, np.ndarray]:
    """One norm module's entries: the affine, and a BatchNorm's running
    statistics."""
    base = f"{name}.bn" if f"{name}.bn.weight" in sd else name
    out = {"weight": _get(sd, f"{base}.weight").reshape(-1),
           "bias": _get(sd, f"{base}.bias").reshape(-1)}
    if out["weight"].shape != tuple(norm.weight.shape):
        raise ImportError_(
            f"{name}: channel mismatch {out['weight'].shape} vs "
            f"{tuple(norm.weight.shape)}")
    if isinstance(norm, BatchNorm):
        out["running_mean"] = _get(sd, f"{base}.running_mean")
        out["running_var"] = _get(sd, f"{base}.running_var")
    return out


def torch_state_dict_to_params(sd: Dict[str, Any],
                               model: ResUNet) -> Dict[str, torch.Tensor]:
    """Map a reference model state_dict onto a state dict that `model`
    (a ResUNet of the checkpoint's spec) loads with strict=True."""
    out: Dict[str, np.ndarray] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, SparseConv):
            out[f"{name}.weight"] = _conv_kernel(sd, f"{name}.kernel",
                                                 mod.weight.shape)
        elif isinstance(mod, (BatchNorm, InstanceNorm)):
            for k, v in _norm_entries(sd, name, mod).items():
                out[f"{name}.{k}"] = v
    final = model.final
    b = _get(sd, "final.bias").reshape(-1)
    if b.shape != tuple(final.bias.shape):
        raise ImportError_(
            f"final.bias: {b.shape} != expected {tuple(final.bias.shape)}")
    out["final.weight"] = _conv_kernel(sd, "final.kernel",
                                       (1,) + tuple(final.weight.shape))[0]
    out["final.bias"] = b
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def params_to_torch_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """Inverse mapping: the port's state dict (a ResUNet's) -> numpy arrays
    keyed by the reference's module names, in the JAX exporter's layout (ME
    kernels, [1, Co] final bias, k = 1 kernels 2-D, num_batches_tracked 0
    beside each BatchNorm's statistics)."""
    sd: Dict[str, np.ndarray] = {}
    keys = list(state_dict)
    norms = {k.rsplit(".", 1)[0] for k in keys if k.endswith(".bias")
             and not k.startswith("final.")}
    for key in keys:
        mod, leaf = key.rsplit(".", 1)
        v = _to_numpy(state_dict[key])
        if mod == "final":
            if leaf == "weight":
                sd["final.kernel"] = v
            else:
                sd["final.bias"] = v.reshape(1, -1)
        elif mod in norms:
            sd[f"{mod}.bn.{leaf}"] = v
            if leaf == "running_var":
                sd[f"{mod}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
        else:
            sd[f"{mod}.kernel"] = v[0] if v.shape[0] == 1 else v
    return sd


# ------------------------------------------------------------- entry points


def _embedded_config(obj) -> dict:
    cfg = obj.get("config", {}) if isinstance(obj, dict) else {}
    if not isinstance(cfg, dict):  # easydict pickles as a dict subclass
        cfg = dict(cfg.__dict__) if hasattr(cfg, "__dict__") else {}
    return cfg


def import_checkpoint(input_path: str, model: str | None = None,
                      model_n_out: int | None = None,
                      conv1_kernel_size: int | None = None):
    """Returns (state dict of the port's ResUNet, info dict). Model
    hyperparameters default to the checkpoint's embedded config (the
    reference saves the full config, lib/trainer.py:170-176)."""
    obj = _torch_load(input_path)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    cfg = _embedded_config(obj)
    model = model or cfg.get("model", "ResUNetBN2C")
    model_n_out = model_n_out or int(cfg.get("model_n_out", 32))
    conv1_kernel_size = conv1_kernel_size or int(
        cfg.get("conv1_kernel_size", 5))
    template = ResUNet(load_model(model), 1, model_n_out, conv1_kernel_size,
                       dtype=torch.float32)
    state = torch_state_dict_to_params(sd, template)
    info = {
        "model": model,
        "model_n_out": model_n_out,
        "conv1_kernel_size": conv1_kernel_size,
        "epoch": int(obj.get("epoch", -1)) if isinstance(obj, dict) else -1,
        "source": os.path.abspath(input_path),
    }
    return state, info


def save_imported(out_dir: str, name: str, state: Dict[str, torch.Tensor],
                  info) -> str:
    """Write `<name>.pt` ({"model": state}, what
    `training.checkpoint.load_weights_only` reads) and `<name>.json`;
    returns the .pt path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.pt")
    torch.save({"model": state}, path)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"epoch": info.get("epoch", -1), "imported_from":
                   info.get("source", ""), "config": {
                       "model": info["model"],
                       "model_n_out": info["model_n_out"],
                       "conv1_kernel_size": info["conv1_kernel_size"]}},
                  f, indent=2)
    return path


def write_test_config(out_dir: str, input_path: str, info) -> str:
    """Write a `cli.test`-loadable config.json next to the imported weights:
    the parser's defaults, overlaid with every key of the checkpoint's
    embedded config that the parser also knows, then the resolved model
    hyperparameters."""
    cfg = Config(vars(build_parser().parse_args([])))
    for k, v in _embedded_config(_torch_load(input_path)).items():
        if k in cfg and isinstance(v, (bool, int, float, str, type(None))):
            cfg[k] = v
    cfg.update({k: info[k]
                for k in ("model", "model_n_out", "conv1_kernel_size")})
    cfg.out_dir = out_dir
    path = os.path.join(out_dir, "config.json")
    cfg.save(path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True, help="torch .pth checkpoint")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--name", default="checkpoint",
                   help="output basename (use best_val_checkpoint to feed "
                        "cli.test directly)")
    p.add_argument("--model", default=None,
                   help="override the checkpoint's embedded config")
    p.add_argument("--model_n_out", default=None, type=int)
    p.add_argument("--conv1_kernel_size", default=None, type=int)
    p.add_argument("--write_test_config", action="store_true",
                   help="also write config.json so --output_dir is a "
                        "drop-in --save_dir for cli.test")
    args = p.parse_args(argv)
    state, info = import_checkpoint(
        args.input, args.model, args.model_n_out, args.conv1_kernel_size)
    path = save_imported(args.output_dir, args.name, state, info)
    if args.write_test_config:
        cfg_path = write_test_config(args.output_dir, args.input, info)
        print(f"wrote {cfg_path}")
    n = sum(int(v.numel()) for k, v in state.items()
            if not k.endswith(("running_mean", "running_var")))
    print(f"imported {info['model']} ({n:,} params, epoch {info['epoch']}) "
          f"-> {path}")


if __name__ == "__main__":
    main()
